"""Training for the ported slice: the GE2E speaker encoder and the
runtimeracer WaveRNN (counterpart of ``rtvc_tpu/train``)."""
