"""Training for the ported slice: the GE2E speaker encoder and the
WaveRNN vocoders (counterpart of ``rtvc_tpu/train``)."""
