"""nn.Modules of the ported slice under the reference's torch state-dict
names: speaker encoder, Tacotron, WaveRNN (runtimeracer)."""
