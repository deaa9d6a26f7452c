"""nn.Modules of the ported slice under the reference's torch state-dict
names: speaker encoder, Tacotron, the three WaveRNN variants, and the
WaveRNN heads' output distributions."""
