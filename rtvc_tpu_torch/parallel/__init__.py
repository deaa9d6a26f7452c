"""Multi-GPU: data-parallel training over ``torch.distributed``
(``distributed``) and fold-sharded WaveRNN generation (``generation``)."""
