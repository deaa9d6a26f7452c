"""WaveRNN vocoder hyper-parameters — three variants.

Same numerics as the reference (ref: config/hparams.py:220-421):
``fatchord`` (2-GRU, RAW+mu-law), ``geneing`` (1-GRU, BITS), and
``runtimeracer`` (4-narrow-GRU, RAW+mu-law, CPU-speed-optimized shape).

This package's own copy of ``rtvc_tpu/config/vocoder.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from rtvc_tpu_torch.config.base import Config
from rtvc_tpu_torch.config.signal import sp

# (loops, init_lr, final_lr, batch_size) — ref: config/hparams.py:249-262
VocSchedule = Tuple[Tuple[float, float, float, int], ...]

MODE_RAW = "RAW"
MODE_BITS = "BITS"
MODE_MOL = "MOL"


@dataclasses.dataclass(frozen=True)
class WaveRNNParams(Config):
    # Model
    mode: str = MODE_RAW
    bits: int = 10
    mu_law: bool = True
    upsample_factors: Tuple[int, ...] = (5, 5, 8)

    rnn_dims: int = 512
    fc_dims: int = 512
    compute_dims: int = 128
    res_out_dims: int = 32 * 4   # aux output feeds downstream nets
    res_blocks: int = 10

    # Training
    pad: int = 2                  # resnet sees wider than input length
    seq_len: int = sp.hop_size * 5  # must be a multiple of hop_size

    # MOL params
    num_classes: int = 65536
    log_scale_min: float = float(math.log(1e-14))

    voc_tts_schedule: VocSchedule = (
        (1, 1e-3, 5e-4, 40),
        (2, 5e-4, 1e-4, 50),
        (4, 1e-4, 1e-4, 60),
        (8, 1e-4, 1e-4, 70),
        (16, 1e-4, 1e-4, 80),
        (32, 1e-4, 1e-4, 90),
        (64, 1e-4, 1e-4, 100),
        (128, 1e-4, 5e-5, 110),
        (256, 5e-5, 5e-5, 120),
        (256, 5e-5, 5e-5, 120),
        (256, 5e-5, 5e-5, 120),
        (256, 5e-5, 5e-5, 120),
    )

    # Sparsification (structured group-of-4 pruning)
    use_sparsification: bool = False
    start_prune: int = 100000
    prune_steps: int = 100000
    sparsity_target: float = 0.90
    sparsity_target_rnn: float = 0.90
    sparse_group: int = 4

    # Loss-anomaly detection
    anomaly_detection: bool = False
    anomaly_trigger_multiplier: float = 6.0

    # Generation
    gen_at_checkpoint: int = 5
    gen_batched: bool = True
    gen_target: int = 3000
    gen_overlap: int = 1500

    @property
    def total_upsample(self) -> int:
        out = 1
        for f in self.upsample_factors:
            out *= f
        return out


wavernn_fatchord = WaveRNNParams()

wavernn_geneing = WaveRNNParams(
    mode=MODE_BITS,
    mu_law=False,
    upsample_factors=(4, 5, 10),
    rnn_dims=256,
    fc_dims=128,
    compute_dims=64,
    res_out_dims=32 * 2,
    res_blocks=3,
    seq_len=sp.hop_size * 7,
    num_classes=256,
    voc_tts_schedule=(
        (0.25, 1e-3, 5e-4, 40),
        (0.50, 5e-4, 1e-4, 60),
        (1, 1e-4, 5e-5, 80),
        (2, 5e-5, 5e-5, 100),
        (4, 5e-5, 5e-5, 110),
        (8, 5e-5, 5e-5, 120),
        (16, 5e-5, 5e-5, 130),
        (32, 5e-5, 5e-5, 140),
        (64, 5e-5, 5e-5, 150),
        (64, 5e-5, 5e-5, 150),
        (64, 5e-5, 5e-5, 150),
        (64, 5e-5, 5e-5, 150),
    ),
)

wavernn_runtimeracer = WaveRNNParams(
    rnn_dims=256,
    fc_dims=256,
    compute_dims=128,
    res_out_dims=64 * 2,
    gen_target=6000,
    gen_overlap=1000,
)
