"""Where K4's time goes at the WaveRNN training shapes and the Tacotron
CBHG's, by taking parts of the kernels away.

    python -m rtvc_tpu_torch.profile_gru

Builds ``csrc/gru_seq.cu`` (with ``common.cuh`` written into it) as it is and
in variants, as ``profile_lstm`` does for K3: ``no_loads`` (the rows a warp
multiplies are constants, not read from L2), ``no_weights`` (the weights are
constants, not read from shared memory), ``no_loads_no_weights`` (both), and
``no_wait`` (every CTA arrives at the grid barrier but none waits). Times
forward and backward of each with CUDA events, with the package's plan, at
B 40 x T 1000 x H 256 and 512, B 40 x T 1400 x H 256, the four CBHG
BiGRU shapes at H 64 (B 1 x T 64 and 512, B 112 x T 160 and 602),
ForwardTacotron's B 1 shapes (H 128 and 256 at T 64, H 256 at T 384) and a
few rows (B 2, 3 and 8); then every candidate plan of each shape
(``ops/gru_seq.py:candidates``) through the kernel as it is, in
:func:`rounds_ms`, beside the modelled cost that ``plan`` ranks them by. The
variants' outputs are wrong by construction; only their times are read.
Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rtvc_tpu_torch import _build, profile_lstm
from rtvc_tpu_torch.ops.gru_seq import candidates, cost, plan

# the WaveRNN training shapes, then the Tacotron CBHG BiGRUs' (H 64): the
# clone's encoder and postnet (B 1 x T 64, 512), the training step's (B 112 x
# T 160, 602)
SHAPES = ((40, 1000, 256), (40, 1000, 512), (40, 1400, 256), (1, 64, 64), (1, 512, 64),
          (112, 160, 64), (112, 602, 64), (1, 64, 128), (1, 64, 256), (1, 384, 256),
          (2, 64, 64), (3, 64, 128), (8, 64, 256))
# A plan's time: the median of ROUNDS rounds of REPS launches, every plan of a
# shape once a round in an order that alternates from round to round (one plan
# at a time over two or three launches gave two times per plan at B 1, 2.2 and
# 6 us a step, by when it ran)
ROUNDS = 5
REPS = 10


def rounds_ms(runs: dict) -> dict:
    """{key: median ms} of ``runs`` ({key: fn launching once})."""
    keys = list(runs)
    times = {k: [] for k in keys}
    for r in range(ROUNDS):
        for k in keys if r % 2 == 0 else keys[::-1]:
            times[k].append(profile_lstm.cuda_ms(runs[k], reps=REPS))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def variants(source: str) -> dict:
    return {**profile_lstm.part_variants(source), "no_wait": profile_lstm.no_wait(source)}


def profile_shape(libs: dict, B: int, T: int, H: int, dev) -> None:
    g = torch.Generator().manual_seed(0)
    xg = torch.randn(B, T, 3 * H, generator=g).to(dev)
    w = ((torch.rand(3 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
    b = torch.zeros(3 * H, device=dev)
    dys = torch.randn(B, T, H, generator=g).to(dev)
    ys = torch.rand(B, T, H, generator=g).to(dev)
    gates = torch.rand(B, T, 4 * H, generator=g).to(dev)
    out_ys, out_gates = torch.empty_like(ys), torch.empty_like(gates)
    dxg, dhg = torch.empty(B, T, 3 * H, device=dev), torch.empty(B, T, 3 * H, device=dev)
    carry = torch.empty(B, H, device=dev)
    limits = _build.device_limits(dev)
    p_fwd, p_bwd = plan(B, H, *limits), plan(B, H, *limits, backward=True)
    stream = _build.stream_handle(dev)
    print(f"B={B} T={T} H={H}: forward {p_fwd}, backward {p_bwd}")

    def fwd(lib, p):
        sync = torch.zeros(32 * p.groups, device=dev, dtype=torch.int32)
        _build.check(lib.rtvc_gru_seq_fwd(
            xg.data_ptr(), w.data_ptr(), b.data_ptr(), out_ys.data_ptr(), out_gates.data_ptr(),
            B, T, H, _build.int_array(p), sync.data_ptr(), stream), "rtvc_gru_seq_fwd")

    def bwd(lib, p):
        sync = torch.zeros(32 * p.groups, device=dev, dtype=torch.int32)
        _build.check(lib.rtvc_gru_seq_bwd(
            dys.data_ptr(), gates.data_ptr(), ys.data_ptr(), w.data_ptr(), dxg.data_ptr(),
            dhg.data_ptr(), carry.data_ptr(), B, T, H, _build.int_array(p),
            sync.data_ptr(), stream), "rtvc_gru_seq_bwd")

    for name, lib in libs.items():
        fwd_ms = profile_lstm.cuda_ms(lambda: fwd(lib, p_fwd))
        bwd_ms = profile_lstm.cuda_ms(lambda: bwd(lib, p_bwd))
        print(f"  {name}: forward {fwd_ms:.3f} ms, {fwd_ms / T * 1e3:.2f} us a step; backward "
              f"{bwd_ms:.3f} ms, {bwd_ms / T * 1e3:.2f} us a step")
    for backward, run, chosen in ((False, fwd, p_fwd), (True, bwd, p_bwd)):
        timed = sorted((ms, p) for p, ms in rounds_ms(
            {p: (lambda p=p: run(libs["base"], p))
             for p in candidates(B, H, *limits, backward=backward)}).items())
        print(f"  {'backward' if backward else 'forward'} candidates, ms / modelled cycles a "
              f"step / (groups, slices, units, nb), fastest first: " + "; ".join(
                  f"{ms:.3f} / {cost(p, H, backward):.0f} / {tuple(p[:4])}"
                  + (" (plan)" if p == chosen else "") for ms, p in timed))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_gru: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = profile_lstm.build(Path(tmp), variants(profile_lstm.flat_source("gru_seq.cu")),
                                  ("rtvc_gru_seq_fwd", "rtvc_gru_seq_bwd"))
        for B, T, H in SHAPES:
            profile_shape(libs, B, T, H, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
