"""Where K4's time goes at the WaveRNN training shapes and the Tacotron
CBHG's, by taking parts of the kernels away.

    python -m rtvc_tpu_torch.profile_gru [--narrow]

Builds ``csrc/gru_seq.cu`` (with ``common.cuh`` written into it) as it is and
in variants, as ``profile_lstm`` does for K3.

The cooperative mode (``ops/gru_seq.py:cooperative_plan``) in
``no_loads`` (the rows a warp multiplies are constants, not read from L2),
``no_weights`` (the weights are constants, not read from shared memory),
``no_loads_no_weights`` (both), and ``no_wait`` (every CTA arrives at the
grid barrier but none waits): forward and backward of each timed with CUDA
events, with the cooperative plan, at B 40 x T 1000 x H 256 and 512, B 40 x
T 1400 x H 256, ForwardTacotron's B 1 x T 64 x H 256 and T 384 x H 256 and
B 8 x T 64 x H 256; then every candidate plan of each shape
(``ops/gru_seq.py:candidates``) through the kernel as it is, in
:func:`rounds_ms`, beside the modelled cost that ``cooperative_plan`` ranks
them by.

The row-resident mode (``ops/gru_seq.py:row_plan``, H <= 128) at every
narrow shape on the port's paths (``NARROW_SHAPES``: the Tacotron CBHGs' H
64, ForwardTacotron's predictors at H 64 and 128, a DP rank's CBHG, the GTA
pass's): forward and backward under the package's plan (``row_plan``, W_hh
in registers), the same plan in the variant ``smem_weights`` (W_hh in
shared memory, read every step, and the plan's shared memory grown by it:
:func:`smem_weights_plan`) and the cooperative plan on the same inputs, in
:func:`rounds_ms`, beside cuDNN's ``nn.GRU(H, H)`` (input projection
included); the forward under the plan in the variants ``no_ring`` (each step reads its xg from device memory on the
chain instead of the ring staged ``kRing - 1`` steps ahead) and
``no_product`` (the product h_{t-1} · W_hhᵀ and its lanes' sums left out:
the update, the stores, the ring and the barrier alone); and both kernels
under the plan in ``clock``, which counts a step's cycles by part
(:func:`clocked`). ``--narrow`` runs this part alone.

The variants' outputs are wrong by construction; only their times are read.
Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rtvc_tpu_torch import _build, profile_lstm
from rtvc_tpu_torch.ops.gru_seq import (
    RowPlan,
    candidates,
    cooperative_plan,
    cost,
    describe,
    launch_bwd,
    launch_fwd,
    row_plan,
)

# the WaveRNN training shapes, then ForwardTacotron's B 1 shapes at H 256 and
# a few rows: the cooperative mode's
SHAPES = ((40, 1000, 256), (40, 1000, 512), (40, 1400, 256), (1, 64, 256), (1, 384, 256),
          (8, 64, 256))
# the row-resident mode's (H <= 128) shapes on the port's paths: the clone's
# encoder and postnet CBHG (B 1 x T 64, 512), a DP rank's and the Tacotron
# step's postnet CBHG (B 56 and 112 x T 602) and encoder CBHG (B 112 x T 160),
# the ForwardTacotron step's and the GTA pass's predictors (B 16 and 8 x T 160
# x H 64 and 128), ForwardTacotron's clone at H 128 (B 1 x T 64)
NARROW_SHAPES = ((1, 64, 64), (1, 512, 64), (56, 602, 64), (112, 602, 64), (112, 160, 64),
                 (16, 160, 64), (16, 160, 128), (8, 160, 64), (8, 160, 128), (1, 64, 128))
# the forward's ring read and its staging, and its product, as the variants
# replace them
RING_READ = "const S* x = ring + (t % kRing) * slot_n;"
DIRECT_READ = "const S* x = x_row + (size_t)t * G;"
RING_STAGE = "    stage_row(ring + (s % kRing) * slot_n, x_row"
NO_STAGE = "    if (s < 0) stage_row(ring + (s % kRing) * slot_n, x_row"
PRODUCT = "      if (t > 0) {\n        const float* hp = hbuf"
NO_PRODUCT = "      if (t < 0) {\n        const float* hp = hbuf"
# where the clock variant reads clock64() in each row-resident kernel: (the
# state's declaration, the step's first read of the ring, the end of the
# lanes' sums, the end of the kernel's loop), and the output it writes its
# cycle counts into (f32)
CLOCK_MARKS = {
    "forward": ("  float h_own = 0.0f;",
                "      const S* x = ring + (t % kRing) * slot_n;",
                "      group_sum<L, 3>(hg);\n",
                "    step_barrier<C>();\n  }\n}\n\n// The backward", "gates"),
    "backward": ("  float carry = 0.0f;",
                 "      const S* sl = ring + (t % kRing) * slot_n;",
                 "      group_sum<L, 1>(sum);\n",
                 "    step_barrier<C>();\n  }\n}\n\n// The plan a row-resident", "dxg")}
CLOCK_SEGMENTS = ("product", "update", "barrier", "step")
# the lanes' weights as the smem_weights variant replaces them: (the part of
# the source, its replacement). A compute thread's 12 · chunks weights go to
# shared memory laid out [gate][chunk][thread] in float4s (f32 whatever the
# streams' dtype), ahead of the ring; a warp's reads of one (gate, chunk) are
# 512 contiguous bytes.
SMEM_WEIGHTS = (
    ("  float4 w[3][KI];\n",
     "  float* sm;\n  int stride;\n"),
    ("  __device__ __forceinline__ void load(const S* w_hh, int H, int col, int q, "
     "bool transposed) {\n",
     "  __device__ __forceinline__ void load(const S* w_hh, int H, int col, int q, "
     "bool transposed) {\n"
     "    extern __shared__ float4 smem4[];\n"
     "    stride = 4 * ((int)blockDim.x - 32);\n"
     "    sm = reinterpret_cast<float*>(smem4) + 4 * threadIdx.x;\n"),
    ("        w[g][i] = make_float4(v[0], v[1], v[2], v[3]);",
     "        *reinterpret_cast<float4*>(sm + (g * KI + i) * stride) = "
     "make_float4(v[0], v[1], v[2], v[3]);"),
    ("  __device__ __forceinline__ float4 at(int g, int i) const { return w[g][i]; }",
     "  __device__ __forceinline__ float4 at(int g, int i) const {\n"
     "    return *reinterpret_cast<const float4*>(sm + (g * KI + i) * stride);\n  }"),
    ("  S* ring = reinterpret_cast<S*>(smem4);",
     "  S* ring = reinterpret_cast<S*>(reinterpret_cast<float*>(smem4) + (size_t)12 * KI * nt);"),
    ("  S* ring = reinterpret_cast<S*>(smem4);",
     "  S* ring = reinterpret_cast<S*>(reinterpret_cast<float*>(smem4) + (size_t)12 * KI * nt);"),
    ("         p.smem == row_smem(H, p.lanes, p.chunks, backward, elem);",
     "         p.smem == row_smem(H, p.lanes, p.chunks, backward, elem) + "
     "48 * p.chunks * (p.threads - 32);"))
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


def row_variants(source: str) -> dict:
    """The source as it is; its row-resident forward without the xg ring or
    without the product; both row-resident kernels with W_hh in shared
    memory (``SMEM_WEIGHTS``); and both counting the cycles of a step's
    parts (``clocked``)."""
    no_ring = profile_lstm.replaced(profile_lstm.replaced(source, RING_READ, DIRECT_READ),
                                    RING_STAGE, NO_STAGE)
    smem_weights = source
    for old, new in SMEM_WEIGHTS:
        smem_weights = profile_lstm.replaced(smem_weights, old, new)
    return {"base": source, "no_ring": no_ring,
            "no_product": profile_lstm.replaced(source, PRODUCT, NO_PRODUCT),
            "smem_weights": smem_weights, "clock": clocked(source)}


def smem_weights_plan(p: RowPlan) -> RowPlan:
    """The row-resident plan ``p`` as the smem_weights variant takes it: its
    shared memory grown by the compute threads' f32 weights."""
    return p._replace(smem=p.smem + 48 * p.chunks * (p.threads - 32))


def clocked(source: str) -> str:
    """The source with each row-resident kernel's compute thread 0 of CTA 0
    reading ``clock64()`` at the start of a step's product (after the
    producer's barrier), after the lanes' sums, before the step's barrier
    and after it, and writing the sums over the steps as floats into the
    first four values of an output: cycles of the product (with the ring's
    reads), of the update (with its stores), of the barrier's wait, and of
    the whole loop."""
    for decl, start, summed, end, out in CLOCK_MARKS.values():
        source = profile_lstm.replaced(
            source, decl, "  long long cyc[3] = {0, 0, 0}, c_a = 0, c_b = 0;\n"
            "  const long long c_loop = clock64();\n" + decl)
        source = profile_lstm.replaced(source, start, "      c_a = clock64();\n" + start)
        source = profile_lstm.replaced(source, summed, summed + "      c_b = clock64();\n")
        source = profile_lstm.replaced(source, end, (
            "    const long long c_c = clock64();\n"
            "    step_barrier<C>();\n"
            "    const long long c_d = clock64();\n"
            "    cyc[0] += c_b - c_a;\n    cyc[1] += c_c - c_b;\n    cyc[2] += c_d - c_c;\n"
            "  }\n"
            "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
            f"    float* o = reinterpret_cast<float*>({out});\n"
            "    for (int i = 0; i < 3; ++i) o[i] = (float)cyc[i];\n"
            "    o[3] = (float)(clock64() - c_loop);\n"
            "  }\n}\n\n" + end.split("\n\n", 1)[1]))
    return source


class Case:
    """Seeded inputs of one (B, T, H) shape on the card, and launches of K4's
    C entry points on them under an explicit plan of either mode."""

    def __init__(self, B: int, T: int, H: int, dev):
        g = torch.Generator().manual_seed(0)
        self.T = T
        self.xg = torch.randn(B, T, 3 * H, generator=g).to(dev)
        self.w = ((torch.rand(3 * H, H, generator=g) - 0.5) * 2 * H ** -0.5).to(dev)
        self.b = torch.zeros(3 * H, device=dev)
        self.dys = torch.randn(B, T, H, generator=g).to(dev)
        self.ys = torch.rand(B, T, H, generator=g).to(dev)
        self.gates = torch.rand(B, T, 4 * H, generator=g).to(dev)
        self.out_ys, self.out_gates = torch.empty_like(self.ys), torch.empty_like(self.gates)
        self.dxg = torch.empty(B, T, 3 * H, device=dev)
        self.dhg = torch.empty(B, T, 3 * H, device=dev)

    def fwd(self, lib, p) -> None:
        launch_fwd(p, self.xg, self.w, self.b, self.out_ys, self.out_gates, lib=lib)

    def bwd(self, lib, p) -> None:
        launch_bwd(p, self.dys, self.gates, self.ys, self.w, self.dxg, self.dhg, lib=lib)


def cudnn_ms(B: int, T: int, H: int, dev) -> tuple:
    """cuDNN's ``nn.GRU(H, H)`` forward and backward ms on (B, T, H) inputs
    (f32; ``rtvc_tpu_torch`` switches TF32 off), input projection included;
    the backward is forward plus backward less the forward."""
    g = torch.Generator().manual_seed(1)
    rnn = torch.nn.GRU(H, H, batch_first=True).to(dev)
    x = torch.randn(B, T, H, generator=g).to(dev).requires_grad_()
    dys = torch.randn(B, T, H, generator=g).to(dev)
    fwd = profile_lstm.cuda_ms(lambda: rnn(x), reps=REPS)
    return fwd, profile_lstm.cuda_ms(lambda: rnn(x)[0].backward(dys), reps=REPS) - fwd


def profile_narrow(libs: dict, B: int, T: int, H: int, dev) -> None:
    """The row-resident mode at one shape (see the module's docstring)."""
    c = Case(B, T, H, dev)
    limits = _build.device_limits(dev)
    lib_fwd, lib_bwd = cudnn_ms(B, T, H, dev)
    for backward, run in ((False, c.fwd), (True, c.bwd)):
        p = row_plan(B, H, limits[1], backward)
        coop = cooperative_plan(B, H, *limits, backward=backward)
        timed = rounds_ms({
            "plan": lambda: run(libs["base"], p),
            "smem_weights": lambda: run(libs["smem_weights"], smem_weights_plan(p)),
            "cooperative": lambda: run(libs["base"], coop)})
        print(f"B={B} T={T} H={H} {'backward' if backward else 'forward'}: plan "
              f"({describe(p)}) {timed['plan']:.4f} ms, {timed['plan'] / T * 1e3:.3f} us a "
              f"step; the plan with W_hh in shared memory {timed['smem_weights']:.4f} ms; "
              f"cooperative {tuple(coop[:4])} {timed['cooperative']:.4f} ms; "
              f"nn.GRU({H}, {H}) {lib_bwd if backward else lib_fwd:.4f} ms")
    p = row_plan(B, H, limits[1])
    parts = rounds_ms({name: (lambda name=name: c.fwd(libs[name], p))
                       for name in ("base", "no_ring", "no_product")})
    print(f"  forward variants under the plan, ms (us a step): " + ", ".join(
        f"{name} {ms:.4f} ({ms / T * 1e3:.3f})" for name, ms in parts.items()))
    for backward, run, out in ((False, c.fwd, c.out_gates), (True, c.bwd, c.dxg)):
        p = row_plan(B, H, limits[1], backward)
        ms = profile_lstm.cuda_ms(lambda: run(libs["clock"], p), reps=1)
        cyc = [float(v) for v in out.reshape(-1)[:4].cpu()]
        print(f"  {'backward' if backward else 'forward'} cycles a step of CTA 0's compute "
              f"thread 0: " + ", ".join(f"{n} {v / T:.0f}" for n, v in zip(CLOCK_SEGMENTS, cyc))
              + f"; SM clock ≈ {cyc[3] / (ms * 1e6):.2f} GHz (the loop's cycles over the "
              f"launch's {ms:.4f} ms)")


def profile_shape(libs: dict, B: int, T: int, H: int, dev) -> None:
    c = Case(B, T, H, dev)
    limits = _build.device_limits(dev)
    p_fwd = cooperative_plan(B, H, *limits)
    p_bwd = cooperative_plan(B, H, *limits, backward=True)
    print(f"B={B} T={T} H={H}: forward {p_fwd}, backward {p_bwd}")
    for name, lib in libs.items():
        fwd_ms = profile_lstm.cuda_ms(lambda: c.fwd(lib, p_fwd))
        bwd_ms = profile_lstm.cuda_ms(lambda: c.bwd(lib, p_bwd))
        print(f"  {name}: forward {fwd_ms:.3f} ms, {fwd_ms / T * 1e3:.2f} us a step; backward "
              f"{bwd_ms:.3f} ms, {bwd_ms / T * 1e3:.2f} us a step")
    for backward, run, chosen in ((False, c.fwd, p_fwd), (True, c.bwd, p_bwd)):
        timed = sorted((ms, p) for p, ms in rounds_ms(
            {p: (lambda p=p: run(libs["base"], p))
             for p in candidates(B, H, *limits, backward=backward)}).items())
        print(f"  {'backward' if backward else 'forward'} candidates, ms / modelled cycles a "
              f"step / (groups, slices, units, nb), fastest first: " + "; ".join(
                  f"{ms:.3f} / {cost(p, H, backward):.0f} / {tuple(p[:4])}"
                  + (" (plan)" if p == chosen else "") for ms, p in timed))


def main(argv=None) -> int:
    narrow = "--narrow" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("profile_gru: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    source = profile_lstm.flat_source("gru_seq.cu")
    made = row_variants(source) if narrow else {**variants(source), **row_variants(source)}
    functions = ("rtvc_gru_seq_fwd", "rtvc_gru_seq_bwd", "rtvc_gru_rows_fwd",
                 "rtvc_gru_rows_bwd")
    with tempfile.TemporaryDirectory() as tmp:
        libs = profile_lstm.build(Path(tmp), made, functions)
        rows = {k: libs[k] for k in row_variants(source)}
        for B, T, H in NARROW_SHAPES:
            profile_narrow(rows, B, T, H, dev)
        if not narrow:
            for B, T, H in SHAPES:
                profile_shape({k: libs[k] for k in variants(source)}, B, T, H, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
