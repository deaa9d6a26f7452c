"""Where K2's time goes, by phase and by taking parts of the decoder loop away.

    python -m rtvc_tpu_torch.profile_tacotron

Builds ``csrc/tacotron_decode.cu`` (with ``common.cuh`` written into it) as it
is and in variants: ``no_loads`` (the inputs a warp multiplies are constants,
not read from L2), ``no_weights`` (the weights are constants, not read from
shared memory or L2), ``no_wait`` (every CTA arrives at the grid barrier but
none waits) and ``phases`` (each CTA's thread 0 adds up, for each of the ten
phases of an iteration, the cycles from the end of the last barrier to the
arrival at the next, the cycles spent in the barrier, and of the first the
cycles until the phase's products are done). Times each with
CUDA events at B 1 x T 64, B 2 x T 32 and B 24 x T 160, r 2, 200 iterations
with full-width seeded random weights (their stop token never fires), through
the package's plan; then every candidate plan of each shape (weights resident
or read from L2, 2, 4 or 8 batch rows an item) through the kernel as it is.
The variants' outputs are wrong by construction; only their times are read.
Needs an NVIDIA GPU and nvcc.

    python rtvc_tpu_torch/profile_tacotron.py --wrapper

times only ``ops.tacotron_decode.tacotron_decode`` at the three shapes, through
the public API of whichever ``rtvc_tpu_torch`` the path holds: with
``PYTHONPATH`` at another checkout it times that checkout's kernel, so that
two versions are compared in one call.
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rtvc_tpu_torch import _build, profile_lstm
from rtvc_tpu_torch.models import factories
from rtvc_tpu_torch.models import tacotron as taco
from rtvc_tpu_torch.ops import tacotron_decode as td

SHAPES = ((1, 64), (2, 32), (24, 160))
R, MAX_STEPS = 2, 400
ITERS = MAX_STEPS // R
PHASES = "ABCDEFGHIJ"

INPUT_LOAD = "__ldcg(reinterpret_cast<const float4*>(in + b * xs + k0 + s * kChunk))"
WEIGHT_LOAD = "const float4 wv = *reinterpret_cast<const float4*>(row[r] + k0 + s * kChunk);"
LOOP_START = "  int n_iters = d.max_iters;\n"
BARRIER = "rtvc::grid_barrier(sync, ctas * ++barriers);"
PRODUCTS_DONE = re.compile(r"\n    run_product<NB>\([^;]*;\n    __syncthreads\(\);\n")
COUNTERS = 3  # a phase's cycles before the barrier, in it, and in its products
TIMED_BARRIER = (
    "{ __syncthreads(); const long long t_a = clock64(); " + BARRIER +
    " const long long t_b = clock64(); if (threadIdx.x == 0) { unsigned long long* acc = "
    "reinterpret_cast<unsigned long long*>(ws + pl.ws[kWsLt] + al4(d.NF * d.D)) + "
    f"((size_t)blockIdx.x * 10 + (barriers - 1) % 10) * {COUNTERS}; acc[0] += t_a - t_last; "
    "acc[1] += t_b - t_a; acc[2] += t_mid - t_last; } t_last = t_mid = t_b; }")


def variants(source: str) -> dict:
    """The source as it is and the four variants (module docstring)."""
    no_loads = profile_lstm.replaced(source, INPUT_LOAD, "make_float4(1.f, k0, b, s)")
    if source.count(BARRIER) != len(PHASES):
        raise RuntimeError(f"profile: the kernel source no longer holds {len(PHASES)} "
                           f"barriers {BARRIER!r}")
    phases = profile_lstm.replaced(source, LOOP_START,
                                   "  long long t_last = clock64(), t_mid = t_last;\n" + LOOP_START)
    phases, n = PRODUCTS_DONE.subn(lambda m: m.group(0) + "    t_mid = clock64();\n", phases)
    if n != 8:
        raise RuntimeError(f"profile: the kernel source no longer ends 8 phases' products "
                           f"with {PRODUCTS_DONE.pattern!r}")
    return {"base": source, "no_loads": no_loads,
            "no_weights": profile_lstm.replaced(
                source, WEIGHT_LOAD, "const float4 wv = make_float4(k0, r, 1.f, s);"),
            "no_wait": profile_lstm.no_wait(source),
            "phases": phases.replace(BARRIER, TIMED_BARRIER)}


def inputs(model, d, B: int, T: int, dev):
    g = torch.Generator().manual_seed(1)
    chars = torch.randint(1, d.num_chars, (B, T), generator=g)
    chars[:, T - T // 8:] = 0
    spk = torch.randn(B, d.speaker_embedding_size, generator=g)
    spk = spk / spk.norm(dim=1, keepdim=True)
    with torch.no_grad():
        seq, proj = taco.encode(model, chars.to(dev), spk.to(dev), prenet_dropout=False)
    return seq.contiguous(), proj.contiguous(), (chars != 0).float().to(dev)


def profile_shape(libs: dict, model, d, B: int, T: int, dev) -> None:
    seq, proj, mask = inputs(model, d, B, T, dev)
    s = td.DecoderShape.of(model, d)
    limits = _build.device_limits(dev)
    chosen = td.plan(B, T, s, R, *limits)
    print(f"B={B} T={T} r={R}: resident {chosen.resident}, nb {chosen.nb}, {chosen.ctas} CTAs, "
          f"{chosen.smem} bytes of shared memory a CTA")

    def run(lib, p):
        return td.launch(lib, model, d, seq, proj, mask, 0, R, MAX_STEPS, False, p)

    with torch.no_grad():
        for name, lib in libs.items():
            if name == "phases":
                continue
            ms = profile_lstm.cuda_ms(lambda: run(lib, chosen))
            n = taco.stop_iterations(run(lib, chosen)[2], R)
            print(f"  {name}: {ms:.3f} ms for {n} iterations, {ms / n * 1e3:.2f} us an iteration")
        # the phases: each CTA's thread 0 adds its cycles up behind the workspace
        extra = chosen.ctas * len(PHASES) * COUNTERS * 2
        timed = chosen._replace(ws=chosen.ws[:-1] + (chosen.ws[-1] + extra,))
        work = torch.zeros(timed.ws[-1], device=dev)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        run(libs["phases"], timed)
        start.record()
        td.launch(libs["phases"], model, d, seq, proj, mask, 0, R, MAX_STEPS, False, timed, work)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        cyc = work[chosen.ws[-1]:].view(torch.int64).view(
            chosen.ctas, len(PHASES), COUNTERS).double().cpu()
        ghz = float(cyc[0, :, :2].sum()) / (ms * 1e6)
        us = cyc / ITERS / (ghz * 1e3)
        print(f"  phases ({ms:.3f} ms; SM clock {ghz:.3f} GHz from CTA 0's cycles), us an "
              f"iteration, work mean / max over CTAs (of it the products, mean), barrier wait "
              f"mean: " + "; ".join(
                  f"{ph} {float(us[:, i, 0].mean()):.2f} / {float(us[:, i, 0].max()):.2f} "
                  f"({float(us[:, i, 2].mean()):.2f}) / {float(us[:, i, 1].mean()):.2f}"
                  for i, ph in enumerate(PHASES)))
        rows = []
        for resident in (1, 0):
            for nb in td.NB_CHOICES:
                try:
                    p = td.plan(B, T, s, R, *limits, resident=resident, nb=nb)
                except ValueError:
                    continue
                rows.append((profile_lstm.cuda_ms(lambda: run(libs["base"], p), reps=2), p))
        print("  candidates, ms / (resident, nb, smem), fastest first: " + "; ".join(
            f"{ms:.3f} / ({p.resident}, {p.nb}, {p.smem})" + (" (plan)" if p == chosen else "")
            for ms, p in sorted(rows)))


def wrapper_times(model, d, dev) -> None:
    """The wrapper's CUDA-event ms at each shape, dropout off."""
    for B, T in SHAPES:
        seq, proj, mask = inputs(model, d, B, T, dev)
        with torch.no_grad():
            ms = profile_lstm.cuda_ms(lambda: td.tacotron_decode(
                model, d, seq, proj, mask, 0, R, MAX_STEPS, False))
        print(f"B={B} T={T} r={R}: tacotron_decode {ms:.3f} ms for {ITERS} iterations, "
              f"{ms / ITERS * 1e3:.2f} us an iteration ({td.__file__})")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_tacotron: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg = factories.default_config(factories.MODEL_TYPE_TACOTRON).replace(
        max_decoder_steps=MAX_STEPS)
    syn = factories.init_syn_model(factories.MODEL_TYPE_TACOTRON, seed=0, override_hp=cfg,
                                   device=dev)
    if "--wrapper" in sys.argv[1:]:
        wrapper_times(syn.model, syn.dims, dev)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = profile_lstm.build(Path(tmp), variants(profile_lstm.flat_source(
            "tacotron_decode.cu")), ("rtvc_tacotron_decode",))
        for B, T in SHAPES:
            profile_shape(libs, syn.model, syn.dims, B, T, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
