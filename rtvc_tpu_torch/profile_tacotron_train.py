"""Where K5's time goes, in each direction, by candidate plan and by taking
parts away.

    python -m rtvc_tpu_torch.profile_tacotron_train

Builds ``csrc/tacotron_train.cu`` (with ``common.cuh`` written into it) as
it is and in three variants: ``no_wait`` (every CTA arrives at the grid
barrier but none waits), ``no_loads`` (the inputs a warp multiplies are
constants, not read from L2) and ``phases`` (each CTA's thread 0 adds up,
for each phase of a step, seven in the forward and eight in the backward,
the cycles from the end of the last barrier to its arrival at the next and
the cycles it waits there; run once with the plan's choice and once with
"resident x1"). Times the forward and the backward with CUDA events at the
first and the last session of the Tacotron schedule (B 112 x 86 steps and
B 22 x 602 steps, T 160, full widths, seeded random weights, inputs and
cotangents, the forward kernel's residuals): each variant through the
package's plan, then every candidate plan forced through the kernel as it
is. The variants' outputs are wrong by construction; only their times are
read. Needs an NVIDIA GPU and nvcc.

    python rtvc_tpu_torch/profile_tacotron_train.py --wrapper

times only ``ops.tacotron_train.taco_train_fwd`` and ``taco_train_bwd`` at
the two shapes, through the public API of whichever ``rtvc_tpu_torch`` the
path holds: with ``PYTHONPATH`` at another checkout it times that checkout's
kernels, so that two versions are compared in one call.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rtvc_tpu_torch import _build, profile_lstm
from rtvc_tpu_torch.ops import tacotron_train as tk

# (B, n_iters) of the schedule's first session (r 7, 602 frames) and its last
# (r 1, batch 22); T 160 characters; the default widths D, L, E and KS
SHAPES = ((112, 86), (22, 602))
T, D, L, E, KS = 160, 256, 512, 896, 31

INPUT_LOAD = "__ldcg(reinterpret_cast<const float4*>(in + b * xs + k + s * kChunk))"
BARRIER = "rtvc::grid_barrier(sync, ctas * ++barriers);"
# the step loops of the forward and the backward
LOOP_STARTS = ("  for (int s = 0; s < n; ++s) {\n", "  for (int s = n - 1; s >= 0; --s) {\n")
PHASES = {"fwd": "ABCDEFG", "bwd": "ABCDEFGH"}
# each CTA's thread 0 adds, for each phase of a step, the cycles from the end
# of the last barrier to its arrival at the next and the cycles it waits
# there, behind the workspace (an even float offset: 8-byte counters);
# kPhases is the direction's count of phases
TIMED_BARRIER = (
    "{ __syncthreads(); const long long t_a = clock64(); " + BARRIER +
    " const long long t_b = clock64(); if (threadIdx.x == 0) { unsigned long long* acc = "
    "reinterpret_cast<unsigned long long*>(ws + ((pl.ws[kWsTotal] + 1) & ~1)) + "
    "((size_t)blockIdx.x * kPhases + (barriers - 1) % kPhases) * 2; "
    "acc[0] += t_a - t_last; acc[1] += t_b - t_a; } t_last = t_b; }")


def variants(source: str) -> dict:
    """The source as it is and the three variants (module docstring)."""
    want = sum(len(p) for p in PHASES.values())
    if source.count(BARRIER) != want:
        raise RuntimeError(f"profile: the kernel source no longer holds {want} "
                           f"barriers {BARRIER!r}")
    phases = source
    for start in LOOP_STARTS:
        phases = profile_lstm.replaced(phases, start, "  long long t_last = clock64();\n" + start)
    return {"base": source,
            "no_wait": profile_lstm.no_wait(source),
            "no_loads": profile_lstm.replaced(source, INPUT_LOAD, "make_float4(1.f, k, b, s)"),
            "phases": phases.replace(BARRIER, TIMED_BARRIER)}


def case(B: int, n: int, dev, seed: int = 11):
    """Seeded weights, inputs and cotangents at the full widths: (weights,
    the forward's inputs, the backward's arguments with the forward kernel's
    residuals)."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * fan ** -0.5).to(dev)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    w = tk.TrainWeights(
        gwh=u(D, 3 * D, fan=D), gbh=u(3 * D, fan=D), wq=u(D, D, fan=D), bq=u(D, fan=D),
        mloc=r(KS, D, s=0.1), vv=u(D, fan=D), wri=u(E + D, L, fan=E + D), bri=u(L, fan=E + D),
        l1wi=u(L, 4 * L, fan=L), l1wh=u(L, 4 * L, fan=L), l1b=u(4 * L, fan=L),
        l2wi=u(L, 4 * L, fan=L), l2wh=u(L, 4 * L, fan=L), l2b=u(4 * L, fan=L),
        gwi_ctx=u(E, 3 * D, fan=E))
    lens = torch.randint(T // 2, T + 1, (B,), generator=g)
    x = dict(xg_pre=r(n, B, 3 * D), enc_seq=r(B, T, E, s=0.5), enc_proj=r(B, T, D, s=0.5),
             char_mask=(torch.arange(T)[None, :] < lens[:, None]).float().to(dev),
             zo1=(torch.rand(n, B, L, generator=g) < 0.1).float().to(dev),
             zo2=(torch.rand(n, B, L, generator=g) < 0.1).float().to(dev))
    cots = [r(n, B, L), r(n, B, E), r(n, B, T)]
    _, res = tk.taco_train_fwd(w, **x)
    return w, x, (res, x["enc_seq"], x["enc_proj"], x["char_mask"], x["zo1"], x["zo2"], *cots)


def profile_shape(libs: dict, B: int, n: int, dev) -> None:
    w, x, args = case(B, n, dev)
    for direction, planner, launch in (
            ("fwd", tk.device_plan_fwd, lambda lib, p, work=None: tk.fwd_launch(
                lib, w, **x, p=p, work=work)),
            ("bwd", tk.device_plan_bwd, lambda lib, p, work=None: tk.bwd_launch(
                lib, w, *args, p=p, work=work))):
        chosen = planner(n, B, T, (D, L, E, KS), dev)
        print(f"{direction} B={B} n={n} T={T}: plan {chosen.name}, {chosen.ctas} CTAs, "
              f"{chosen.smem} bytes of shared memory a CTA, model {chosen.cost_ms:.3f} ms")
        for name, lib in libs.items():
            if name == "phases":
                continue
            ms = profile_lstm.cuda_ms(lambda: launch(lib, chosen))
            print(f"  {name}: {ms:.3f} ms, {ms / n * 1e3:.2f} us a step")
        phase_times(libs["phases"], launch, chosen, n, PHASES[direction], dev)
        resident = planner(n, B, T, (D, L, E, KS), dev, candidate=("resident", 1))
        if resident != chosen:
            phase_times(libs["phases"], launch, resident, n, PHASES[direction], dev)
        rows = []
        for cand in tk.CANDIDATES:
            try:
                p = planner(n, B, T, (D, L, E, KS), dev, candidate=cand)
            except ValueError as e:
                print(f"  candidate {cand}: {e}")
                continue
            ms = profile_lstm.cuda_ms(lambda: launch(libs["base"], p), reps=2)
            rows.append((ms, p))
        print("  candidates, ms (model ms), fastest first: " + "; ".join(
            f"{p.name} {ms:.3f} ({p.cost_ms:.3f})" + (" (plan)" if p == chosen else "")
            for ms, p in sorted(rows, key=lambda r: r[0])))


def phase_times(lib, launch, p, n: int, phases: str, dev) -> None:
    """One launch of the ``phases`` variant with plan ``p``: each phase's
    work and barrier wait, µs a step, from the CTAs' clocks."""
    at = (p.ws[-1] + 1) // 2 * 2
    work = torch.empty(at + p.ctas * len(phases) * 2 * 2, device=dev)
    work[at:].zero_()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch(lib, p, work)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    cyc = work[at:].view(torch.int64).view(p.ctas, len(phases), 2).double().cpu()
    ghz = float(cyc[0].sum()) / (ms * 1e6)
    us = cyc / n / (ghz * 1e3)
    print(f"  phases, {p.name} ({ms:.3f} ms; SM clock {ghz:.3f} GHz from CTA 0's cycles, which "
          f"leave out the set-up and the work after the walk), us a step, work mean / max over "
          f"CTAs, barrier wait mean: " + "; ".join(
              f"{ph} {float(us[:, i, 0].mean()):.2f} / {float(us[:, i, 0].max()):.2f} / "
              f"{float(us[:, i, 1].mean()):.2f}" for i, ph in enumerate(phases)))


def wrapper_times(dev) -> None:
    """The wrappers' CUDA-event ms at each shape."""
    for B, n in SHAPES:
        w, x, args = case(B, n, dev)
        fwd_ms = profile_lstm.cuda_ms(lambda: tk.taco_train_fwd(w, **x))
        bwd_ms = profile_lstm.cuda_ms(lambda: tk.taco_train_bwd(w, *args))
        print(f"B={B} n={n} T={T}: taco_train_fwd {fwd_ms:.3f} ms, {fwd_ms / n * 1e3:.2f} us a "
              f"step; taco_train_bwd {bwd_ms:.3f} ms, {bwd_ms / n * 1e3:.2f} us a step "
              f"({tk.__file__})")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_tacotron_train: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if "--wrapper" in sys.argv[1:]:
        wrapper_times(dev)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = profile_lstm.build(Path(tmp), variants(profile_lstm.flat_source(
            "tacotron_train.cu")), ("rtvc_tacotron_train_fwd", "rtvc_tacotron_train_bwd"))
        for B, n in SHAPES:
            profile_shape(libs, B, n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
