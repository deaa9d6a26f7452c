"""What the per-layer metric files share: the device's idle
share, kernels' roofline shares and the whole window's MFU, each from the
run's spans, counters and trace. A reader that finds nothing to read
returns None, and the metric is left out of the line."""
from __future__ import annotations

from typing import Optional

from port_bench.counts import flops


def idle_pct(run) -> Optional[float]:
    red = run.trace_red
    if not red or not run.window_s:
        return None
    return 100.0 * (1.0 - red["busy_s"] / run.window_s)


def mfu_pct(run) -> Optional[float]:
    """The model FLOPs the window's completed work needed over the window
    at the float32 peak (the configurations compute in float32, TF32 off)."""
    work = run.counters.get("model_flops")
    if not work or not run.window_s:
        return None
    return 100.0 * work / (run.window_s * flops.F32_FLOPS)


def kernel_s(run, name: str) -> Optional[float]:
    red = run.trace_red
    if not red:
        return None
    t = red["kernels_s"].get(name, 0.0)
    return t or None


def k1_roofline_pct(run) -> Optional[float]:
    """K1's bound for the launches of the window (folds × steps each) over
    K1's device time in the trace."""
    t = kernel_s(run, "wavernn_kernel")
    launches = run.counters.get("k1_launches")
    if t is None or not launches:
        return None
    return 100.0 * flops.k1_bound_s(run.config["vocoder"], launches) / t


def k5_roofline(run) -> Optional[float]:
    """K5's forward and backward bound for the window's steps over the two
    kernels' device time in the trace."""
    fwd = kernel_s(run, "tacotron_train_fwd_kernel")
    bwd = kernel_s(run, "tacotron_train_bwd_kernel")
    shape, steps = run.counters.get("k5"), run.counters.get("steps")
    if fwd is None or bwd is None or not shape or not steps:
        return None
    t = run.config["synthesizer"]
    bound = (flops.bound_s(*reversed(flops.k5_fwd(t, *shape)))[0]
             + flops.bound_s(*reversed(flops.k5_bwd(t, *shape)))[0])
    return 100.0 * steps * bound / (fwd + bwd)
