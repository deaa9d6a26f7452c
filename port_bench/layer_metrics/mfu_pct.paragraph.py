"""The model FLOPs of the window's completed work over the window at the
card's float32 peak (67 TFLOP/s)."""
from port_bench.harness import readers


def read(run):
    return readers.mfu_pct(run)
