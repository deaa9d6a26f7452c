"""K1's share of its roofline: its bound for the window's launches (the
larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s) over its
device time in the trace."""
from port_bench.harness import readers


def read(run):
    return readers.k1_roofline_pct(run)
