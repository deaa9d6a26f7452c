"""The device's idle share of the traced window: 1 - the union of the
intervals in which a device operation ran, over the window."""
from port_bench.harness import readers


def read(run):
    return readers.idle_pct(run)
