"""Training metrics: rolling windows, TSV logging, console stream.

Replaces the reference's visdom dashboards (ref: encoder/visualizations.py,
synthesizer/visualizations.py, vocoder/visualizations.py) with dependency-free
TSV logs (plottable anywhere) plus the same console progress instruments
(``ValueWindow`` steps/s, ref: synthesizer/utils/__init__.py:24-45;
``stream``/``progbar``/``simple_table``, ref: utils/display.py:10-143).

This package's own copy of ``rtvc_tpu/utils/metrics.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, Iterable


class ValueWindow:
    """Rolling mean over the last N values (capability parity with ref
    synthesizer/utils/__init__.py:24-45), deque-backed."""

    def __init__(self, window_size: int = 100):
        from collections import deque

        self._values = deque(maxlen=window_size)

    def append(self, x: float) -> None:
        self._values.append(float(x))

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        return sum(self._values) / max(1, len(self._values))

    def reset(self) -> None:
        self._values.clear()


class MetricsLogger:
    """Append-only TSV metrics file: step\tname\tvalue\twall_time."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            self.path.write_text("step\tname\tvalue\ttime\n")

    def log(self, step: int, values: Dict[str, float]) -> None:
        now = time.time()
        with self.path.open("a") as f:
            for name, value in values.items():
                f.write(f"{step}\t{name}\t{float(value):.6g}\t{now:.3f}\n")


def stream(message: str) -> None:
    """Single-line console progress (ref: utils/display.py)."""
    sys.stdout.write(f"\r{message}")
    sys.stdout.flush()


def progbar(i: int, n: int, size: int = 16) -> str:
    done = int(i * size / max(n, 1))
    return "█" * done + "░" * (size - done)


def simple_table(item_tuples: Iterable) -> None:
    """Key/value run-summary table (capability parity with ref
    utils/display.py's simple_table)."""
    items = [(str(k), f"{v:.4f}" if isinstance(v, float) else str(v))
             for k, v in item_tuples]
    if not items:
        return
    widths = [max(len(k), len(v)) for k, v in items]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    keys = "|" + "|".join(f" {k.center(w)} " for (k, _), w in zip(items, widths)) + "|"
    vals = "|" + "|".join(f" {v.center(w)} " for (_, v), w in zip(items, widths)) + "|"
    print("\n".join([sep, keys, sep, vals, sep]), flush=True)
