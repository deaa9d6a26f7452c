"""Named-phase wall-clock profiler.

Capability parity with the reference's step profiler (ref:
utils/profiler.py:6-44 — named ``tick`` phases, periodic mean/std summaries).
The original's ``device_trace`` is not copied: nothing here calls it
(``profile_train`` uses ``torch.profiler`` directly).

This package's own copy of ``rtvc_tpu/utils/profiler.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, List

import numpy as np


class Profiler:
    """Call ``tick(phase_name)`` after each phase of the step loop; every
    ``summarize_every`` completed cycles a mean/std table is printed."""

    def __init__(self, summarize_every: int = 10, disabled: bool = False):
        self.summarize_every = summarize_every
        self.disabled = disabled
        self._mark = perf_counter()
        self._samples: Dict[str, List[float]] = {}

    def tick(self, name: str) -> None:
        if self.disabled:
            return
        now = perf_counter()
        bucket = self._samples.setdefault(name, [])
        if len(bucket) >= self.summarize_every:
            self.summarize()
        bucket.append(now - self._mark)
        self._mark = now

    def reset(self) -> None:
        self._samples.clear()
        self._mark = perf_counter()

    def summarize(self) -> None:
        if not self._samples:
            return
        rows = []
        for name, deltas in self._samples.items():
            rows.append(
                (name, len(deltas), np.mean(deltas) * 1e3, np.std(deltas) * 1e3)
            )
        width = max(len(r[0]) for r in rows)
        print(f"\n[profiler] phase timings over last {rows[0][1]} steps:")
        for name, n, mean_ms, std_ms in rows:
            print(f"  {name.ljust(width)}  mean {mean_ms:7.1f} ms  ±{std_ms:6.1f} ms")
        print("", flush=True)
        for bucket in self._samples.values():
            bucket.clear()
