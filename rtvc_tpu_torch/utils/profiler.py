"""The program's timing: host phase ticks, spans on the device trace's
clock, and counters of the work done.

``Profiler`` is the named-phase wall-clock profiler, with capability parity
with the reference's step profiler (ref: utils/profiler.py:6-44 — named
``tick`` phases, periodic mean/std summaries); the trainers print it under
``--profile``. The original's ``device_trace`` is not copied: nothing here
calls it (``profile_train`` uses ``torch.profiler`` directly). This part is
the package's own copy of ``rtvc_tpu/utils/profiler.py``: the port imports
nothing of the JAX package.

``span(name)`` marks a stage of the inference path. It records only while
someone profiles the process with ``torch.profiler``: it is then a
``record_function`` range, in the same event list as the kernels, on the
same clock, nested on its thread. Otherwise it is one shared null context,
after a single read of the profiler's flag. ``count(name, n)`` adds to a
counter of the work done (always on: a lock and an add); ``counts()`` is a
snapshot. Every span and counter name starts with ``rtvc.``; the spans and
counters of the clone path are listed in PERF.md, section 3.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from time import perf_counter
from typing import Dict, List

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_NULL_SPAN = contextlib.nullcontext()
_counts: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    runs; the shared null context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; atomic under threads."""
    with _counts_lock:
        _counts[name] += n


def counts() -> Dict[str, int]:
    """A snapshot of every counter since the process began."""
    with _counts_lock:
        return dict(_counts)


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
