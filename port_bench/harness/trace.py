"""``torch.profiler`` over the measured window, reduced to what the
per-layer metrics read: the device's busy time as the union of the intervals
in which any device operation ran, each kernel's device time by its bare
name, each host operator's device time, and the idle gaps between device
operations labelled by the benchmark's own span that was open on the host
when the gap began."""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.__enter__()
    if cuda:
        torch.cuda.synchronize()
    return prof


def stop(prof) -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)


def kernel_name(name: str) -> str:
    """A device event's name → its bare function name (no ``void``,
    namespace, template arguments or parameters)."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[(<]", name)[0].split("::")[-1].strip()


def union_seconds(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(seconds covered by the union of [start, end) intervals in µs, the gaps
    between them as (start, end))."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6, gaps


def _device_time_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _child_device_time_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def reduce(prof, span_names) -> Dict:
    """→ {"busy_s", "kernels_s" {bare name: s}, "kernel_calls" {name: n},
    "ops_s" {host op: device s}, "gaps_s" {label: s}, "longest_gaps" [(label,
    s)], "first_us", "last_us"}."""
    from torch.autograd import DeviceType

    events = prof.events()
    device, host_spans = [], []
    kernels_s: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    ops_s: Dict[str, float] = defaultdict(float)
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            device.append((s, t))
            kernels_s[kernel_name(e.name)] += (t - s) * 1e-6
            calls[kernel_name(e.name)] += 1
        else:
            if e.name in span_names:
                host_spans.append((s, t, e.name))
            if e.name.startswith("aten::"):
                ops_s[e.name] += _child_device_time_us(e) * 1e-6
    busy, gaps = union_seconds(device)
    by_label: Dict[str, float] = defaultdict(float)
    labelled = []
    # one sweep: span boundaries and gap starts in time order, a stack of the
    # open spans (the benchmark's spans nest); a gap takes the innermost
    marks = sorted([(s, 1, name) for s, _, name in host_spans]
                   + [(t, 0, name) for _, t, name in host_spans]
                   + [(g0, 2, i) for i, (g0, _) in enumerate(gaps)], key=lambda m: (m[0], m[1]))
    stack: List[str] = []
    for _, kind, what in marks:
        if kind == 1:
            stack.append(what)
        elif kind == 0:
            if what in stack:
                del stack[len(stack) - 1 - stack[::-1].index(what)]
        else:
            g0, g1 = gaps[what]
            label = stack[-1] if stack else "no span"
            by_label[label] += (g1 - g0) * 1e-6
            labelled.append((label, (g1 - g0) * 1e-6))
    labelled.sort(key=lambda x: -x[1])
    return {"busy_s": busy, "kernels_s": dict(kernels_s), "kernel_calls": dict(calls),
            "ops_s": dict(ops_s), "gaps_s": dict(by_label), "longest_gaps": labelled[:10],
            "first_us": min((s for s, _ in device), default=0.0),
            "last_us": max((t for _, t in device), default=0.0)}


def breakdown(red: Dict) -> Dict:
    """The line's ``breakdown``: the ten device operations that took most
    time, and the idle time between device operations summed by the host
    span that was open, the ten largest."""
    ops = sorted(red["kernels_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["gaps_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
