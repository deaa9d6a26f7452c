"""One run of one cell: find the cell's files by name, check the card, run
the driver's set-up and window, read the trace, run the reference check,
print the result line.

The files of a cell, all found by name:

* ``BENCHMARK.json`` (the checkout's root): the cell's entry in
  ``workloads`` and the metrics that name it;
* ``port_bench/traffic/<traffic>.json``: the driver and its traffic
  parameters;
* ``port_bench/workloads/<cell>.json``: the limits of the cell's check;
* ``port_bench/configs/<config>.json``: the widths and the assumptions;
* ``port_bench/drivers/<driver>.py``: ``setup(run) -> state``,
  ``window(run, state)``, ``end_to_end(run, state) -> {metric: value}``,
  ``release(run, state) -> record`` (what the check needs, the program's
  state dropped), ``check(run, record)``;
* ``port_bench/layer_metrics/<metric>.py``: ``read(run) -> float | None``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rtvc_tpu")


class Refused(Exception):
    """The run cannot measure: no result is printed and the exit code is
    not 0."""


def load_module(path: Path) -> ModuleType:
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        "port_bench._found." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT) if ROOT in path.parents else path}")
    return json.loads(path.read_text())


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` (end_to_end, per_layer) this cell reports:
    those that list it, and those that list no cells (a per-layer metric
    without a list: where the cell reports the end-to-end metric it moves)."""
    e2e = {m["name"] for m in cell_metrics_e2e(bench, cell)}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out


def cell_metrics_e2e(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile by linear interpolation between order statistics
    (numpy's default)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    k = (len(xs) - 1) * p / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


class Run:
    """What a driver sees: the cell's parameters, the clock, spans and
    counters, the outcome of every request, and the checks."""

    def __init__(self, args, t_process: float, bench: dict, cell: dict, workload: dict,
                 config: dict):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.t_process = t_process
        self.bench, self.cell, self.workload, self.config = bench, cell, workload, config
        self.traffic = workload.get("traffic", {})
        self.limits: Dict[str, float] = workload.get("limits", {})
        self.spans: List[tuple] = []
        self.counters: Dict[str, float] = {}
        self.latencies_s: List[float] = []
        self.attempted = 0
        self.failed = 0
        self.checks: List[tuple] = []
        self.window_s: Optional[float] = None
        self.t_window: Optional[float] = None
        self.trace_red: Optional[dict] = None
        self.memory_peak = 0
        self.device = None
        self._prof = None
        self.span_names = set()
        self.marks: List[tuple] = []

    def mark(self, name: str) -> None:
        """A point of the set-up, reported with its time since the process
        began."""
        self.marks.append((name, time.perf_counter() - self.t_process))

    # -- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """A span in the benchmark's own files around a call into a layer;
        in a traced run also a ``record_function`` range of the same name."""
        self.span_names.add(name)
        rf = None
        if self._prof is not None:
            import torch

            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            if self.t_window is not None and self.window_s is None:
                self.spans.append((name, t0, t1))

    def span_mean_ms(self, name: str) -> Optional[float]:
        d = [(t1 - t0) * 1e3 for n, t0, t1 in self.spans if n == name]
        return statistics.fmean(d) if d else None

    def sync(self) -> None:
        """Wait for the device (nothing to wait for on the CPU of the tests)."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window --------------------------------------------------------
    def open_window(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_process
        if self.trace:
            from port_bench.harness import trace

            self._prof = trace.start()
        self.t_window = time.perf_counter()

    def deadline_passed(self) -> bool:
        return time.perf_counter() - self.t_window >= self.seconds

    def close_window(self) -> None:
        import torch

        self.sync()
        self.window_s = time.perf_counter() - self.t_window
        if self._prof is not None:
            from port_bench.harness import trace

            trace.stop(self._prof)
            gc.disable()  # the trace's millions of event objects set off collection on collection
            try:
                self.trace_red = trace.reduce(self._prof, self.span_names)
            finally:
                gc.enable()
            self._prof = None
        if self.device.type == "cuda":
            self.memory_peak = max(torch.cuda.max_memory_allocated(i)
                                   for i in range(int(self.cell["chips"])))

    def check(self, name: str, value: float, limit: Optional[float] = None) -> None:
        """A number compared with its limit (from the workload file unless
        given); a missing limit fails."""
        if limit is None:
            limit = self.limits.get(name, -1.0)
        self.checks.append((name, float(value), float(limit)))


def free_program_state(run: Run) -> None:
    import torch

    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(args, t_process: float, device=None) -> int:
    """``device``: the CPU tests' device, which skips the look for a card;
    the command line never gives one."""
    try:
        return _main(args, t_process, device)
    except Refused as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2


def prepare(args, t_process: float, test_device=None):
    """The cell's files by name, the environment, the look for a card → (run,
    driver)."""
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise Refused(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    workload = read_json(BENCH / "workloads" / f"{cell['name']}.json")
    traffic = read_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    workload = {**workload, "driver": traffic["driver"], "traffic": traffic["params"]}
    config = read_json(BENCH / "configs" / f"{cell['config']}.json")
    driver = load_module(BENCH / "drivers" / f"{workload['driver']}.py")

    # every cache of the program inside the checkout, at fixed paths
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    import torch

    torch.set_num_threads(1)  # as run.py sets the libraries' pools: one host thread
    if test_device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false: this benchmark runs on the card "
                          "only")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"the cell asks for {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
    run = Run(args, t_process, bench, cell, workload, config)
    run.device = torch.device("cuda", 0) if test_device is None else torch.device(test_device)
    run.mark("torch imported, card found")
    return run, driver


def measure(run: Run, driver):
    """Set-up, the window, the end-to-end metrics → (metrics, the record
    the check reads); the program's state is gone on return."""
    state = driver.setup(run)
    run.open_window()
    driver.window(run, state)
    run.close_window()
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    metrics = driver.end_to_end(run, state)
    metrics["setup_s"] = run.setup_s
    record = driver.release(run, state)  # what the check reads; the program's state goes
    del state
    free_program_state(run)
    return metrics, record


def _main(args, t_process: float, test_device=None) -> int:
    run, driver = prepare(args, t_process, test_device)
    metrics, record = measure(run, driver)
    driver.check(run, record)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    return report(run, metrics)


def report(run: Run, metrics: Dict[str, float]) -> int:
    import torch

    bench, cell = run.bench, run.cell["name"]
    out: Dict[str, dict] = {}
    if run.trace:
        for m in cell_metrics(bench, cell, "per_layer"):
            reader = load_module(BENCH / "layer_metrics" / f"{m['name']}.py")
            value = reader.read(run)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            if m["name"] not in metrics:
                raise Refused(f"the driver gave no {m['name']}")
            out[m["name"]] = {"value": float(metrics[m["name"]]), "unit": m["unit"]}
    correct = bool(run.checks) and all(v <= lim for _, v, lim in run.checks) \
        and run.failed == 0 and run.attempted > 0
    kind = torch.cuda.get_device_name(0) if run.device.type == "cuda" else "cpu (test)"
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": kind,
              "count": int(run.cell["chips"]), "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": out, "device": device}
    if run.trace and run.trace_red is not None:
        from port_bench.harness import trace

        device["busy_s"] = run.trace_red["busy_s"]
        device["window_s"] = run.window_s
        line["breakdown"] = trace.breakdown(run.trace_red)
    card = card_line() if run.device.type == "cuda" else "cpu (test)"
    print(f"port_bench: {run.cell['name']} seed {run.seed}: {card}; "
          f"window {run.window_s:.3f} s, setup {run.setup_s:.3f} s, "
          f"{run.attempted} attempted, {run.failed} failed", file=sys.stderr)
    print("set-up: " + ", ".join(f"{n} {t:.3f} s" for n, t in run.marks), file=sys.stderr)
    for name, v, lim in run.checks:
        verdict = "ok" if v <= lim else "FAIL"
        print(f"check {name} = {v!r} limit {lim!r} {verdict}", file=sys.stderr)
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
