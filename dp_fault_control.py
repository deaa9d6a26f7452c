"""Negative control of ``chip_smoke.py``'s data-parallel checks on one
NVIDIA GPU: what those checks read when the two-process run is wrong.

    python3 dp_fault_control.py

The runtimeracer and Tacotron trainers run as ``chip_smoke.py:phase_dp``
runs them (full width, ``DP_STEPS`` steps, two processes over gloo on the
one card, beside one process on the same global batches), once for each
fault, planted in both ranks:

  * ``none``: nothing planted (the run ``phase_dp`` checks);
  * ``bn``: the BatchNorms take each rank's own moments
    (``layers.sync_batch_norms`` hands them no group);
  * ``masks``: the random masks are drawn at each rank's own shape from the
    step's generator (no ``distributed.ShardRows``), so both ranks draw the
    same rows and neither draws the global batch's.

For each fault and trainer it prints whether the ranks' states are bitwise
equal, the largest relative difference of the losses from one process's
(``phase_dp`` holds them at 1e-4), the entries of the state beyond
``DP_TOL`` and their share (``phase_dp`` allows ``DP_SHARE``), and the
first of ``dp_against_one``'s checks that fails, if one does; then all of
it as one JSON line. It fails nothing itself. Prints the card's name and
power limit first; exits 1 without a CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

STAGES = ("runtimeracer", "tacotron")
FAULTS = ("none", "bn", "masks")


def plant(fault: str) -> None:
    """Plant ``fault`` in this process's training steps."""
    from rtvc_tpu_torch.parallel import distributed
    from rtvc_tpu_torch.train import steps

    if fault == "bn":
        steps.sync_batch_norms = lambda model, group: contextlib.nullcontext()
    elif fault == "masks":
        distributed.shard_rows = lambda generator, group: generator
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")


def worker(argv) -> int:
    """``--worker <fault> <rank> <world> <port> <dir> <device>``: one rank
    of ``chip_smoke.dp_worker`` over ``STAGES`` with ``fault`` planted."""
    plant(argv[0])
    cs.DP_STAGES = STAGES
    return cs.dp_worker(argv[1:])


def beyond_tolerance(stage, got, one):
    """The entries of state ``got`` beyond ``DP_TOL`` from the one-process
    run ``one``, and the state's size."""
    atol, rtol = cs.DP_TOL[stage]
    beyond = total = 0
    for name, v in one["model"].state_dict().items():
        v = v.detach().cpu()
        beyond += int(((got[name] - v).abs() > atol + rtol * v.abs()).sum())
        total += v.numel()
    return beyond, total


def run_fault(fault, dev, card, work, single):
    import numpy as np
    import torch

    out = work / fault
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    port = cs.free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker", fault,
                               str(rank), "2", str(port), str(out), str(dev)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=cs.DP_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"fault {fault}: rank {rank} exited {p.returncode}:\n"
                               f"{log[-4000:]}")
    rows = []
    for stage in STAGES:
        ranks = [torch.load(out / f"{stage}_{r}.pt", weights_only=False) for r in (0, 1)]
        got = ranks[0]["state"]
        equal = all(torch.equal(got[k], ranks[1]["state"][k]) for k in got)
        want = np.asarray(single[stage]["losses"])
        loss_rel = float(np.max(np.abs(np.asarray(ranks[0]["losses"]) - want)
                                / np.abs(want)))
        beyond, total = beyond_tolerance(stage, got, single[stage])
        try:
            cs.dp_against_one(stage, got, single[stage])
            caught = None
        except cs.SmokeFailure as e:
            caught = str(e).splitlines()[0][:300]
        row = {"fault": fault, "stage": stage, "ranks_bitwise_equal": equal,
               "loss_max_rel_diff": loss_rel, "entries_beyond_tol": beyond,
               "entries": total, "share_beyond_tol": beyond / total,
               "dp_against_one_fails": caught}
        rows.append(row)
        print(f"{card}: fault {fault}, {stage} (2 processes on one card, {wall:.1f} s): ranks "
              f"bitwise equal {equal}; losses up to {loss_rel:.3e} (rel) from one process's "
              f"(phase_dp: 1e-4); {beyond} of {total} entries beyond {cs.DP_TOL[stage]} "
              f"({100 * beyond / total:.4f} %; phase_dp allows {100 * cs.DP_SHARE:.3f} %); "
              f"dp_against_one: {caught or 'passes'}", flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dp_fault_control: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    from rtvc_tpu_torch import _build

    dev = torch.device("cuda", 0)
    _build.library()
    work = _build.BUILD_DIR / "dp_fault_runs"
    shutil.rmtree(work, ignore_errors=True)
    try:
        single = {stage: cs.dp_stage(stage, dev, work / "single") for stage in STAGES}
        rows = [row for fault in FAULTS for row in run_fault(fault, dev, card, work, single)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"card": card, "faults": rows}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2:]))
    sys.exit(main())
