"""The readings that a cell's limits are set from, in one process: the
program's numbers on every seed of ``--seeds``, and on the first
``--control-seeds`` of them also the control's (the plain reference at TF32,
the nearest precision below the configurations' float32, put in the
program's place on the same prompts and tokens) and each planted fault's (an
answer altered where the program produces it).

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 3 --seconds 8 [--out chiprun_out/control.jsonl]

Each seed is a whole run of the cell (its own weights, traffic, set-up and
a window of ``--seconds`` at the cell's own load), then its readings as one
JSON line; the last line is the summary: each number's largest program
reading, the control's smallest and each fault's smallest.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds, control_seeds: int, seconds: float, device=None, out=None):
    from port_bench.harness import runner

    lines = []
    for k, seed in enumerate(seeds):
        args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
        run, driver = runner.prepare(args, time.perf_counter(), device)
        _, record = runner.measure(run, driver)
        items = driver.items(run, record)
        line = {"seed": seed, "items": len(items),
                "program": [driver.numbers(run, record, it) for it in items]}
        if k < control_seeds:
            line["control"] = [driver.numbers(run, record, driver.control_item(run, record, it))
                               for it in items]
            line["faults"] = {name: [driver.numbers(run, record, f(it), *filter(None, [stages]))
                                     for it in items[:1]]
                              for name, (f, stages) in driver.faults(run).items()}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        del record, items
        runner.free_program_state(run)
    summary = summarise(lines)
    print(json.dumps(summary), flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(json.dumps(summary) + "\n")
    return summary


def summarise(lines) -> dict:
    """Each number: the largest program reading over the seeds, the
    smallest control reading, each fault's smallest reading."""
    names = sorted({k for ln in lines for r in ln["program"] for k in r})
    out = {}
    for n in names:
        prog = [r[n] for ln in lines for r in ln["program"]]
        ctrl = [r[n] for ln in lines for r in ln.get("control", [])]
        fl = {}
        for ln in lines:
            for f, rs in ln.get("faults", {}).items():
                fl.setdefault(f, []).extend(r[n] for r in rs if n in r)
        out[n] = {"program_max": max(prog), "program_all": prog,
                  "control_min": min(ctrl) if ctrl else None,
                  "faults_min": {f: min(v) for f, v in fl.items() if v}}
    return {"summary": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.control_seeds, a.seconds,
             out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
