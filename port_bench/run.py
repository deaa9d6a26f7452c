"""The benchmark of rtvc_tpu_torch on the card: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
then ``checks``), and each number compared beside its limit as the last
lines on standard error. Exits with another code than 0, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or
where the port or a file of the cell is missing.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for the numeric libraries, set before they load: the host
# work between the card's launches then does not wait on pool threads that
# a busy host has descheduled, which set the clone's tail on such hosts.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)  # the checkout's root, not the script's folder
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from port_bench.harness import runner

    return runner.main(args, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
