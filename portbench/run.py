"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. See portbench/README.md.
"""
import time

T_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # a library that would load the JAX stack by itself is kept from it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one thread a process for numpy's and torch's CPU math: the loader's
    # fork workers and the host paste share the machine's cores, and a
    # pool of threads in each of them makes the runs spread
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness

    return harness.main(args, T_PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
