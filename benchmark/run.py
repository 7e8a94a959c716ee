"""Run one cell of BENCHMARK.json once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; prints one JSON line (the contract's keys).
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, in place of this folder: modules load as benchmark.*
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
