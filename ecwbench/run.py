"""The benchmark of ecw_cc_torch: one run of one cell.

    python3 ecwbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up time counts from here, before the imports.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ecwbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
