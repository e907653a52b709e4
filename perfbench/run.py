"""Runs one cell of the benchmark once; see ``perfbench/harness/main.py``.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>
"""

import time

T0 = time.perf_counter()   # set-up is timed from the process's start

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
