"""Run one cell of the benchmark of chromosight_torch.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See ``perfbench/harness.py``.
"""

import pathlib
import sys
import time

START = time.perf_counter()  # set-up counts from the start of the process

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], START))
