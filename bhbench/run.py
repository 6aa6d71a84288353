"""Entry point of the benchmark: python3 bhbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>, from the root of a checkout."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bhbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
