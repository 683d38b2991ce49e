"""Entry point of the benchmark (see gpubench/harness.py):

  python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the last line of standard output is the
result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from gpubench.harness import main

    sys.exit(main(sys.argv[1:], t_start=T_START, root=ROOT))
