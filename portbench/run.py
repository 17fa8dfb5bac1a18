"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of standard
output (see `portbench/harness.py`); exits non-zero without a result when
the cell's cards are missing or JAX was loaded.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == '__main__':
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], t_start=T_START))
