"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints the result as one JSON line, last on
standard output, and the numbers that decided ``correct`` beside their
limits as the last lines of standard error.  Without as many CUDA devices
as the cell asks for it prints no result and exits with 2.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
