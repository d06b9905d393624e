"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port (``src/repro_torch``).
The last line of standard output is the result as JSON; the last lines
of standard error are the numbers compared, each beside its limit.
"""
import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(sys.argv[1:], t0=T0))
