"""Run one cell of the benchmark once, from the root of a checkout:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object) and each number the check compared, beside its limit, as the last
lines of standard error.  Exits non-zero, printing no result, without the
CUDA devices the cell asks for.  ``BENCHMARK.json`` names the cells;
``bench/benchlib/spec.py`` says where each part of a cell lives.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
# Triton's kernel cache at a fixed path inside the checkout, so that only
# the first run of a checkout compiles (nvcc's builds go to the port's own
# fixed directory, src/repro_torch/kernels/_build/).
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")

from benchlib.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
