"""The benchmark's CPU tests import ``benchlib`` from ``bench/`` and the
port from ``src/``."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
