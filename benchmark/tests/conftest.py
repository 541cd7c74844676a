"""The benchmark's tests import its modules and the port from the checkout."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH.parent, BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
