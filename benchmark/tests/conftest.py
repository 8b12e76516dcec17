"""The benchmark's CPU tests: its own modules and the port importable."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

# one thread a test process: the tests run several processes at once
import torch  # noqa: E402

torch.set_num_threads(1)
