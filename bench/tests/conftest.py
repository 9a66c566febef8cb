"""The benchmark's own tests: run from the root of a checkout with
``python -m pytest bench/tests``.  They put the checkout and its ``src``
on the path, as ``bench/run.py`` does."""

import shutil
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (CHECKOUT / "src", CHECKOUT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def checkout_copy(root: Path) -> Path:
    """A copy of the checkout's BENCHMARK.json and bench/ under ``root``."""
    shutil.copytree(CHECKOUT / "bench", root / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root
