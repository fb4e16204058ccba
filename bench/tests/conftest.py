"""CPU tests of the benchmark harness (``python -m pytest bench/tests -q``).
Tests marked ``chip`` need a CUDA card and skip without one; whether one is
there is decided inside the test, never at import."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
