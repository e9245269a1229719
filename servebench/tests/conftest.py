"""Tests of the serving benchmark: ``python -m pytest servebench/tests``
from the repository's root. Tests that need a CUDA card carry the
``card`` marker and skip without one (decided inside the test)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
