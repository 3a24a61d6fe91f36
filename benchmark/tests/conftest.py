"""Tests of the benchmark. They run on the CPU; a test that needs the card
is marked `card` and decides inside itself whether one is present.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
