"""CPU tests of the benchmark. The card-marked ones (`cuda`) decide inside
the test whether a card exists and skip without one.

    python -m pytest benchmark/tests -q
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where "
        "torch.cuda.is_available() is false)")
