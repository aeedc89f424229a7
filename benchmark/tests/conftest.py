"""Tests of the benchmark itself (``python -m pytest benchmark/tests``).

They run on the CPU at small sizes.  A test that needs a CUDA card
carries the ``chip`` marker and skips itself where none is present; it
decides inside the test, never while the module is imported.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips itself where none is "
        "present")
