"""pytest settings of the benchmark's own tests: the `card` marker.

A test marked `card` needs a CUDA card; the `card` fixture skips it
here, deciding inside the test (never at import or collection).  On the
chip they run as

    python -m pytest -q -s -m card portbench/tests
"""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip with "
                    "`python -m pytest -q -s -m card portbench/tests`")
