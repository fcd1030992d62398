"""The benchmark's own tests: run from the repo root with

    python -m pytest portbench/tests -q

Tests that need a CUDA card carry the `cuda` marker and skip from inside
the test without one."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (from inside the test) without one"
    )


# The PlonK cell is kept out of BENCHMARK.json while its runs spread by more
# than the largest bound allows (PERF.md, Open questions); its files stay,
# and the tests run them through this entry.
PLONK_CELL = {"name": "plonk-bn254-2e14.stream", "config": "plonk-bn254-chain-2e14",
              "traffic": "stream", "chips": 1}


@pytest.fixture
def bench():
    """BENCHMARK.json with the PlonK cell added."""
    from portbench import harness

    b = harness.load_benchmark()
    return dict(b, workloads=b["workloads"] + [PLONK_CELL])
