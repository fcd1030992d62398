"""The harness on the card at small sizes: a traced and an untraced run of
each cell's configuration at 2^11 (the smallest at which PlonK's fused
prover runs), correct, with every per-layer metric read. Run on a card
with

    python -m pytest portbench/tests/test_portbench_cuda.py -q
"""

import time

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda

CELLS = ["g16-bn254-2e16.stream", "plonk-bn254-2e14.stream"]


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_small_run_on_the_card_is_correct(cuda, bench, workload, trace):
    _, cfg, traffic = harness.find_cell(bench, workload)
    # one proof with the spans, one under the profiler, in a window that
    # holds at least two
    traffic = dict(traffic, span_proofs=1, trace_proofs=1)
    res = harness.run_cell(workload, 2**31 + 17, 8.0, trace, cuda, time.perf_counter(), bench,
                           dict(cfg, log2_size=11), traffic)
    correct, checks = harness.verdict(res)
    assert correct, (checks, res["check"], res["errors"])
    assert res["prove_s"] > 0 and res["memory_peak_bytes"] > 0
    if trace:
        names = {m["name"] for m in bench["per_layer"]}
        assert set(res["per_layer"]) == names, res["per_layer"]
        assert 0 < res["trace"].busy_s <= res["trace"].window_s
