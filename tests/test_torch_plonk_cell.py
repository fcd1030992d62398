"""The port's PlonK as the benchmark's cell plonk-bn254-2e14.stream runs it,
held to the cell's plain reference (portbench/reference/plonk.py, exact
integer arithmetic that imports nothing of the port), with the cell's
tracing: the spans plonk.prove.grand_product, .quotient and .opening inside
their rounds, the ntt_elements counter, and the four readers of them.

One module fixture runs the cell's adapter (portbench/protocols/plonk.py)
at 2^4 gates on the CPU, with PLONK_DEVICE_THRESHOLD patched to 1 so that
the fused prover (backend/plonk_device.py) runs, and proves request 0 with
metrics on. A proof draws the next 11 values of the seeded stream, so
requests are proved in order from 0. The same proof with metrics off runs
the rounds again under request 0's blinds, its commitments read from the
first proof's MSM calls once their inputs are found equal (the MSM is not
what the spans wrap, and on the CPU each costs seconds).
"""

import copy

import pytest
import torch

import torch_support  # noqa: F401  (torch on one thread)
from portbench import harness, seeds
from portbench.protocols import plonk as adapter
from portbench.reference.bn254 import R
from portbench.trace import Trace
from zksnake_tpu_torch import metrics
from zksnake_tpu_torch.backend import config

CELL = "plonk-bn254-2e14.stream"
LOG2 = 4
N = 1 << LOG2
SEED = 2**33 + 21  # wider than 32 bits, as the benchmark's seeds may be
ROUNDS = tuple(f"plonk.prove.round{i}" for i in range(1, 6))
SPANS = {"plonk.prove.grand_product": "plonk.prove.round2",
         "plonk.prove.quotient": "plonk.prove.round3",
         "plonk.prove.opening": "plonk.prove.round5"}
SPAN_READERS = {"plonk_grand_product_s": "plonk.prove.grand_product",
                "plonk_quotient_s": "plonk.prove.quotient",
                "plonk_opening_s": "plonk.prove.opening"}
# rows x length of every transform a proof makes, by span (none: no NTT)
NTT_ELEMENTS = {
    "plonk.prove.round1": 4 * N + 4 * 4 * N + 4 * N,  # iNTT of wires and PI, their 4n NTT, G
    "plonk.prove.round2": 6 * 4 * N + 2 * 4 * N + N,  # 6 shifted wires, nom and den, Z
    "plonk.prove.round3": 4 * 8 * N + 2 * 8 * N + 4 * N + 4 * N,  # 8n products, (Z - 1) L1
    "plonk.prove.quotient": 4 * 8 * N + 2 * 8 * N + 4 * N + 4 * N,
    "plonk.prove.round4": None,
    "plonk.prove.round5": None,
    "plonk.prove.grand_product": None,
    "plonk.prove.opening": None,
    "plonk.prove.msm": None,
}


def closed_form(n):
    """ntt_elements a proof at n gates."""
    return 113 * n


@pytest.fixture(scope="module")
def cell():
    bench = harness.load_benchmark()
    _, cfg, _ = harness.find_cell(bench, CELL)
    mp = pytest.MonkeyPatch()
    mp.setattr(config, "PLONK_DEVICE_THRESHOLD", 1)
    protocol = adapter.Protocol(dict(cfg, log2_size=LOG2), SEED, torch.device("cpu"))
    protocol.setup()
    dev = protocol.plonk._device_prover()
    commit, calls = dev._commit, []

    def noted(raw, point_cls):
        points = commit(raw, point_cls)
        calls.append(([t.clone() for t in raw], points))
        return points

    mp.setattr(dev, "_commit", noted)
    metrics.enable(False)
    metrics.reset()
    metrics.enable()
    try:
        proof = protocol.prove(protocol.request(0))
    finally:
        metrics.enable(False)
    report = metrics.report()
    trace = Trace()
    trace.proofs = 1
    trace.phases = {k: v["seconds"] for k, v in report.items()}
    readings = {name: harness.module("layer_metrics", name).read(trace)
                for name in (*SPAN_READERS, "plonk_ntt_elements")}
    metrics.reset()

    replayed = iter(calls)

    def replay(raw, point_cls):
        want, points = next(replayed)
        assert len(raw) == len(want) and all(torch.equal(a, b) for a, b in zip(raw, want))
        return points

    mp.setattr(dev, "_commit", replay)
    blinds = seeds.protocol_draws(SEED, R - 1, adapter.SETUP_DRAWS + adapter.PROVE_DRAWS)[1:]
    quiet = protocol.plonk._prove_with_blinding(*protocol.request(0), blinds)
    replays_left = sum(1 for _ in replayed)
    yield {"protocol": protocol, "proof": proof, "report": report, "readings": readings,
           "quiet": quiet, "replays_left": replays_left, "calls": len(calls)}
    protocol.close()
    mp.undo()
    metrics.reset()


def test_the_fused_prover_proves_request_0_as_the_reference_does(cell):
    got = harness.check(cell["protocol"], None, [(0, 1.0, cell["proof"])], SEED)
    assert got == {"checked": 1, "mismatched": 0, "wrong": []}
    assert cell["calls"] == 4  # rounds 1, 2, 3 and 5 commit


@pytest.mark.parametrize("name", ["zeta_b", "tau_W_zeta"])
def test_one_planted_fault_is_one_mismatch(cell, name):
    bad = copy.copy(cell["proof"])
    value = getattr(bad, name)
    setattr(bad, name, (value + 1) % R if isinstance(value, int) else value + cell["proof"].tau_a)
    got = harness.check(cell["protocol"], None, [(0, 1.0, bad)], SEED)
    assert got == {"checked": 1, "mismatched": 1, "wrong": [(0, [name])]}


def test_a_proof_with_metrics_off_has_the_same_elements(cell):
    assert cell["replays_left"] == 0
    assert adapter.Protocol.elements(cell["quiet"]) == adapter.Protocol.elements(cell["proof"])


@pytest.mark.parametrize("span", sorted(SPANS))
def test_the_spans_nest_under_their_rounds(cell, span):
    rep = cell["report"]
    inner, outer = rep[span], rep[SPANS[span]]
    assert inner["parent"] == SPANS[span] and "parent" not in outer
    assert inner["calls"] == outer["calls"] == 1
    assert 0 < inner["seconds"] <= outer["seconds"]


@pytest.mark.parametrize("span", sorted(NTT_ELEMENTS))
def test_ntt_elements_is_its_closed_form_in_each_span(cell, span):
    assert cell["report"][span].get("ntt_elements") == NTT_ELEMENTS[span]


def test_ntt_elements_of_a_proof_is_113_n(cell):
    rep = cell["report"]
    assert sum(rep[r].get("ntt_elements", 0) for r in ROUNDS) == closed_form(N) == 1808
    assert closed_form(1 << 14) == 1_851_392


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_read_their_span_a_proof(cell, name):
    assert cell["readings"][name] == cell["report"][SPAN_READERS[name]]["seconds"] > 0


def test_ntt_reader_reads_the_counter_in_the_round_spans(cell):
    assert cell["readings"]["plonk_ntt_elements"] == closed_form(N)


@pytest.mark.parametrize("name", sorted(SPAN_READERS) + ["plonk_ntt_elements"])
def test_readers_read_nothing_where_the_program_has_no_such_span(cell, name):
    """A parent without the spans and the counter: the rounds alone, and no
    span proofs at all."""
    read = harness.module("layer_metrics", name).read
    metrics.reset()
    metrics.enable()
    try:
        with metrics.phase("plonk.prove.round3"):
            metrics.count("msm_points", 22)
    finally:
        metrics.enable(False)
    parent = Trace()
    parent.proofs = 1
    parent.phases = {k: v["seconds"] for k, v in metrics.report().items()}
    metrics.reset()
    assert read(parent) is None
    assert read(Trace()) is None
