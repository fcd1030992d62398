"""A whole run of each cell at a toy size on the CPU, past the harness's
look for a card, with the timed path broken underneath: `correct` has to
come out false under each fault a prover can have, and true without one.

The faults: a prove that returns its state unchanged (the last proof
again); half of each MSM's lanes left out; an answer altered where it is
made (Groth16's C, PlonK's first evaluation). One card has no exchange
between cards to leave out.
"""

import time

import pytest

from portbench import harness

CELLS = {"groth16": "g16-bn254-2e16.stream", "plonk": "plonk-bn254-2e14.stream"}
TRAFFIC = {"kind": "closed_loop", "concurrency": 1, "warmup": 1, "pool_prove_s": 1.0,
           "pool_spare": 1, "trace_proofs": 0, "span_proofs": 0}


def _stale_state(monkeypatch, proto_mod):
    real, last = proto_mod.Protocol.prove, []

    def prove(self, inputs):
        if not last:
            last.append(real(self, inputs))
        return last[0]

    monkeypatch.setattr(proto_mod.Protocol, "prove", prove)


def _half_the_msm(monkeypatch, proto_mod):
    from zksnake_tpu_torch.backend import groth16_device, msm, plonk_device

    real = msm.msm_pippenger_many

    def half(gs, jobs, c, *args, **kw):
        cut = []
        for P, s in jobs:
            m = max(1, s.shape[1] // 2)
            cut.append((gs.map(lambda t: t[..., :m].contiguous(), P), s[:, :m].contiguous()))
        return real(gs, cut, c, *args, **kw)

    for mod in (msm, groth16_device, plonk_device):
        monkeypatch.setattr(mod, "msm_pippenger_many", half)


def _answer_altered(monkeypatch, proto_mod):
    from zksnake_tpu_torch.groth16 import Groth16
    from zksnake_tpu_torch.plonk import Plonk

    assemble, prove_device = Groth16._assemble_proof, Plonk._prove_device

    def assemble_altered(self, *args):
        proof = assemble(self, *args)
        proof.C = proof.C + self.E.G1()
        return proof

    def prove_altered(self, *args):
        proof = prove_device(self, *args)
        proof.zeta_a = (proof.zeta_a + 1) % self.order
        return proof

    monkeypatch.setattr(Groth16, "_assemble_proof", assemble_altered)
    monkeypatch.setattr(Plonk, "_prove_device", prove_altered)


FAULTS = {"none": None, "stale_state": _stale_state, "half_the_msm": _half_the_msm,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("protocol", list(CELLS))
def test_correct_is_false_under_each_fault(bench, protocol, fault, monkeypatch):
    from zksnake_tpu_torch.backend import config

    monkeypatch.setattr(config, "PLONK_DEVICE_THRESHOLD", 1)
    monkeypatch.setattr(config, "MSM_DEVICE_THRESHOLD", 1)
    _, cfg, _ = harness.find_cell(bench, CELLS[protocol])
    proto_mod = harness.module("protocols", cfg["protocol"])
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch, proto_mod)
    res = harness.run_cell(CELLS[protocol], 2**31 + 99, 0.01, 0, "cpu", time.perf_counter(),
                           bench, dict(cfg, log2_size=3), TRAFFIC)
    correct, checks = harness.verdict(res)
    assert res["attempted"] >= 1
    assert correct == (fault == "none"), (checks, res["check"], res["errors"])
