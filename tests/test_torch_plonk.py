"""PlonK on the PyTorch port against the JAX package and its fixtures, over
BN254 and BLS12-381.

The port proves on device="cpu" here (the kernels' plain versions). Each
package builds its circuit through its own front end, and the two are
compared through bytes and integers. Under one seeded randomness stream the
port's setup gives the JAX package's key bytes; under the same 11 blinds
(`_prove_with_blinding`) its proofs equal the JAX host path's byte for byte,
on the port's host path and on its fused device path
(PLONK_DEVICE_THRESHOLD patched to 1, so the n = 16 circuit runs
backend/plonk_device.py); the pinned fixtures tests/fixtures/plonk_*.hex
come out under tests/test_proof_fixtures.py's deterministic stream; a key
made by the JAX package, carried across as bytes, proves the same; the
device path with ZKSNAKE_MXU_MONTMUL=1 (K3 and K2m's plain versions) proves
the same; verify accepts and rejects; prefix_sum_mod equals the JAX one.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import zksnake_tpu.arithmetization as jax_front
import zksnake_tpu_torch.arithmetization as torch_front
from zksnake_tpu.backend import field as jax_field
from zksnake_tpu.plonk import Plonk as JaxPlonk
from zksnake_tpu.plonk import protocol as jax_protocol
from zksnake_tpu_torch.backend import config as torch_config
from zksnake_tpu_torch.backend import field as torch_field
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.plonk import Plonk, Proof, ProvingKey, VerifyingKey
from zksnake_tpu_torch.plonk import protocol as torch_protocol

from torch_support import CURVES, FIELDS, REPO

INPUT = {"BN254": 3, "BLS12_381": 1337}


def det_random_int(seed):
    """tests/test_proof_fixtures.py's deterministic stand-in for
    utils.get_random_int (1..n_max)."""
    rng = random.Random(seed)
    return lambda n_max: 1 + rng.randrange(n_max)


def gate_circuit(front, curve):
    """tests/test_plonk.py::_build_cs (public y and z, 9 gates, n = 16)
    through one package's front end, compiled and solved."""
    Var = front.Var
    x, y, z = Var("x"), Var("y"), Var("z")
    v = [Var(f"v{i}") for i in range(7)]
    cs = front.ConstraintSystem(["x"], ["y"], FIELDS[curve])
    cs.add_constraint(z == x)
    cs.add_constraint(v[0] == z * z)
    cs.add_constraint(v[1] == z * z)
    cs.add_constraint(v[2] == v[1] * x)
    cs.add_constraint(v[3] == v[0] * 2 * 3)
    cs.add_constraint(v[4] == 2 * v[1] * v[2] * 3)
    cs.add_constraint(v[5] == 2 * v[3] - v[4])
    cs.add_constraint(v[6] == 2 + v[5] + 3)
    cs.add_constraint(y == v[6] + v[4] + 1337)
    cs.set_public(y)
    cs.set_public(z)
    plonkish = front.Plonkish(cs, curve)
    plonkish.compile()
    pub, priv = plonkish.generate_witness(plonkish.solve({"x": INPUT[curve]}))
    return plonkish, pub, priv


def power_circuit(front, curve):
    """The fixtures' circuit, out = inp^16 (public out), inp = 3."""
    inp, out = front.Var("inp"), front.Var("out")
    v = [front.Var(f"v{i}") for i in range(15)]
    cs = front.ConstraintSystem(["inp"], ["out"], FIELDS[curve])
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, 15):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[14])
    cs.set_public(out)
    plonkish = front.Plonkish(cs, curve)
    plonkish.compile()
    pub, priv = plonkish.generate_witness(plonkish.solve({"inp": 3}))
    return plonkish, pub, priv


def blinds_for(curve):
    rng = random.Random(f"blinds-{curve}")
    return [1 + rng.randrange(FIELDS[curve] - 1) for _ in range(11)]


@pytest.fixture(scope="module", params=CURVES)
def ref(request):
    """One JAX-package setup (seeded) and host proof under fixed blinds, and
    the port's setup under the same seed."""
    curve = request.param
    saved = jax_protocol.get_random_int, torch_protocol.get_random_int
    jax_protocol.get_random_int = det_random_int(f"setup-{curve}")
    torch_protocol.get_random_int = det_random_int(f"setup-{curve}")
    try:
        jp, jpub, jpriv = gate_circuit(jax_front, curve)
        jax_plonk = JaxPlonk(jp, curve)
        jax_plonk.setup()
        tp, pub, priv = gate_circuit(torch_front, curve)
        port = Plonk(tp, curve, device="cpu")
        port.setup()
    finally:
        jax_protocol.get_random_int, torch_protocol.get_random_int = saved
    blinds = blinds_for(curve)
    want = jax_plonk._prove_with_blinding(jpub, jpriv, blinds, force_host=True)
    return {"curve": curve, "jax": jax_plonk, "port": port, "pub": pub, "priv": priv,
            "jpub": jpub, "jpriv": jpriv, "blinds": blinds, "want": want.to_bytes()}


def test_front_end_matches_jax(ref):
    """The copied Plonkish compiler gives the JAX package's selectors,
    permutation and witness."""
    jp, jpub, jpriv = gate_circuit(jax_front, ref["curve"])
    tp, pub, priv = gate_circuit(torch_front, ref["curve"])
    for name in ("qL", "qR", "qO", "qM", "qC", "permutation", "witness_map"):
        assert getattr(tp, name) == getattr(jp, name)
    assert (pub, priv) == (jpub, jpriv)
    assert tp.is_sat(pub, priv)


def test_setup_keys_equal_jax(ref):
    assert ref["port"].proving_key.to_bytes() == ref["jax"].proving_key.to_bytes()
    assert ref["port"].verifying_key.to_bytes() == ref["jax"].verifying_key.to_bytes()


@pytest.mark.parametrize("path", ["host", "device"])
def test_proof_equals_jax(ref, path, monkeypatch):
    port = ref["port"]
    if path == "device":
        monkeypatch.setattr(torch_config, "PLONK_DEVICE_THRESHOLD", 1)
        assert port._device_prover() is not None
    proof = port._prove_with_blinding(ref["pub"], ref["priv"], ref["blinds"],
                                      force_host=path == "host")
    assert proof.to_bytes() == ref["want"]
    assert port.verify(Proof.from_bytes(proof.to_bytes(), ref["curve"]), ref["pub"])


def test_device_path_under_mxu_flag_equals_jax(ref, monkeypatch):
    """ZKSNAKE_MXU_MONTMUL=1 with the lane threshold lowered: the device
    path's flat products go to K3's plain version and its commitments'
    bucket sums to K2m's; the proof is the same."""
    monkeypatch.setattr(torch_config, "PLONK_DEVICE_THRESHOLD", 1)
    monkeypatch.setenv("ZKSNAKE_MXU_MONTMUL", "1")
    monkeypatch.setattr(torch_field, "MXU_MIN_LANES", 16)
    calls = {"bucket": 0, "mont": 0}
    orig_bucket, orig_mont = kernels.bucket_accumulate_mma, kernels.mont_mul_mma

    def bucket_spy(*args):
        calls["bucket"] += 1
        return orig_bucket(*args)

    def mont_spy(*args):
        calls["mont"] += 1
        return orig_mont(*args)

    monkeypatch.setattr(kernels, "bucket_accumulate_mma", bucket_spy)
    monkeypatch.setattr(kernels, "mont_mul_mma", mont_spy)
    proof = ref["port"]._prove_with_blinding(ref["pub"], ref["priv"], ref["blinds"])
    assert proof.to_bytes() == ref["want"]
    # one K2m call a commitment pass: a pass's MSMs (9 in 4 passes) share
    # the SRS, so msm_pippenger_many sorts and accumulates them together
    assert calls["bucket"] == 4 and calls["mont"] > 0


def test_jax_key_carried_across_gives_same_proof(ref, monkeypatch):
    """The JAX package's proving and verifying keys, read as bytes by the
    port's ProvingKey/VerifyingKey.from_bytes, prove (fused device path) and
    verify as the JAX package does."""
    curve = ref["curve"]
    tp, pub, priv = gate_circuit(torch_front, curve)
    other = Plonk(tp, curve, device="cpu")
    other.proving_key = ProvingKey.from_bytes(ref["jax"].proving_key.to_bytes(), curve)
    other.verifying_key = VerifyingKey.from_bytes(ref["jax"].verifying_key.to_bytes(), curve)
    monkeypatch.setattr(torch_config, "PLONK_DEVICE_THRESHOLD", 1)
    proof = other._prove_with_blinding(pub, priv, ref["blinds"])
    assert proof.to_bytes() == ref["want"]
    assert other.verify(proof, pub)


def test_external_tau_resume_equals_jax(ref):
    """setup(g1_tau=, g2_tau=) resumes from an earlier ceremony's powers of
    tau (plonk/protocol.py's external-SRS path; tests/test_plonk.py:88 in
    the JAX package): from the reference setup's SRS the port derives the
    JAX package's keys and, under the same blinds, its proof."""
    curve = ref["curve"]
    tp, pub, priv = gate_circuit(torch_front, curve)
    plonk = Plonk(tp, curve, device="cpu")
    plonk.setup(g1_tau=ref["port"].G1_tau, g2_tau=ref["port"].G2_tau)
    assert plonk.G1_tau == ref["port"].G1_tau
    assert plonk.proving_key.to_bytes() == ref["jax"].proving_key.to_bytes()
    assert plonk.verifying_key.to_bytes() == ref["jax"].verifying_key.to_bytes()
    proof = plonk._prove_with_blinding(pub, priv, ref["blinds"], force_host=True)
    assert proof.to_bytes() == ref["want"]
    assert plonk.verify(proof, pub)


def test_external_tau_validation_as_jax(ref):
    """An SRS of fewer than n + 6 powers, or a g1_tau without its g2_tau,
    raises ValueError in both packages (tests/test_plonk.py:108)."""
    curve = ref["curve"]
    for front, cls, srs in ((torch_front, lambda c: Plonk(c, curve, device="cpu"), ref["port"]),
                            (jax_front, lambda c: JaxPlonk(c, curve), ref["jax"])):
        circuit, _, _ = gate_circuit(front, curve)
        with pytest.raises(ValueError, match="too big"):
            cls(circuit).setup(g1_tau=srs.G1_tau[: circuit.length + 5], g2_tau=srs.G2_tau)
        with pytest.raises(ValueError, match="g2_tau is required"):
            cls(circuit).setup(g1_tau=srs.G1_tau)


def test_wrong_field_raises_as_jax(ref):
    """A Plonkish compiled for one curve's field, handed to Plonk with the
    other curve, raises ValueError in both packages (PARITY.md #6)."""
    other = {"BN254": "BLS12_381", "BLS12_381": "BN254"}[ref["curve"]]
    tp, _, _ = gate_circuit(torch_front, ref["curve"])
    jp, _, _ = gate_circuit(jax_front, ref["curve"])
    with pytest.raises(ValueError, match="different curve"):
        Plonk(tp, other, device="cpu")
    with pytest.raises(ValueError, match="different curve"):
        JaxPlonk(jp, other)


def test_verify_rejects_tampered_proof(ref):
    curve = ref["curve"]
    proof = Proof.from_bytes(ref["want"], curve)
    assert ref["port"].verify(proof, ref["pub"])
    proof.zeta_a = (proof.zeta_a + 1) % FIELDS[curve]
    assert not ref["port"].verify(proof, ref["pub"])
    pub = dict(ref["pub"])
    key = next(iter(pub))
    pub[key] = (pub[key] + 1) % FIELDS[curve]
    assert not ref["port"].verify(Proof.from_bytes(ref["want"], curve), pub)


@pytest.mark.parametrize("curve", CURVES)
def test_fixture_proof_reproduced(curve, monkeypatch):
    """tests/fixtures/plonk_{curve}.hex under the fixtures' stream."""
    monkeypatch.setattr(torch_protocol, "get_random_int", det_random_int(f"plonk-{curve}"))
    plonkish, pub, priv = power_circuit(torch_front, curve)
    plonk = Plonk(plonkish, curve, device="cpu")
    plonk.setup()
    proof = plonk.prove(pub, priv)
    want = (REPO / "tests" / "fixtures" / f"plonk_{curve.lower()}.hex").read_text().strip()
    assert proof.to_bytes() == bytes.fromhex(want)
    assert plonk.verify(proof, pub)


def test_cuda_device_is_never_swapped_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    plonkish, _, _ = power_circuit(torch_front, "BN254")
    with pytest.raises(RuntimeError, match="CUDA"):
        Plonk(plonkish, "BN254", device="cuda")


@pytest.mark.parametrize("n", [1, 5, 64])
@pytest.mark.parametrize("curve", CURVES)
def test_prefix_sum_mod_matches_jax(curve, n):
    fs_t = torch_field.FieldSpec.get(FIELDS[curve])
    fs_j = jax_field.FieldSpec.get(FIELDS[curve])
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(40), "little") % fs_t.p for _ in range(2 * n)]
    vals[0] = fs_t.p - 1
    x = fs_t.to_mont_host(vals).reshape(fs_t.nl, 2, n)
    got = torch_field.prefix_sum_mod(fs_t, torch.from_numpy(x.astype(np.int32)))
    want = jax_field.prefix_sum_mod(fs_j, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
    # and the values are the prefix sums
    row = fs_t.from_mont_host(got[:, 0].contiguous())
    assert row == [sum(vals[: i + 1]) % fs_t.p for i in range(n)]
