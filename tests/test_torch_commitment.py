"""KZG, IPA-PCS (single and multi-point) and Merkle on the PyTorch port
against the JAX package, at the sizes of tests/test_commitment.py.

Both packages' commitment modules draw their randomness (KZG's tau, the
IPA's masks and blinds) from one deterministic stream each, started from the
same seed, so the SRS, every commitment and every proof must be equal byte
for byte (exact). The port runs on device="cpu"; its setup's batch mul and
its MSMs are above their dispatch thresholds here only where a test lowers
them. A JAX-made SRS and basis, carried across as bytes by
backend/state.py, commit and open the same in the port.
"""

import random

import pytest
import torch

from zksnake_tpu.commitment.polynomial import IPA as JaxIPA
from zksnake_tpu.commitment.polynomial import KZG as JaxKZG
from zksnake_tpu.commitment.polynomial import MultiOpeningQuery as JaxQuery
from zksnake_tpu.commitment.polynomial import ipa as jax_ipa
from zksnake_tpu.commitment.polynomial import kzg as jax_kzg
from zksnake_tpu.commitment.vector import Merkle as JaxMerkle
from zksnake_tpu.polynomial import Polynomial as JaxPolynomial
from zksnake_tpu_torch.backend import config as torch_config
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend.state import points_from_jax
from zksnake_tpu_torch.commitment.polynomial import IPA, KZG, MultiOpeningQuery
from zksnake_tpu_torch.commitment.polynomial import ipa as torch_ipa
from zksnake_tpu_torch.commitment.polynomial import kzg as torch_kzg
from zksnake_tpu_torch.commitment.vector import Merkle
from zksnake_tpu_torch.polynomial import Polynomial

from torch_support import CURVES, stream

POLYS = ([1, 3, 3, 7], [1, 2, 3, 4], [1, 2, 3, 0])


def as_bytes(x):
    """Points as their compressed bytes, ints as ints, lists element-wise."""
    if isinstance(x, (list, tuple)):
        return [as_bytes(v) for v in x]
    if isinstance(x, int):
        return x
    return bytes(x.to_bytes())


@pytest.mark.parametrize("group", CURVES)
def test_kzg_matches_jax(monkeypatch, group):
    stream(monkeypatch, f"kzg-{group}", jax_kzg, torch_kzg)
    ref, kzg = JaxKZG(4, group), KZG(4, group, device="cpu")
    ref.setup()
    kzg.setup()
    assert as_bytes(kzg.G1_tau) == as_bytes(ref.G1_tau)
    assert as_bytes(kzg.G2_tau) == as_bytes(ref.G2_tau)
    point = random.Random(group).randrange(1, kzg.order)
    poly = Polynomial(list(POLYS[0]), kzg.order)
    commitment = kzg.commit(poly)
    proof, evaluation = kzg.open(poly, point)
    jpoly = JaxPolynomial(list(POLYS[0]), ref.order)
    assert as_bytes(commitment) == as_bytes(ref.commit(jpoly))
    assert as_bytes([proof, evaluation]) == as_bytes(list(ref.open(jpoly, point)))
    assert kzg.verify(commitment, proof, point, evaluation)
    assert not kzg.verify(commitment, proof, point, (evaluation + 1) % kzg.order)


def test_kzg_srs_carried_from_jax(monkeypatch):
    """A JAX-made SRS, as bytes through points_from_jax, commits and opens
    the same in the port and verifies there."""
    stream(monkeypatch, "kzg-srs", jax_kzg)
    ref = JaxKZG(7, "BN254")
    ref.setup()
    kzg = KZG(7, "BN254", device="cpu")
    *kzg.G1_tau, kzg.G2_tau = points_from_jax(
        "BN254", [p.to_bytes() for p in ref.G1_tau + [ref.G2_tau]])
    kzg.is_setup = True
    coeffs = [random.Random(i).randrange(kzg.order) for i in range(8)]
    poly = Polynomial(coeffs, kzg.order)
    jpoly = JaxPolynomial(coeffs, ref.order)
    assert as_bytes(kzg.commit(poly)) == as_bytes(ref.commit(jpoly))
    proof, y = kzg.open(poly, 5)
    assert as_bytes([proof, y]) == as_bytes(list(ref.open(jpoly, 5)))
    assert kzg.verify(kzg.commit(poly), proof, 5, y)


def multi_query(scheme, query_cls, poly_cls, blinds=None):
    """tests/test_commitment.py's query: three polynomials, opened at x = 123
    (all three) and y = 1234 (the last two)."""
    polys = [poly_cls(list(c), scheme.order) for c in POLYS]
    query = query_cls()
    for i, poly in enumerate(polys):
        if blinds is None:
            query.add_polynomial(poly, scheme.commit(poly))
        else:
            query.add_polynomial(poly, scheme.commit(poly, blinds[i]), blinds[i])
    for i, point in ((0, 123), (1, 123), (1, 1234), (2, 123), (2, 1234)):
        query.prover_query(polys[i], point)
    return query


def test_multi_kzg_matches_jax(monkeypatch):
    stream(monkeypatch, "multi-kzg", jax_kzg, torch_kzg)
    ref, kzg = JaxKZG(4, "BN254"), KZG(4, "BN254", device="cpu")
    ref.setup()
    kzg.setup()
    proof, verifier_query = kzg.multi_open(multi_query(kzg, MultiOpeningQuery, Polynomial))
    want, _ = ref.multi_open(multi_query(ref, JaxQuery, JaxPolynomial))
    assert as_bytes(proof) == as_bytes(want)
    assert kzg.multi_verify(verifier_query, proof)
    bad = list(proof)
    bad[1] = (bad[1] + 1) % kzg.order
    assert not kzg.multi_verify(verifier_query, bad)


@pytest.mark.parametrize("group", CURVES)
def test_ipa_pcs_matches_jax(monkeypatch, group):
    stream(monkeypatch, f"ipa-{group}", jax_ipa, torch_ipa)
    ref, ipa = JaxIPA(4, group), IPA(4, group, device="cpu")
    ref.setup()
    ipa.setup()
    assert as_bytes(ipa.G + [ipa.H]) == as_bytes(ref.G + [ref.H])
    rng = random.Random(group)
    blinding, point = rng.randrange(1, ipa.order), rng.randrange(1, ipa.order)
    coeffs = [1, 2, 22, 7]
    poly, jpoly = Polynomial(coeffs, ipa.order), JaxPolynomial(coeffs, ref.order)
    commitment = ipa.commit(poly, blinding)
    assert as_bytes(commitment) == as_bytes(ref.commit(jpoly, blinding))
    proof, evaluation = ipa.open(poly, point, commitment, blinding)
    want, want_eval = ref.open(jpoly, point, ref.commit(jpoly, blinding), blinding)
    assert as_bytes(proof) == as_bytes(want) and evaluation == want_eval
    assert ipa.verify(commitment, proof, point, evaluation)
    assert not ipa.verify(commitment, proof, point, (evaluation + 1) % ipa.order)


def test_ipa_basis_carried_from_jax(monkeypatch):
    """The JAX package's IPA basis, as bytes through points_from_jax, equals
    the port's own and commits the same."""
    ref = JaxIPA(8, "BLS12_381")
    ref.setup(seed=b"carried")
    ipa = IPA(8, "BLS12_381", device="cpu")
    *ipa.G, ipa.H = points_from_jax("BLS12_381", [p.to_bytes() for p in ref.G + [ref.H]])
    ipa.n, ipa.is_setup = ref.n, True
    own = IPA(8, "BLS12_381", device="cpu")
    own.setup(seed=b"carried")
    assert as_bytes(ipa.G + [ipa.H]) == as_bytes(own.G + [own.H])
    coeffs = list(range(3, 11))
    assert as_bytes(ipa.commit(Polynomial(coeffs, ipa.order), 9)) == \
        as_bytes(ref.commit(JaxPolynomial(coeffs, ref.order), 9))


def test_multi_ipa_pcs_matches_jax(monkeypatch):
    stream(monkeypatch, "multi-ipa", jax_ipa, torch_ipa)
    ref, ipa = JaxIPA(4, "BN254"), IPA(4, "BN254", device="cpu")
    ref.setup()
    ipa.setup()
    rng = random.Random("blinds")
    blinds = [rng.randrange(1, ipa.order) for _ in POLYS]
    proof, verifier_query = ipa.multi_open(
        multi_query(ipa, MultiOpeningQuery, Polynomial, blinds))
    want, _ = ref.multi_open(multi_query(ref, JaxQuery, JaxPolynomial, blinds))
    assert as_bytes(proof) == as_bytes(want)
    assert ipa.multi_verify(verifier_query, proof)
    bad = list(proof)
    bad[1] = (bad[1] + 1) % ipa.order
    assert not ipa.multi_verify(verifier_query, bad)


def test_kzg_device_dispatch_matches_host(monkeypatch):
    """With MSM_DEVICE_THRESHOLD and BATCHMUL_DEVICE_THRESHOLD lowered, the
    setup's fixed-base batch mul and the commit and open MSMs take the
    port's device path (K1 and K2's plain versions here, counted by no
    launch on the CPU) and give the host path's bytes."""
    stream(monkeypatch, "kzg-dispatch", torch_kzg)
    host = KZG(15, "BN254", device="cpu")
    host.setup()
    stream(monkeypatch, "kzg-dispatch", torch_kzg)
    monkeypatch.setattr(torch_config, "MSM_DEVICE_THRESHOLD", 1)
    monkeypatch.setattr(torch_config, "BATCHMUL_DEVICE_THRESHOLD", 1)
    dev = KZG(15, "BN254", device="cpu")
    dev.setup()
    assert as_bytes(dev.G1_tau) == as_bytes(host.G1_tau)
    coeffs = [random.Random(i).randrange(dev.order) for i in range(16)]
    poly = Polynomial(coeffs, dev.order)
    kernels.reset_launches()
    commitment = dev.commit(poly)
    proof, y = dev.open(poly, 77)
    assert kernels.LAUNCHES["mont_mul"] == 0  # plain versions on the CPU
    monkeypatch.setattr(torch_config, "MSM_DEVICE_THRESHOLD", 1 << 30)
    assert as_bytes([commitment, proof, y]) == as_bytes([host.commit(poly), *host.open(poly, 77)])
    assert dev.verify(commitment, proof, 77, y)


def test_merkle_matches_jax():
    mine, ref = Merkle(), JaxMerkle()
    for n in (1, 2, 7, 8):
        vector = [bytes([i]) * 8 for i in range(n)]
        commitment = mine.commit(vector)
        assert commitment == ref.commit(vector)
        for idx in range(n):
            proof = mine.open(vector, idx)
            assert proof == ref.open(vector, idx)
            assert mine.verify(commitment, proof, idx, vector[idx])
        assert not mine.verify(commitment, mine.open(vector, 0), 0, b"junkjunk")


def test_cuda_device_is_never_swapped_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for scheme in (KZG, IPA):
        with pytest.raises(RuntimeError, match="CUDA"):
            scheme(4, "BN254")
