"""EIP-7594 cells and cell proofs on the port (commitment/polynomial/
kzg_cells.py), eager torch on the CPU at a small size: blobs of 16, an
extension of 32, cells of 4 (8 cells), 2 blobs a request.

The port's batched call is held to the benchmark's plain reference
(portbench/reference/kzg_cells.py), and the reference to the spec written
out literally here: `blob_to_kzg_commitment` as the Lagrange lincomb of the
bit-reversed blob, `coset_for_cell`, `vanishing_polynomialcoeff`,
`divide_polynomialcoeff` by long division and `g1_lincomb` over the
monomial SRS (consensus-specs, deneb polynomial-commitments.md and fulu
polynomial-commitments-sampling.md).
"""

import pytest
import torch

from portbench import harness, seeds
from portbench.protocols import kzg_cells as adapter
from portbench.reference import bls12_381 as ref
from portbench.reference.kzg_cells import KZGCellsReference
from zksnake_tpu_torch import BLS12_381_SCALAR_FIELD, metrics
from zksnake_tpu_torch.backend.limbs import ints_to_limbs
from zksnake_tpu_torch.backend.ntt import Domain
from zksnake_tpu_torch.curves.params import BLS12_381

import torch_support  # noqa: F401  (torch on one thread)

R = BLS12_381_SCALAR_FIELD
SEED = 2**34 + 11
K = 3  # the request the tests prove
CONFIG = {"curve": "BLS12_381", "blobs_per_request": 2, "field_elements_per_blob": 16,
          "field_elements_per_ext_blob": 32, "field_elements_per_cell": 4, "cells_per_ext_blob": 8}


@pytest.fixture(scope="module")
def proved():
    """(protocol, request K's output, metrics.report() of its call)."""
    proto = adapter.Protocol(CONFIG, SEED, torch.device("cpu"))
    proto.setup()
    inputs = proto.request(K)
    metrics.enable()
    metrics.reset()
    try:
        out = proto.prove(inputs)
        rep = metrics.report()
    finally:
        metrics.enable(False)
        metrics.reset()
    yield proto, out, rep
    proto.close()


def test_batched_call_equals_the_reference(proved):
    proto, out, _ = proved
    got = harness.check(proto, None, [(K, 1.0, out)], SEED)
    assert got == {"checked": 1, "mismatched": 0, "wrong": []}
    commitments, cells, proofs = out
    assert len(commitments) == 2 and [len(p) for p in proofs] == [8, 8]
    assert tuple(cells.shape) == (16, 2, 8, 4) and cells.dtype == torch.int32


def test_spans_and_msm_points(proved):
    _, _, rep = proved
    for span in adapter.TOP_PHASES:
        assert rep[span]["calls"] == 1
    # per blob: the commitment over 16 points, 8 proofs over 16 - 4
    assert rep["kzg.cells.msm"]["msm_points"] == 2 * (16 + 8 * 12)
    # every MSM over the SRS's fixed-base table: one window each
    assert rep["kzg.cells.msm"]["msm_windows"] == 2 * 9
    assert rep["kzg.cells.msm"]["msm_fixed_points"] == rep["kzg.cells.msm"]["msm_points"]
    assert rep["msm.reduce"]["calls"] == 1  # every MSM of the call in one pass


def test_elements_order_and_a_planted_fault(proved):
    proto, out, _ = proved
    commitments, cells, proofs = out
    elems = proto.elements(out)
    names = [name for name, _ in elems]
    want = []
    for b in range(2):
        want += ([f"blob{b}.commitment"] + [f"blob{b}.cell{i}" for i in range(8)]
                 + [f"blob{b}.proof{i}" for i in range(8)])
    assert names == want
    fr = proto.kzg.fr
    assert elems[8][1] == tuple(fr.raw_from_host(cells[:, 0, 7]))  # blob0.cell7
    assert elems[-1][1] == (proofs[1][7].x, proofs[1][7].y)
    # one proof's scalar off by one: that proof, and nothing else, differs
    bad = [list(p) for p in proofs]
    bad[1][5] = bad[1][5] + proto.kzg.E.G1()
    got = harness.check(proto, None, [(K, 1.0, (commitments, cells, bad))], SEED)
    assert got["mismatched"] == 1 and got["wrong"] == [(K, ["blob1.proof5"])]
    # the control (blobs read in natural order) changes every element
    ctl = harness.check(proto, None, [(K, 1.0, out)], SEED, control=True)
    assert ctl["mismatched"] == len(elems)


def test_non_canonical_blobs_are_refused(proved):
    proto, _, _ = proved
    blobs = adapter.blobs(SEED, 0, 2, 16)
    blobs[1][3] = R
    with pytest.raises(ValueError, match="canonical"):
        proto.kzg.compute_cells_and_kzg_proofs(blobs)
    fr = proto.kzg.fr
    flat = ints_to_limbs([v for b in blobs for v in b], fr.nl).T  # r kept as it is
    limbs = fr.to_device(flat, "cpu").view(fr.nl, 2, -1)
    with pytest.raises(ValueError, match="canonical"):
        proto.kzg.compute_cells_and_kzg_proofs(limbs)


@pytest.mark.parametrize("n", [4096, 8192])
def test_roots_of_unity_are_the_spec_s(n):
    w = pow(7, (R - 1) // n, R)
    assert Domain.get(BLS12_381, n).omega == w
    assert pow(w, n // 2, R) == R - 1


# ---- the spec, written out (consensus-specs names) ----


def bit_reversal_permutation(seq):
    return [seq[int(format(i, f"0{len(seq).bit_length() - 1}b")[::-1], 2)]
            for i in range(len(seq))]


def compute_roots_of_unity(order):
    w = pow(7, (R - 1) // order, R)
    return [pow(w, i, R) for i in range(order)]


def coset_for_cell(i, ext, cell):
    return bit_reversal_permutation(compute_roots_of_unity(ext))[cell * i:cell * (i + 1)]


def multiply_polynomialcoeff(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % R
    return out


def vanishing_polynomialcoeff(xs):
    p = [1]
    for x in xs:
        p = multiply_polynomialcoeff(p, [-x % R, 1])
    return p


def divide_polynomialcoeff(a, b):
    a = list(a)
    o = []
    apos, bpos = len(a) - 1, len(b) - 1
    diff = apos - bpos
    while diff >= 0:
        quot = a[apos] * pow(b[bpos], -1, R) % R
        o.insert(0, quot)
        for i in range(bpos, -1, -1):
            a[diff + i] = (a[diff + i] - b[i] * quot) % R
        apos -= 1
        diff -= 1
    return o


def evaluate_polynomialcoeff(p, z):
    return sum(c * pow(z, k, R) for k, c in enumerate(p)) % R


def g1_lincomb(points, scalars):
    acc = None
    for pt, s in zip(points, scalars):
        acc = ref.add(acc, ref.mul(pt, s))
    return acc


def test_reference_equals_the_spec_written_out():
    n, ext, cell = 16, 32, 4
    tau = seeds.protocol_draws(SEED, R, 1)[0]
    monomial = [ref.g1_mul(pow(tau, k, R)) for k in range(n)]
    roots = compute_roots_of_unity(n)
    # [L_j(tau)]G1 over the roots in natural order, as the setup lists them
    lagrange = [ref.g1_mul((pow(tau, n, R) - 1) * pow(n, -1, R) * w
                           * pow(tau - w, -1, R)) for w in roots]
    reference = KZGCellsReference(tau, n, ext, cell)
    for blob in adapter.blobs(SEED, K, 2, n):
        commitment, cells, proofs = reference.blob(blob)
        assert commitment == g1_lincomb(bit_reversal_permutation(lagrange), blob)
        # the coefficients by the inverse DFT written out, of the blob read
        # as p(roots_brp[j]) = blob[j]
        evals = bit_reversal_permutation(blob)
        coeff = [sum(e * pow(roots[(j * k) % n], -1, R) for j, e in enumerate(evals))
                 * pow(n, -1, R) % R for k in range(n)]
        for i in range(ext // cell):
            coset = coset_for_cell(i, ext, cell)
            assert cells[i] == [evaluate_polynomialcoeff(coeff, z) for z in coset]
            quotient = divide_polynomialcoeff(coeff, vanishing_polynomialcoeff(coset))
            assert len(quotient) == n - cell
            assert proofs[i] == g1_lincomb(monomial[:len(quotient)], quotient)
