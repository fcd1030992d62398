"""Multilinear polynomials and sumcheck on the PyTorch port against the JAX
package, over BN254 and BLS12-381.

The port runs on device="cpu" here, where backend/mle.py's fold runs the
plain versions of its kernels. Inputs are made from a seed, the same for
both packages, and compared as ints: the tolerance is exact. Each package's
MLE_DEVICE_THRESHOLD is patched to 1 to force its device fold (the JAX
package's also needs jax_available, which the test environment turns off)
and to 2^62 to force its host walk, as tests/test_backend_device.py does.
"""

import random

import numpy as np
import pytest
import torch

from zksnake_tpu.backend import config as jax_config
from zksnake_tpu.backend import mle as jax_mle
from zksnake_tpu.constant import BN254_SCALAR_FIELD
from zksnake_tpu.polynomial import MultilinearPolynomial as JaxMLE
from zksnake_tpu.subprotocol.sumcheck import Sumcheck as JaxSumcheck
from zksnake_tpu_torch.backend import config as torch_config
from zksnake_tpu_torch.backend import mle as torch_mle
from zksnake_tpu_torch.polynomial import MultilinearPolynomial
from zksnake_tpu_torch.subprotocol.sumcheck import Sumcheck

from torch_support import CURVES, FIELDS

HOST = 1 << 62


def entries(p, nv, seed, skip=3):
    """(index, value) pairs of a table with every `skip`-th entry zero."""
    rng = random.Random(seed)
    return [(i, rng.randrange(p)) for i in range(1 << nv) if i % skip]


def force(monkeypatch, path):
    """Both packages' MLE dispatch on `path`: "fold" (the device fold) or
    "host" (the dict walk)."""
    threshold = 1 if path == "fold" else HOST
    monkeypatch.setattr(torch_config, "MLE_DEVICE_THRESHOLD", threshold)
    monkeypatch.setattr(jax_config, "MLE_DEVICE_THRESHOLD", threshold)
    monkeypatch.setattr(jax_config, "jax_available", lambda: path == "fold")


@pytest.mark.parametrize("path", ["host", "fold"])
@pytest.mark.parametrize("curve", CURVES)
def test_partial_evaluate_matches_jax(monkeypatch, curve, path):
    p = FIELDS[curve]
    nv = 6
    ev = entries(p, nv, f"pe-{curve}")
    points = [random.Random(f"pts-{curve}").randrange(p) for _ in range(3)]
    full = points + [7, 11, 13]
    # the JAX package's fold is compiled once, for BN254's partial
    # evaluation; its host walk equals it (tests/test_backend_device.py)
    force(monkeypatch, "host")
    want_value = JaxMLE(nv, ev, p).evaluate(full)
    force(monkeypatch, path if curve == "BN254" else "host")
    want = JaxMLE(nv, ev, p).partial_evaluate(points)
    force(monkeypatch, path)
    mine = MultilinearPolynomial(nv, ev, p, device="cpu")
    rounds = torch_mle.SUMCHECK_DEVICE_ROUNDS
    got = mine.partial_evaluate(points)
    assert (got.num_vars, got.evals) == (want.num_vars, want.evals)
    assert mine.evaluate(full) == want_value
    assert torch_mle.SUMCHECK_DEVICE_ROUNDS == rounds  # a fold is not a round


def test_fold_dispatch_follows_the_jax_rules(monkeypatch):
    """Size >= MLE_DEVICE_THRESHOLD, nnz * 16 >= size, size <= 2^24, k > 0."""
    monkeypatch.setattr(torch_config, "MLE_DEVICE_THRESHOLD", 4096)
    monkeypatch.setattr(jax_config, "MLE_DEVICE_THRESHOLD", 4096)
    monkeypatch.setattr(jax_config, "jax_available", lambda: True)
    cases = [(12, 4096, 1), (11, 2048, 1), (12, 255, 1), (12, 256, 1), (12, 4096, 0),
             (25, 1 << 25, 1), (24, 1 << 24, 3)]
    for nv, nnz, k in cases:
        assert torch_mle.should_use_device(nv, nnz, k, "cpu") == \
            jax_mle.should_use_device(nv, nnz, k), (nv, nnz, k)


@pytest.mark.parametrize("curve", CURVES)
def test_mle_operations_match_jax(curve):
    p = FIELDS[curve]
    nv = 4
    a, b = entries(p, nv, f"a-{curve}"), entries(p, nv, f"b-{curve}", skip=2)
    ma, mb = MultilinearPolynomial(nv, a, p, device="cpu"), MultilinearPolynomial(nv, b, p, "cpu")
    ja, jb = JaxMLE(nv, a, p), JaxMLE(nv, b, p)
    assert ma.to_evaluations() == ja.to_evaluations()
    assert ma.to_coefficients() == ja.to_coefficients()
    assert ma.swap(0, 2, 2).evals == ja.swap(0, 2, 2).evals
    assert ma.swap(1, 1, 3).evals == ja.swap(1, 1, 3).evals
    perm = [2, 0, 3, 1]
    assert ma.permute_evaluations(perm).evals == ja.permute_evaluations(perm).evals
    assert (ma + mb).evals == (ja + jb).evals
    assert (ma - mb).evals == (ja - jb).evals
    assert (ma - ma).evals == {}
    assert ma + MultilinearPolynomial(0, [], p, "cpu") == ma
    pts = [3, 5, 7, 11]
    assert ma.evaluate(pts) == ja.evaluate(pts)
    assert str(ma) == str(ja)
    with pytest.raises(ValueError):
        ma.evaluate(pts[:3])


def test_device_sumcheck_table_matches_jax(monkeypatch):
    """backend/mle.py's DeviceSumcheckTable round by round against the JAX
    one at nv = 7 (BN254): the same half-sums every round, and the same
    folded table under the same challenges."""
    p = BN254_SCALAR_FIELD
    nv = 7
    ev = dict(entries(p, nv, "table", skip=5))
    mine = torch_mle.DeviceSumcheckTable(p, nv, ev, torch.device("cpu"))
    ref = jax_mle.DeviceSumcheckTable(p, nv, ev)
    rng = random.Random("challenges")
    rounds = torch_mle.SUMCHECK_DEVICE_ROUNDS
    for _ in range(nv):
        s = mine.round_sums()
        assert s == ref.round_sums()
        r = rng.randrange(p)
        mine.fold(r)
        ref.fold(r)
    assert torch_mle.SUMCHECK_DEVICE_ROUNDS == rounds + nv
    assert tuple(mine._table.shape) == (mine.fs.nl, 1)
    assert mine.fs.from_mont_host(mine._table) == mine.fs.from_mont_host(np.asarray(ref._table))


@pytest.mark.parametrize("path", ["host", "fold"])
@pytest.mark.parametrize("curve", CURVES)
def test_sumcheck_matches_jax(monkeypatch, curve, path):
    """Sumcheck.prove's claim, round polynomials and challenges equal the
    JAX package's host path (which its own tests hold equal to its device
    path), on the port's host path and on its device-resident driver; the
    driver runs one round a variable; verify accepts and rejects."""
    p = FIELDS[curve]
    nv = 7
    poly_ev = entries(p, nv, f"sc-{curve}", skip=5)
    force(monkeypatch, "host")
    want_claim, want_proof, want_chal = JaxSumcheck(nv, p).prove(JaxMLE(nv, poly_ev, p))
    force(monkeypatch, path)
    poly = MultilinearPolynomial(nv, poly_ev, p, device="cpu")
    sc = Sumcheck(nv, p, device="cpu")
    rounds = torch_mle.SUMCHECK_DEVICE_ROUNDS
    claim, proof, chal = sc.prove(poly)
    assert torch_mle.SUMCHECK_DEVICE_ROUNDS == rounds + (nv if path == "fold" else 0)
    assert claim == want_claim == sum(v for _, v in poly_ev) % p
    assert chal == want_chal
    assert [u.coeffs() for u in proof] == [u.coeffs() for u in want_proof]
    assert sc.verify(claim, proof, 3, mlpoly=poly) == chal
    assert sc.verify((claim + 1) % p, proof, 3) is False


def test_sumcheck_small():
    """tests/test_gkr.py::test_sumcheck on the port, against the JAX one."""
    ev = [(5, 1), (6, 1), (7, 1)]
    g = MultilinearPolynomial(4, ev, BN254_SCALAR_FIELD, device="cpu")
    sumcheck = Sumcheck(g.num_vars, BN254_SCALAR_FIELD, device="cpu")
    sum_claim, proof, chal = sumcheck.prove(g)
    assert sumcheck.verify(sum_claim, proof, 1, mlpoly=g)
    ref_claim, ref_proof, ref_chal = JaxSumcheck(4, BN254_SCALAR_FIELD).prove(
        JaxMLE(4, ev, BN254_SCALAR_FIELD))
    assert (sum_claim, chal) == (ref_claim, ref_chal)
    assert [u.coeffs() for u in proof] == [u.coeffs() for u in ref_proof]


def test_cuda_device_is_never_swapped_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Sumcheck(4, BN254_SCALAR_FIELD)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultilinearPolynomial(4, [(1, 1)], BN254_SCALAR_FIELD)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_mle.should_use_device(12, 4096, 1, "cuda")
