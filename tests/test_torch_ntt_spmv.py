"""NTT and SpMV of the PyTorch port against the JAX package and host ints.

- the port's Domain has the JAX package's omega (arkworks roots), and its
  four transforms (fft, ifft and the coset pair with offset = omega) equal
  zksnake_tpu.polynomial's host transforms at n = 2, 16, 256;
- segment_sum_field equals the JAX package's (run eagerly), and holds the
  high-fanout cases of tests/test_spmv.py against host bigints, past the
  2^16 terms per row where uint32 accumulation would overflow.
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zksnake_tpu import polynomial as host_poly
from zksnake_tpu.backend import ntt as jax_ntt
from zksnake_tpu.backend import spmv as jax_spmv
from zksnake_tpu.backend.field import FieldSpec as JaxFieldSpec
from zksnake_tpu.backend.field import mont_mul as jax_mont_mul
from zksnake_tpu.constant import BLS12_381_SCALAR_FIELD, BN254_SCALAR_FIELD
from zksnake_tpu.curves.params import CURVES as JAX_CURVES
from zksnake_tpu_torch import polynomial as port_poly
from zksnake_tpu_torch.backend import ntt as tntt
from zksnake_tpu_torch.curves.params import CURVES
from zksnake_tpu_torch.backend.field import FieldSpec, mont_mul
from zksnake_tpu_torch.backend.spmv import DeviceSparseMatrix, reduce_wide, segment_sum_field

import torch_support  # noqa: F401  (torch on one thread)

P = BN254_SCALAR_FIELD
KINDS = {
    "fft": host_poly.fft,
    "ifft": host_poly.ifft,
    "coset_fft": host_poly.coset_fft,
    "coset_ifft": host_poly.coset_ifft,
}


@pytest.mark.parametrize("n", [2, 16, 256])
@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_transforms_match_host(curve, n):
    params = CURVES[curve]
    dom = tntt.Domain.get(params, n)
    assert dom.omega == jax_ntt.Domain.get(JAX_CURVES[curve], n).omega
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(32), "little") % params.r for _ in range(n)]
    x = dom.fs.to_device(dom.fs.to_mont_host(vals), "cpu")
    for kind, host in KINDS.items():
        got = dom.fs.from_mont_host(tntt.transform(dom, x, kind))
        assert got == host(vals, params.r), kind
    assert tntt.transform_host(params, vals, n, "fft", "cpu") == host_poly.fft(vals, params.r)
    for kind, host in KINDS.items():  # the port's own host polynomial module
        assert getattr(port_poly, kind)(vals, params.r, device="cpu") == host(vals, params.r)


def _column(k, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(1, P) for _ in range(k)]
    vec = [rng.randrange(1, P) for _ in range(k)]
    return vals, vec


def test_segment_sum_matches_jax():
    rng = random.Random(5)
    n_row, n_col, nnz = 8, 5, 40
    trip = [(rng.randrange(n_row), rng.randrange(n_col), rng.randrange(P)) for _ in range(nnz)]
    vec = [rng.randrange(P) for _ in range(n_col)]
    jfs, tfs = JaxFieldSpec.get(P), FieldSpec.get(P)
    jm = jax_spmv.DeviceSparseMatrix(jfs, trip, n_row, n_col)
    tm = DeviceSparseMatrix.from_triplets(tfs, trip, n_row, n_col, "cpu")
    jv = jnp.asarray(jfs.to_mont_host(vec))
    tv = tfs.to_device(tfs.to_mont_host(vec), "cpu")
    want = jax_spmv.segment_sum_field(jfs, jax_mont_mul(jfs, jm.vals, jv[:, jm.cols]), jm.rows, n_row)
    got = segment_sum_field(tfs, mont_mul(tfs, tm.vals, tv[:, tm.cols]), tm.rows, n_row)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy().astype(np.int64))


@pytest.mark.parametrize("k", [17, 511, 4096, (1 << 16) + 77])
def test_high_fanout_segment_sum(k):
    """One row with k terms, against host bigints (k > 2^16: past the
    uint32 headroom the JAX package chunks around)."""
    fs = FieldSpec.get(P)
    vals, vec = _column(k, 1000 + k)
    mat = DeviceSparseMatrix.from_triplets(fs, [(0, i, v) for i, v in enumerate(vals)], 1, k, "cpu")
    v = fs.to_device(fs.to_mont_host(vec), "cpu")
    got = fs.from_mont_host(segment_sum_field(fs, mont_mul(fs, mat.vals, v[:, mat.cols]), mat.rows, 1))
    assert got == [sum(a * b for a, b in zip(vals, vec)) % P]


@pytest.mark.parametrize("p", [BN254_SCALAR_FIELD, BLS12_381_SCALAR_FIELD])
def test_reduce_wide_saturated_columns(p):
    """Columns at their largest allowed value: the worst-case excess."""
    fs = FieldSpec.get(p)
    for ncols, bits in ((fs.nl, 32), (fs.nl, 62), (2 * fs.nl + 1, 48)):
        top = (1 << bits) - 1
        c = torch.full((ncols, 3), top, dtype=torch.int64)
        got = fs.raw_from_host(reduce_wide(fs, c, bits))
        assert got == [sum(top << (16 * j) for j in range(ncols)) % p] * 3
