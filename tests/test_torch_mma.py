"""K3, the Montgomery product with tensor-core reductions, against the JAX
package.

The port's plain version (kernels.mont_mul_mma_plain, the arithmetic of
csrc/montmul_mma.cu in torch) takes the same limbs, made from a numpy seed,
as zksnake_tpu.backend.mxu_field.mont_mul_mxu and the Pallas kernel it
replaces (pallas_field.mont_mul_pallas(variant="mxu"), in interpret mode as
tests/test_mxu_field.py runs it). Integer field arithmetic has no
tolerance: results must match limb for limb. BN254 Fr and Fq and BLS12-381
Fq, each with lanes 0, 1 and p - 1.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zksnake_tpu.backend import mxu_field
from zksnake_tpu.backend.field import FieldSpec as JaxFieldSpec
from zksnake_tpu.constant import BLS12_381_MODULUS, BN254_MODULUS, BN254_SCALAR_FIELD
from zksnake_tpu_torch.backend import field as tf
from zksnake_tpu_torch.backend import kernels

torch.set_num_threads(1)

FIELDS = {
    "bn254_fr": BN254_SCALAR_FIELD,
    "bn254_fq": BN254_MODULUS,
    "bls12_381_fq": BLS12_381_MODULUS,
}


def random_limbs(p, n, seed):
    """(nl, n) uint32 limbs of values < p; lanes 0, 1, 2 hold 0, 1, p - 1."""
    fs = JaxFieldSpec.get(p)
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(fs.nl, n), dtype=np.int64)
    limbs[-1] = rng.integers(0, int(fs.p_limbs[-1]), size=n)
    limbs[:, :3] = fs.raw_to_host([0, 1, p - 1])
    return limbs.astype(np.uint32)


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("name", FIELDS)
def test_reduction_mats_equal_jax(name):
    p = FIELDS[name]
    nl = tf.FieldSpec.get(p).nl
    for mine, ref in zip(kernels._reduction_mats(p, nl), mxu_field._reduction_mats(p, nl)):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("name", FIELDS)
def test_mma_plain_matches_jax_mxu(name):
    p = FIELDS[name]
    a = random_limbs(p, 97, 1)
    b = random_limbs(p, 97, 2)[:, ::-1].copy()
    fs = tf.FieldSpec.get(p)
    got = kernels.mont_mul_mma_plain(fs, torch.from_numpy(a.astype(np.int32)),
                                     torch.from_numpy(b.astype(np.int32)))
    same(mxu_field.mont_mul_mxu(JaxFieldSpec.get(p), jnp.asarray(a), jnp.asarray(b)), got)
    # and the same canonical product as K1's plain version
    assert torch.equal(got, kernels.mont_mul_plain(fs, torch.from_numpy(a.astype(np.int32)),
                                                   torch.from_numpy(b.astype(np.int32))))


def test_mma_plain_matches_pallas_mxu_kernel(monkeypatch):
    """Against the Pallas kernel K3 replaces, in interpret mode (two
    1024-lane blocks)."""
    monkeypatch.setenv("ZKSNAKE_PALLAS_INTERPRET", "1")
    from zksnake_tpu.backend import pallas_field

    p = BN254_MODULUS
    a = random_limbs(p, 2048, 5)
    b = random_limbs(p, 2048, 6)[:, ::-1].copy()
    want = pallas_field.mont_mul_pallas(JaxFieldSpec.get(p), jnp.asarray(a), jnp.asarray(b),
                                        variant="mxu")
    got = kernels.mont_mul_mma_plain(tf.FieldSpec.get(p), torch.from_numpy(a.astype(np.int32)),
                                     torch.from_numpy(b.astype(np.int32)))
    same(want, got)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_flag_routes_large_products_to_k3(flag, monkeypatch):
    """ZKSNAKE_MXU_MONTMUL=1 sends batches of at least MXU_MIN_LANES to the
    K3 wrapper, smaller ones to K1; unset, everything goes to K1."""
    monkeypatch.setenv("ZKSNAKE_MXU_MONTMUL", flag)
    monkeypatch.setattr(tf, "MXU_MIN_LANES", 64)
    calls = []
    for name in ("mont_mul", "mont_mul_mma"):
        def spy(fs_, x, y, _orig=getattr(kernels, name), _name=name):
            calls.append((_name, x.shape[1]))
            return _orig(fs_, x, y)

        monkeypatch.setattr(kernels, name, spy)
    fs = tf.FieldSpec.get(BN254_SCALAR_FIELD)
    a = torch.from_numpy(random_limbs(BN254_SCALAR_FIELD, 64, 7).astype(np.int32))
    big = tf.mont_mul(fs, a, a)
    small = tf.mont_mul(fs, a[:, :63], a[:, :63])
    assert calls == [("mont_mul_mma" if flag == "1" else "mont_mul", 64), ("mont_mul", 63)]
    assert torch.equal(big, kernels.mont_mul_plain(fs, a, a))
    assert torch.equal(small, big[:, :63])
