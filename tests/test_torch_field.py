"""Field arithmetic of the PyTorch port against the JAX package.

The same limbs, made from a numpy seed, go through zksnake_tpu.backend.field
(run eagerly on the CPU) and zksnake_tpu_torch.backend.field on
device="cpu", where mont_mul takes K1's plain version. Integer field
arithmetic has no tolerance: results must match limb for limb. K1's plain
version is also held against the Pallas kernel itself in interpret mode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zksnake_tpu.backend import field as jf
from zksnake_tpu.constant import (
    BLS12_381_MODULUS,
    BLS12_381_SCALAR_FIELD,
    BN254_MODULUS,
    BN254_SCALAR_FIELD,
)
from zksnake_tpu_torch.backend import field as tf
from zksnake_tpu_torch.backend import kernels

from torch_support import random_limbs, same

FIELDS = {
    "bn254_fr": BN254_SCALAR_FIELD,
    "bn254_fq": BN254_MODULUS,
    "bls12_381_fr": BLS12_381_SCALAR_FIELD,
    "bls12_381_fq": BLS12_381_MODULUS,
}


def both(arr):
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32))


@pytest.mark.parametrize("name", FIELDS)
def test_mont_mul_add_sub_neg_match_jax(name):
    p = FIELDS[name]
    jfs, tfs = jf.FieldSpec.get(p), tf.FieldSpec.get(p)
    a = random_limbs(p, 64, 1)
    b = random_limbs(p, 64, 2)[:, ::-1].copy()
    ja, ta = both(a)
    jb, tb = both(b)
    same(jf.mont_mul(jfs, ja, jb), tf.mont_mul(tfs, ta, tb))
    same(jf.mod_add(jfs, ja, jb), tf.mod_add(tfs, ta, tb))
    same(jf.mod_sub(jfs, ja, jb), tf.mod_sub(tfs, ta, tb))
    same(jf.mod_neg(jfs, ja), tf.mod_neg(tfs, ta))
    same(jf.to_mont(jfs, ja), tf.to_mont(tfs, ta))
    same(jf.from_mont(jfs, ja), tf.from_mont(tfs, ta))
    # broadcasting: an (nl, 1) operand against (nl, n)
    same(jf.mont_mul(jfs, ja, jb[:, :1]), tf.mont_mul(tfs, ta, tb[:, :1]))


def test_prefix_prod_and_batch_inverse_match_jax():
    """BN254 Fr, the prover's field (each JAX call compiles its fori_loops;
    the other fields are held against host integers below)."""
    p = BN254_SCALAR_FIELD
    jfs, tfs = jf.FieldSpec.get(p), tf.FieldSpec.get(p)
    a = random_limbs(p, 13, 3)
    ja, ta = both(a)
    same(jf.prefix_prod(jfs, ja), tf.prefix_prod(tfs, ta))
    same(jf.mont_inv_batch(jfs, ja), tf.mont_inv_batch(tfs, ta))


@pytest.mark.parametrize("name", FIELDS)
def test_inverse_and_sums_match_host(name):
    p = FIELDS[name]
    fs = tf.FieldSpec.get(p)
    rng = np.random.default_rng(4)
    xs = [int(x) % p for x in rng.integers(0, 1 << 62, size=9)] + [0, 1, p - 1]
    xs[3] = (xs[3] << 190) % p
    x = fs.to_device(fs.to_mont_host(xs), "cpu")
    assert fs.from_mont_host(tf.mont_inv_batch(fs, x)) == [pow(v, -1, p) if v else 0 for v in xs]
    assert fs.from_mont_host(tf.sum_mod(fs, x)) == [sum(xs) % p]
    assert fs.from_mont_host(tf.mont_pow_int(fs, x, 5)) == [pow(v, 5, p) for v in xs]


def test_mont_mul_plain_matches_pallas_kernel(monkeypatch):
    """K1's plain version against the Pallas kernel it replaces, run in
    interpret mode (two 1024-lane blocks)."""
    monkeypatch.setenv("ZKSNAKE_PALLAS_INTERPRET", "1")
    from zksnake_tpu.backend import pallas_field

    p = BN254_MODULUS
    a = random_limbs(p, 2048, 5)
    b = random_limbs(p, 2048, 6)[:, ::-1].copy()
    ja, ta = both(a)
    jb, tb = both(b)
    want = pallas_field.mont_mul_pallas(jf.FieldSpec.get(p), ja, jb, variant="cios")
    same(want, kernels.mont_mul_plain(tf.FieldSpec.get(p), ta, tb))


def test_wrappers_refuse_other_devices():
    fs = tf.FieldSpec.get(BN254_SCALAR_FIELD)
    a = torch.zeros((fs.nl, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.mont_mul(fs, a, a)
