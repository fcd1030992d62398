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

from torch_support import random_limbs, same

FIELDS = {
    "bn254_fr": BN254_SCALAR_FIELD,
    "bn254_fq": BN254_MODULUS,
    "bls12_381_fq": BLS12_381_MODULUS,
}


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


# ------------------------------------------------ K3's fragment layout ----
# csrc/mma_frag.cuh cannot run here, so the arithmetic it relies on is
# modelled lane by lane in numpy: the constant table in fragment order
# (FieldSpec.mma_frags), the A/B/C fragment layouts of mma.sync m16n8k32
# u8 x u8 -> s32 as the PTX ISA draws them, the transposes inside each quad
# and each owner's carry chains. The model must give mont_mul_mma_plain's
# limbs exactly.

FRAG_FIELDS = {"bn254_fq": BN254_MODULUS, "bls12_381_fq": BLS12_381_MODULUS}
_G, _Q = np.arange(32) // 4, np.arange(32) % 4  # lane = 4 g + q


def _bytes(words):
    """(..., w) uint32 words -> (..., 4 w) bytes, the lowest first."""
    w = np.asarray(words, dtype=np.uint64)
    return ((w[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF).reshape(
        *w.shape[:-1], -1).astype(np.int64)


def _quad_transpose(x):
    """(tiles, 32, 4) -> y with y[t, 4g + q, i] = x[t, 4g + i, q]."""
    return x.reshape(-1, 8, 4, 4).transpose(0, 1, 3, 2).reshape(-1, 32, 4)


def _a_fragments(w, ks_n):
    """Every owner's words w (tiles, 32, NW) -> A registers (tiles, 32, 2,
    ks_n, 4): register 2 half + h of m tile mt is row g + 8h, the words
    8 ks + 4 half + q of the element of lane 4g + 2mt + h."""
    tiles, _, nw = w.shape
    padded = np.zeros((tiles, 32, 8 * ks_n), dtype=np.uint64)
    padded[..., :nw] = w
    a = np.zeros((tiles, 32, 2, ks_n, 4), dtype=np.uint64)
    for ks in range(ks_n):
        for half in range(2):
            base = 8 * ks + 4 * half
            y = _quad_transpose(padded[..., base:base + 4])
            for mt in range(2):
                a[:, :, mt, ks, 2 * half] = y[:, :, 2 * mt]
                a[:, :, mt, ks, 2 * half + 1] = y[:, :, 2 * mt + 1]
    return a


def _mma(a, b):
    """One m16n8k32 u8 product per tile: a (tiles, 32, 4) and b (32, 2)
    registers -> C registers (tiles, 32, 4), through the matrices the PTX
    ISA's fragment figures place them in."""
    tiles = a.shape[0]
    A = np.zeros((tiles, 16, 32), dtype=np.int64)
    ab = _bytes(a)  # (tiles, 32, 16): register r's bytes at 4r..4r+3
    for r, (row_off, col_off) in enumerate([(0, 0), (8, 0), (0, 16), (8, 16)]):
        for i in range(4):
            A[:, _G + row_off, 4 * _Q + col_off + i] = ab[:, :, 4 * r + i]
    B = np.zeros((32, 8), dtype=np.int64)
    bb = _bytes(b)  # (32, 8)
    for r, k_off in enumerate([0, 16]):
        for i in range(4):
            B[4 * _Q + k_off + i, _G] = bb[:, 4 * r + i]
    C = A @ B  # (tiles, 16, 8)
    return np.stack([C[:, _G, 2 * _Q], C[:, _G, 2 * _Q + 1],
                     C[:, _G + 8, 2 * _Q], C[:, _G + 8, 2 * _Q + 1]], axis=-1)


def _tile_pairs(a, frags, f, nb, nt, ks_n):
    """n8 tile nt of one product from fragment f on -> (f', each owner's
    column pairs 4nt..4nt+3 (tiles, 32, 4))."""
    acc = np.zeros((a.shape[0], 2, 32, 4), dtype=np.int64)
    live = [t[1:] for t in kernels.mma_frag_tiles(nb // 2)]
    for ks in range(ks_n):
        if (nt, ks) in live:
            for mt in range(2):
                acc[:, mt] += _mma(a[:, :, mt, ks], frags[f])
            f += 1
    x = np.stack([acc[:, mt, :, 2 * h] + (acc[:, mt, :, 2 * h + 1] << 8)
                  for mt in range(2) for h in range(2)], axis=-1)
    assert x.max() < 1 << 31  # the kernel's s32 accumulators and u32 pairs
    return f, _quad_transpose(x)


def frag_model(fs, a, b):
    """K3's warp-level arithmetic in numpy: a, b (nl, n) 16-bit limbs ->
    a b R^-1 mod p as (nl, n) limbs; lanes past n carry zeros."""
    nl, n = a.shape
    nw, nb = nl // 2, 2 * nl
    ks_n = (nb + 31) // 32
    tiles = -(-n // 32)
    frags = fs.mma_frags(torch.device("cpu")).numpy().view(np.uint32).astype(np.uint64)
    tab_pmat = sum(1 for t in kernels.mma_frag_tiles(nl) if t[0] == 0)
    def ints(x):
        return [sum(int(x[j, e]) << (16 * j) for j in range(nl)) for e in range(n)]

    prods = [u * v for u, v in zip(ints(a), ints(b))] + [0] * (32 * tiles - n)
    T = np.array([[(t >> (32 * w)) & 0xFFFFFFFF for w in range(2 * nw)] for t in prods],
                 dtype=np.uint64).reshape(tiles, 32, 2 * nw)

    a_frag = _a_fragments(T[..., :nw], ks_n)
    f, c = 0, np.zeros((tiles, 32), dtype=np.int64)
    m = np.zeros((tiles, 32, nw), dtype=np.uint64)
    for nt in range(nb // 8):
        f, pairs = _tile_pairs(a_frag, frags, f, nb, nt, ks_n)
        for i in (0, 2):
            lo = pairs[..., i] + c
            hi = pairs[..., i + 1] + (lo >> 16)
            m[..., 2 * nt + i // 2] = ((lo & 0xFFFF) | ((hi & 0xFFFF) << 16)).astype(np.uint64)
            c = hi >> 16
    assert f == tab_pmat
    a_frag = _a_fragments(m, ks_n)
    c = np.zeros((tiles, 32), dtype=np.int64)
    r = np.zeros((tiles, 32, nw), dtype=np.int64)
    Ti = T.astype(np.int64)
    for nt in range(nb // 4):
        f, pairs = _tile_pairs(a_frag, frags, f, nb, nt, ks_n)
        for i in (0, 2):
            word = 2 * nt + i // 2
            lo = (Ti[..., word] & 0xFFFF) + pairs[..., i] + c
            hi = (Ti[..., word] >> 16) + pairs[..., i + 1] + (lo >> 16)
            c = hi >> 16
            if word < nw:
                assert not ((lo & 0xFFFF) | (hi & 0xFFFF)).any()  # T + m p = 0 mod R
            else:
                r[..., word - nw] = (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)
    assert f == len(frags)
    out = []
    for t in range(tiles):
        for lane in range(32):
            v = sum(int(r[t, lane, w]) << (32 * w) for w in range(nw))
            v += int(c[t, lane]) << (32 * nw)
            v = v - fs.p if v >= fs.p else v
            assert v < fs.p
            out.append([(v >> (16 * j)) & 0xFFFF for j in range(nl)])
    return np.array(out, dtype=np.int64).T[:, :n]


@pytest.mark.parametrize("name", FRAG_FIELDS)
def test_mma_frags_reassemble_the_reduction_blocks(name):
    """FieldSpec.mma_frags, read back through the m16n8k32 B layout, is the
    NB x NB block of PMAT and the 2NB x NB block of PPMAT (zero padded to
    K = 64 for BLS12-381), and every tile it leaves out is zero."""
    p = FRAG_FIELDS[name]
    fs = tf.FieldSpec.get(p)
    nb = 2 * fs.nl
    kpad = 32 * ((nb + 31) // 32)
    tiles = kernels.mma_frag_tiles(fs.nl)
    assert len(tiles) == {16: 12, 24: 26}[fs.nl]
    frags = fs.mma_frags(torch.device("cpu"))
    assert frags.dtype == torch.int32 and tuple(frags.shape) == (len(tiles), 32, 2)
    words = frags.numpy().view(np.uint32)
    pmat, ppmat = kernels._reduction_mats(p, fs.nl)
    for prod, want in enumerate((pmat[:, :nb], ppmat[: 2 * nb])):
        got = np.zeros((want.shape[0], kpad), dtype=np.int64)
        for f, (pr, nt, ks) in enumerate(tiles):
            if pr != prod:
                continue
            bb = _bytes(words[f])  # (32, 8): lane (g, q)'s bytes
            for r, k_off in enumerate([0, 16]):
                for i in range(4):
                    got[8 * nt + _G, 32 * ks + 4 * _Q + k_off + i] = bb[:, 4 * r + i]
        np.testing.assert_array_equal(got[:, :nb], want.astype(np.int64))
        assert not got[:, nb:].any()


@pytest.mark.parametrize("name", FRAG_FIELDS)
@pytest.mark.parametrize("n", [32, 97])
def test_frag_model_matches_mma_plain(name, n):
    """The kernel's fragment arithmetic (a numpy model of the warp: A words
    through quad transposes, the table's B fragments, C's column pairs
    back to their element's lane, the carry chains there) gives
    mont_mul_mma_plain's limbs exactly, on a ragged count of lanes too."""
    p = FRAG_FIELDS[name]
    fs = tf.FieldSpec.get(p)
    a = random_limbs(p, n, 11).astype(np.int64)
    b = random_limbs(p, n, 12)[:, ::-1].astype(np.int64)
    want = kernels.mont_mul_mma_plain(fs, torch.from_numpy(a.astype(np.int32)),
                                      torch.from_numpy(b.astype(np.int32)))
    np.testing.assert_array_equal(frag_model(fs, a, b), want.numpy().astype(np.int64))
