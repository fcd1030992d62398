"""Batched Montgomery arithmetic over 16-bit-limb tensors, on torch.

Port of zksnake_tpu/backend/field.py. Elements are limbs-first (nl, *batch)
int32 tensors holding little-endian 16-bit limbs (values < 2^16), in
Montgomery form with R = 2^(16 nl) — the JAX package's layout, so state
moves between the two by a dtype change and tests compare limb for limb.

`mont_mul` is kernel K1 on a CUDA tensor and its plain int64 version on a
CPU tensor (backend/kernels.py); with ZKSNAKE_MXU_MONTMUL=1 (read at call
time, as the JAX package does) flat batches of at least MXU_MIN_LANES go to
kernel K3, the Montgomery product with its reductions on the tensor cores,
instead. CIOS (K1) stays the default. The additive ops are plain torch: each
resolves its carry or borrow chain with a prefix scan (cummax over the limb
axis) rather than a limb-by-limb loop, so an op is a fixed dozen tensor ops
whatever nl is.
"""

import ctypes

import numpy as np
import torch

from . import config, kernels
from .limbs import W, MASK, n_limbs, ints_to_limbs, limbs_to_ints

DTYPE = torch.int32
# smallest flat batch that ZKSNAKE_MXU_MONTMUL=1 sends to K3 (the JAX
# package's Pallas threshold, zksnake_tpu/backend/field.py:279)
MXU_MIN_LANES = 1 << 15


class FieldSpec:
    """Per-modulus constants for the limb kernels (host conversions as in
    the JAX package, device constants per torch device)."""

    _CACHE = {}

    def __init__(self, p: int):
        self.p = p
        self.nl = n_limbs(p)
        self.R = (1 << (W * self.nl)) % p
        self.R2 = self.R * self.R % p
        self.p_limbs = np.array(
            [(p >> (W * i)) & MASK for i in range(self.nl)], dtype=np.uint32
        )
        # -p^-1 mod 2^16 (plain CIOS) and mod 2^32 (the kernels' CIOS)
        self.pinv = (-pow(p, -1, 1 << W)) % (1 << W)
        self.pinv32 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.one_mont = np.array(
            [(self.R >> (W * i)) & MASK for i in range(self.nl)], dtype=np.uint32
        )
        self._dev = {}
        self._words = {}

    @classmethod
    def get(cls, p: int):
        if p not in cls._CACHE:
            cls._CACHE[p] = cls(p)
        return cls._CACHE[p]

    # ---------- host-side conversions (limbs-first, numpy uint32) ----------
    def to_mont_host(self, values):
        """ints -> (nl, n) Montgomery limb array (numpy)."""
        from ..native import get_codec

        codec = get_codec()
        if codec is not None:
            scaled = codec.mulmod_scalar(
                values if isinstance(values, list) else list(values), self.R, self.p
            )
        else:
            scaled = [int(v) % self.p * self.R % self.p for v in values]
        return np.ascontiguousarray(ints_to_limbs(scaled, self.nl).T)

    def from_mont_host(self, arr):
        """(nl, n) Montgomery limbs (numpy or tensor) -> ints."""
        rinv = pow(self.R, -1, self.p)
        return [v * rinv % self.p for v in self.raw_from_host(arr)]

    def raw_to_host(self, values):
        """ints (mod p, NOT Montgomery) -> (nl, n) limb array (numpy)."""
        return np.ascontiguousarray(
            ints_to_limbs([int(v) % self.p for v in values], self.nl).T
        )

    def raw_from_host(self, arr):
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        rows = np.ascontiguousarray(np.asarray(arr).astype(np.uint32).T)
        return limbs_to_ints(rows)

    # ---------- device constants ----------
    def const_mont(self, value: int, device, batch_ndim=1):
        """Montgomery constant as an (nl, 1, ..., 1) int32 tensor."""
        key = ("c", int(value) % self.p, str(device), batch_ndim)
        if key not in self._dev:
            m = int(value) % self.p * self.R % self.p
            limbs = [(m >> (W * i)) & MASK for i in range(self.nl)]
            t = torch.tensor(limbs, dtype=DTYPE, device=device)
            self._dev[key] = t.view((self.nl,) + (1,) * batch_ndim)
        return self._dev[key]

    def one_mont_dev(self, batch_shape, device):
        """Montgomery 1 broadcast to (nl, *batch_shape)."""
        one = self.const_mont(1, device, len(batch_shape))
        return one.expand((self.nl,) + tuple(batch_shape))

    def p_col(self, device, dtype=DTYPE, ndim=2):
        """p's limbs as an (nl, 1, ..., 1) tensor of `ndim` dims."""
        key = ("p", str(device), dtype, ndim)
        if key not in self._dev:
            t = torch.tensor(self.p_limbs.astype(np.int64), dtype=dtype, device=device)
            self._dev[key] = t.view((self.nl,) + (1,) * (ndim - 1))
        return self._dev[key]

    def plain_consts(self, device):
        """Constants of kernels.mont_mul_plain on `device`: p and -p^-1 mod R
        as (nl, 1) int64 limb columns."""
        key = ("plain", str(device))
        if key not in self._dev:
            nl = self.nl
            R = 1 << (W * nl)
            pprime = (-pow(self.p, -1, R)) % R
            limbs = lambda v: torch.tensor(  # noqa: E731
                [(v >> (W * j)) & MASK for j in range(nl)], dtype=torch.int64, device=device
            ).view(nl, 1)
            self._dev[key] = {
                "p": limbs(self.p),
                "pprime": limbs(pprime),
            }
        return self._dev[key]

    def mma_mats(self, device):
        """K3's reduction matrices on `device` as float64: the NB x NB block
        of PMAT and the 2NB x NB block of PPMAT (kernels._reduction_mats)."""
        key = ("mma", str(device))
        if key not in self._dev:
            nb = 2 * self.nl
            pmat, ppmat = kernels._reduction_mats(self.p, self.nl)
            self._dev[key] = (
                torch.from_numpy(pmat[:, :nb].astype(np.float64)).to(device),
                torch.from_numpy(ppmat[: 2 * nb].astype(np.float64)).to(device),
            )
        return self._dev[key]

    def mma_tiles(self, device):
        """K3's matrices as the kernel reads them: the same two blocks as
        mma_mats, as bytes, each cut into row-major 16x16 tiles stored one
        after another (tile (mt, kt) at (mt * KT + kt) * 256), one uint8
        tensor on `device`."""
        key = ("mma_tiles", str(device))
        if key not in self._dev:
            nb = 2 * self.nl
            pmat, ppmat = kernels._reduction_mats(self.p, self.nl)

            def tiles(m):
                mt, kt = m.shape[0] // 16, m.shape[1] // 16
                return m.reshape(mt, 16, kt, 16).transpose(0, 2, 1, 3).reshape(-1)

            flat = np.concatenate([tiles(pmat[:, :nb]), tiles(ppmat[: 2 * nb])])
            self._dev[key] = torch.from_numpy(flat.astype(np.uint8)).to(device)
        return self._dev[key]

    def mma_frags(self, device):
        """K3's constant B fragments in the order csrc/mma_frag.cuh reads
        them: an (NF, 32, 2) int32 tensor on `device` whose [f, lane] pair
        is lane (g, q) = (lane // 4, lane % 4)'s two 32-bit registers of the
        f-th tile of kernels.mma_frag_tiles: bytes 4q..4q+3 and
        16+4q..16+4q+3 of the tile's k32 step in B's column g (output byte
        8 nt + g), the lowest byte first (m16n8k32 u8 B fragments)."""
        key = ("mma_frags", str(device))
        if key not in self._dev:
            nb = 2 * self.nl
            pmat, ppmat = kernels._reduction_mats(self.p, self.nl)
            kpad = 32 * ((nb + 31) // 32)
            mats = []
            for m in (pmat[:, :nb], ppmat[: 2 * nb]):
                padded = np.zeros((m.shape[0], kpad), dtype=np.uint32)
                padded[:, :nb] = m
                mats.append(padded)
            shifts = np.uint32(8) * np.arange(4, dtype=np.uint32)
            tab = []
            for prod, nt, ks in kernels.mma_frag_tiles(self.nl):
                blk = mats[prod][8 * nt:8 * nt + 8, 32 * ks:32 * ks + 32]  # [g, byte]
                words = (blk.reshape(8, 2, 4, 4) << shifts).sum(axis=3, dtype=np.uint32)
                tab.append(words.transpose(0, 2, 1).reshape(32, 2))  # [4g + q, half]
            flat = np.ascontiguousarray(np.stack(tab)).view(np.int32)
            self._dev[key] = torch.from_numpy(flat).to(device)
        return self._dev[key]

    def words(self, which):
        """ctypes uint32 array of 32-bit words ("p", "one" or "r3", R^3 mod
        p) for the kernels."""
        if which not in self._words:
            v = {"p": self.p, "one": self.R, "r3": pow(self.R, 3, self.p)}[which]
            vals = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(self.nl // 2)]
            self._words[which] = (ctypes.c_uint32 * len(vals))(*vals)
        return self._words[which]

    def to_device(self, arr, device):
        """numpy (nl, ...) uint32 limbs -> int32 tensor on `device`."""
        return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


# ------------------------------------------------------------- helpers ----


def broadcast_shapes(*shapes):
    """torch.broadcast_shapes without its per-call overhead."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def _bshape(a, b):
    return broadcast_shapes(a.shape[1:], b.shape[1:])


def _expand(x, nl, shape):
    """(nl, *some_batch) -> (nl, *shape), right-aligning the batch dims."""
    extra = len(shape) - (x.ndim - 1)
    x = x.reshape((nl,) + (1,) * extra + tuple(x.shape[1:]))
    return x.expand((nl,) + tuple(shape))


def _carry_in(gen, prop):
    """Carry (or borrow) into each limb of a chain where limb j generates
    one unit (gen, 0/1) or passes the incoming one on (prop, only where not
    gen): the carry into limb j+1 is gen[k] for the highest k <= j that does
    not propagate, found by one cummax over keys 2k + gen[k].
    gen: (nl, ...) int; prop: (nl, ...) bool. Returns (carry into each limb
    (nl, ...), carry out of the top limb (batch-shaped))."""
    nl = gen.shape[0]
    key = torch.where(prop, -2, _twice_index(nl, gen) + gen)
    cout = torch.cummax(key, dim=0).values & 1
    cin = torch.constant_pad_nd(cout[:-1], (0, 0) * (gen.ndim - 1) + (1, 0))
    return cin, cout[-1]


_IDX = {}


def _twice_index(nl, like):
    """2 * limb index as an (nl, 1, ..., 1) tensor of like's dtype/device."""
    key = (nl, like.ndim, str(like.device), like.dtype)
    if key not in _IDX:
        idx = 2 * torch.arange(nl, device=like.device, dtype=like.dtype)
        _IDX[key] = idx.view((nl,) + (1,) * (like.ndim - 1))
    return _IDX[key]


def _normalize(t, passes):
    """(k, ...) int64 non-negative lazy columns of weight 2^(16 j) -> 16-bit
    limbs of the same value mod 2^(16 k). `passes` carry-save passes must
    bring every column to <= 2^16 (each takes 16 bits off the largest
    carry); a prefix scan then resolves the remaining one-bit carries."""
    for _ in range(passes):
        c = t >> W
        t = t & MASK
        t[1:] += c[:-1]
    lo = t & MASK
    cin, _ = _carry_in(t >> W, lo == MASK)
    return (lo + cin) & MASK


def _cond_sub_p(fs, r, extra=None):
    """r (nl, ...) normalized limbs with value in [0, 2p) (plus `extra`,
    a carry of weight R) -> value mod p."""
    d = r - fs.p_col(r.device, r.dtype, r.ndim)
    bin_, bout = _carry_in((d < 0).to(d.dtype), d == 0)
    diff = (d - bin_) & MASK
    ge = bout == 0 if extra is None else ((bout == 0) | (extra != 0))
    return torch.where(ge.unsqueeze(0), diff, r)


# ---------------------------------------------------------- field ops ----


def mont_mul(fs, a, b, plain=False):
    """Montgomery product (a * b * R^-1) mod p of broadcastable (nl, ...)
    limb tensors. Operands are expanded to one shape first (as
    mont_mul_pallas does) and run as one flat (nl, N) launch of K1 on CUDA.
    plain=True forces K1's plain version and plain="mma" K3's (the
    references the kernels are checked against). Under
    ZKSNAKE_MXU_MONTMUL=1 a launch of at least MXU_MIN_LANES lanes goes to
    K3 instead."""
    nl = fs.nl
    shape = _bshape(a, b)
    a2 = _expand(a, nl, shape).reshape(nl, -1).contiguous()
    b2 = _expand(b, nl, shape).reshape(nl, -1).contiguous()
    if plain == "mma":
        fn = kernels.mont_mul_mma_plain
    elif plain:
        fn = kernels.mont_mul_plain
    elif a2.shape[1] >= MXU_MIN_LANES and config.mxu_montmul():
        fn = kernels.mont_mul_mma
    else:
        fn = kernels.mont_mul
    return fn(fs, a2, b2).reshape((nl,) + tuple(shape))


def mont_sqr(fs, a):
    return mont_mul(fs, a, a)


def mod_add(fs, a, b):
    s = a + b  # limbs < 2^17
    lo = s & MASK
    cin, cout = _carry_in(s >> W, lo == MASK)
    return _cond_sub_p(fs, (lo + cin) & MASK, cout)


def mod_sub(fs, a, b):
    d = a - b
    bin_, bout = _carry_in((d < 0).to(d.dtype), d == 0)
    diff = (d - bin_) & MASK
    # where we borrowed past the top limb, add p back (top carry dropped)
    s = diff + fs.p_col(d.device, d.dtype, d.ndim) * bout.unsqueeze(0)
    lo = s & MASK
    cin, _ = _carry_in(s >> W, lo == MASK)
    return (lo + cin) & MASK


def mod_neg(fs, a):
    return mod_sub(fs, torch.zeros_like(a), a)


def to_mont(fs, raw):
    """raw limbs (value < p) -> Montgomery form, on device."""
    r2 = torch.tensor(
        [(fs.R2 >> (W * i)) & MASK for i in range(fs.nl)], dtype=DTYPE, device=raw.device
    )
    return mont_mul(fs, raw, r2.view((fs.nl,) + (1,) * (raw.ndim - 1)))


def from_mont(fs, mont):
    """Montgomery form -> raw limbs, on device (multiply by 1)."""
    one = torch.zeros(fs.nl, dtype=DTYPE, device=mont.device)
    one[0] = 1
    return mont_mul(fs, mont, one.view((fs.nl,) + (1,) * (mont.ndim - 1)))


def mont_pow_int(fs, a, e: int):
    """a^e for a static exponent (square-and-multiply, low bit first)."""
    result = fs.one_mont_dev(a.shape[1:], a.device)
    base = a
    while e > 0:
        if e & 1:
            result = mont_mul(fs, result, base)
        e >>= 1
        if e:
            base = mont_sqr(fs, base)
    return result


def mont_inv(fs, a):
    """Batched inversion via Fermat (a^(p-2)); zero maps to zero."""
    return mont_pow_int(fs, a, fs.p - 2)


def prefix_prod(fs, x):
    """Inclusive prefix product along the last axis of a (nl, ..., n) limb
    tensor (Hillis-Steele scan: ceil(log2 n) mont_muls)."""
    n = x.shape[-1]
    sh = 1
    while sh < n:
        x = torch.cat([x[..., :sh], mont_mul(fs, x[..., sh:], x[..., :-sh])], dim=-1)
        sh <<= 1
    return x


def prefix_sum_mod(fs, x):
    """Inclusive prefix sum (mod p) along the last axis of a (nl, ..., n)
    limb tensor, the additive twin of prefix_prod (Hillis-Steele scan:
    ceil(log2 n) mod_adds)."""
    n = x.shape[-1]
    sh = 1
    while sh < n:
        x = torch.cat([x[..., :sh], mod_add(fs, x[..., sh:], x[..., :-sh])], dim=-1)
        sh <<= 1
    return x


def sum_mod(fs, x, dim=-1):
    """Sum a limb tensor along `dim` (mod p) by folding in halves."""
    if dim < 0:
        dim += x.ndim
    n = x.shape[dim]
    while n > 1:
        half = n // 2
        s = mod_add(fs, x.narrow(dim, 0, half), x.narrow(dim, half, half))
        if n & 1:
            s = torch.cat([s, x.narrow(dim, 2 * half, 1)], dim=dim)
        x = s
        n = x.shape[dim]
    return x


def mont_inv_batch(fs, x):
    """Batched inversion of a (nl, n) limb tensor along the last axis by the
    Montgomery product trick (two prefix scans, one Fermat inversion of the
    total, two full-width products). Zero lanes invert to zero."""
    n = x.shape[-1]
    if n == 1:
        return mont_inv(fs, x)
    is_zero = eq_zero(fs, x)
    one_col = fs.one_mont_dev((1,), x.device)
    xs = torch.where(is_zero.unsqueeze(0), one_col.expand(x.shape), x)
    pre = prefix_prod(fs, xs)  # pre[i] = x_0 ... x_i
    suf = torch.flip(prefix_prod(fs, torch.flip(xs, dims=[-1])), dims=[-1])
    tinv = mont_inv(fs, pre[:, -1:])  # (total product)^-1
    # inv(x_i) = pre[i-1] * suf[i+1] * total^-1
    pre_s = torch.cat([one_col, pre[:, :-1]], dim=1)
    suf_s = torch.cat([suf[:, 1:], one_col], dim=1)
    out = mont_mul(fs, mont_mul(fs, pre_s, suf_s), tinv)
    return torch.where(is_zero.unsqueeze(0), torch.zeros_like(out), out)


def eq_zero(fs, a):
    return (a == 0).all(dim=0)
