"""Multi-scalar multiplication and batched scalar multiplication on torch.

Port of zksnake_tpu/backend/msm.py. The MSM is the signed-digit, sort-based
Pippenger of the JAX package:

- balanced c-bit window digits, the carry taken up by the top window;
- top-window sub-bucket spreading (the top window has few distinct digits,
  so its runs would be n / V long without it);
- one sort per window by |digit|: every bucket's points form one contiguous
  run, Y is negated for negative digits, and identity inputs and |d| = 0 go
  to the dropped run; run bounds by searchsorted;
- bucket accumulation: kernel K2 (backend/kernels.py), all windows in one
  launch, each (window, bucket) walking its own run; under
  ZKSNAKE_MXU_MONTMUL=1 kernel K2m, the same with every product's
  reductions on the tensor cores (the JAX package swaps its bucket
  kernel's body under the flag);
- the suffix-scan weighted reduction over every window at once, then a
  Horner pass across windows: kernel K4 (kernels.bucket_reduce), one pass
  for every MSM of a call in two launches.

With metrics on (zksnake_tpu_torch.metrics), each stage is a span:
msm.sort, msm.accumulate and msm.reduce, the last with the children
msm.reduce.window and .horner on the card (K4, which also counts
reduce_kernel_passes), or .top, .scan, .tree and .horner on the CPU (its
plain version); both count the reduction's point ops, one a level.

The JAX package's round table, its gather, the static round budget, the
remainder loop and the lane caps fitted Mosaic's fixed grid and are not
ported. G2 runs the same Pippenger (no double-and-add detour).
"""

import numpy as np
import torch

from .. import metrics
from . import config, kernels
from .curve_ops import get_group_spec
from .field import DTYPE, FieldSpec
from .limbs import ints_to_limbs


def _scalar_limbs(scalars, r, nl):
    """Scalars mod r -> (nl, N) uint32 16-bit limbs (numpy, limbs-first)."""
    return np.ascontiguousarray(ints_to_limbs([int(s) % r for s in scalars], nl).T)


def scalars_to_device(scalars, r, device):
    fr = FieldSpec.get(r)
    return fr.to_device(_scalar_limbs(scalars, r, fr.nl), device)


def _double_and_add(gs, P, slimbs, nbits):
    """Per-lane scalar mul (high bit first) with mixed adds: P affine with Z
    in {0, 1}; identity lanes never add. slimbs: (SL, N) raw scalar limbs."""
    X, Y, Z = P
    not_inf = ~gs.F.is_zero(Z)
    dev = slimbs.device
    acc = gs.identity((slimbs.shape[1],), dev)
    for b in range(nbits - 1, -1, -1):
        bit = (slimbs[b // 16] >> (b % 16)) & 1
        acc = gs.double(acc)
        cand = gs.add_affine(acc, (X, Y))
        acc = gs.select((bit == 1) & not_inf, cand, acc)
    return acc


def _tree_reduce(gs, P, n):
    """Sum the n lanes of the trailing axis (n a power of two) by halving."""
    while n > 1:
        h = n // 2
        P = gs.add(gs.map(lambda t: t[..., :h], P), gs.map(lambda t: t[..., h:n], P))
        n = h
    return gs.map(lambda t: t[..., 0], P)


def _next_pow2(n):
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _extract_digit(slimbs, w, c):
    """Unsigned c-bit digit of window w from (SL, N) 16-bit limbs."""
    sl = slimbs.shape[0]
    bit = w * c
    li = bit // 16
    ofs = bit % 16
    d = slimbs[li] >> ofs
    have = 16 - ofs
    while have < c and li + 1 + (have - (16 - ofs)) // 16 < sl:
        nxt = li + 1 + (have - (16 - ofs)) // 16
        d = d | (slimbs[nxt] << have)
        have += 16
    return d & ((1 << c) - 1)


def _signed_window_digits(slimbs, c, nbits):
    """(SL, N) 16-bit limbs -> (W, N) int32 signed digits, HIGH window first.
    Each digit is in [-(2^(c-1) - 1), 2^(c-1)]; the low-to-high carry is
    taken up by the top window (scalars < r < 2^(nbits-1))."""
    W_ = -(-nbits // c)
    half = 1 << (c - 1)
    full = 1 << c
    carry = None
    rows = []
    for w in range(W_):
        d = _extract_digit(slimbs, w, c)
        t = d if carry is None else d + carry
        carry = (t > half).to(DTYPE)
        rows.append(t - carry * full)
    return torch.stack(rows[::-1], dim=0)


def _pick_window(n):
    """Bucket window size: the JAX package's table from 2^10 points up.
    Below that its c = 7 spends most of an MSM on the 2^(c-1) bucket lanes
    of every window rather than on the n points, so c minimizes the
    point-add count of the JAX package's own cost model (its _pick_window
    docstring), ceil(256 / c) * (n + (2c - 1) * 2^(c-1)), over 3..7."""
    if n >= (1 << 18):
        return 13
    if n >= (1 << 14):
        return 11
    if n >= (1 << 10):
        return 9
    return min(range(3, 8), key=lambda c: -(-256 // c) * (n + (2 * c - 1) * (1 << (c - 1))))


def sort_by_digit(gs, P, slimbs, c):
    """The accumulation input of one MSM: window digits, top-window
    spreading, and the sort by |digit| of every window.

    Returns (pts, starts, lens, S_top, V_cap): pts (L, nl, W, n) sorted X/Y
    planes with Y negated for negative digits (K2's input), starts/lens
    (W, B2) int32 bounds of the run of |d| = b + 1."""
    n = slimbs.shape[1]
    nbits = slimbs.shape[0] * 16
    dev = slimbs.device
    B2 = 1 << (c - 1)
    digits = _signed_window_digits(slimbs, c, nbits)  # (W, n) high-first
    W_total = digits.shape[0]

    # top-window skew fix: spread each true top bucket over S_top sub-bucket
    # lanes, |d| -> (i mod S_top) * V_cap + |d| (sign untouched)
    bound = min(gs.curve.r, (1 << nbits) - 1)
    V_top = (bound >> (c * (W_total - 1))) + 2 if W_total > 1 else B2
    V_cap = _next_pow2(max(V_top, 2))
    S_top = B2 // V_cap if V_cap < B2 else 1
    if S_top > 1:
        d_top = digits[0]
        j = (torch.arange(n, dtype=DTYPE, device=dev) % S_top) * V_cap
        mag0 = d_top.abs()
        pseudo = torch.where(mag0 > 0, j + mag0, 0)
        digits = torch.cat([torch.where(d_top < 0, -pseudo, pseudo)[None], digits[1:]])

    X, Y, Z = P
    inf = gs.F.is_zero(Z)  # identity inputs ride the dropped |d| = 0 run
    mag = torch.where(inf[None], 0, digits.abs())
    order = torch.argsort(mag, dim=1, stable=True)  # (W, n)
    ms = torch.gather(mag, 1, order)
    neg = torch.gather(digits < 0, 1, order)
    # Y and -Y side by side: one gather picks the signed Y of every slot
    ysrc_idx = (order + n * neg.long()).reshape(-1)
    coord = (lambda v: [v]) if gs.group == 1 else list
    xleaves, yleaves, nyleaves = coord(X), coord(Y), coord(gs._neg_coord(Y))
    L = len(xleaves) + len(yleaves)
    nl = gs.fs.nl
    pts = torch.empty((L, nl, W_total, n), dtype=DTYPE, device=dev)
    flat = order.reshape(-1)
    for i, leaf in enumerate(xleaves):
        torch.index_select(leaf, 1, flat, out=pts[i].view(nl, W_total * n))
    for i, (leaf, nleaf) in enumerate(zip(yleaves, nyleaves)):
        ycat = torch.cat([leaf, nleaf], dim=1)
        torch.index_select(ycat, 1, ysrc_idx, out=pts[len(xleaves) + i].view(nl, W_total * n))
    bvals = torch.arange(1, B2 + 1, dtype=ms.dtype, device=dev).expand(W_total, B2).contiguous()
    lo = torch.searchsorted(ms, bvals, right=False)
    hi = torch.searchsorted(ms, bvals, right=True)
    starts = lo.to(DTYPE).contiguous()
    lens = (hi - lo).to(DTYPE).contiguous()
    return pts, starts, lens, S_top, V_cap


def msm_pippenger_many(gs, jobs, c):
    """M MSMs of one group with one window size c. jobs: [(P, slimbs)],
    P projective coords (nl, n_i) with Z in {0, 1}, slimbs (SL, n_i) raw
    16-bit scalar limbs. Each job is sorted and bucket-accumulated (K2, or
    K2m under ZKSNAKE_MXU_MONTMUL=1) on its own; the reduction (K4) runs
    once over all of them. Returns the projective results, leaves (nl, M)."""
    mma = config.mxu_montmul()
    accumulate = kernels.bucket_accumulate_mma if mma else kernels.bucket_accumulate
    sums = []
    for P, slimbs in jobs:
        with metrics.phase("msm.sort"):
            pts, starts, lens, S_top, V_cap = sort_by_digit(gs, P, slimbs, c)
        with metrics.phase("msm.accumulate"):
            sums.append(accumulate(gs, pts, starts, lens))
        del pts
    buckets = torch.stack(sums, dim=2)  # (3|6, nl, M, W, B2)
    with metrics.phase("msm.reduce"):
        return gs.unflatten(list(kernels.bucket_reduce(gs, buckets, c, S_top, V_cap)))


def msm_pippenger(gs, P, slimbs, c=13):
    """Full MSM by the bucket method (one job of msm_pippenger_many).
    Returns one projective point (leaves of shape (nl,))."""
    return gs.map(lambda t: t[:, 0], msm_pippenger_many(gs, [(P, slimbs)], c))


def msm_device_raw(gs, P, slimbs):
    """MSM over device-resident points and scalar limbs; projective result."""
    return msm_pippenger(gs, P, slimbs, _pick_window(slimbs.shape[1]))


@torch.inference_mode()
def msm_device(curve, group, points, scalars, point_cls, device):
    """Full MSM on `device` from host points and ints; returns a host point."""
    gs = get_group_spec(curve, group)
    slimbs = scalars_to_device(scalars, curve.r, device)
    res = msm_device_raw(gs, gs.points_to_device(points, device), slimbs)
    return gs.points_from_device(gs.map(lambda t: t[:, None], res), point_cls)[0]


@torch.inference_mode()
def batch_mul_device(curve, group, points, scalars, point_cls, device):
    """Independent per-lane scalar multiplications on `device`."""
    gs = get_group_spec(curve, group)
    fr = FieldSpec.get(curve.r)
    slimbs = scalars_to_device(scalars, curve.r, device)
    res = _double_and_add(gs, gs.points_to_device(points, device), slimbs, fr.nl * 16)
    return gs.points_from_device(res, point_cls)


# ------------------------------------------------------------------
# Fixed-base batch scalar multiplication (trusted-setup hot path)
#
# One base times many scalars: a table T[w][d] = d * 2^(c w) * P of affine
# points per base, then each scalar is W = ceil(nbits / c) table lookups and
# mixed adds. c = 4 (the JAX package uses 8): a 16x smaller table for twice
# the lookup rounds, which are cheap full-width launches on the card. The table is built on device in c doubling steps,
# T[w][d + 2^k] = T[w][d] + 2^k B_w for d < 2^k (B_w = 2^(c w) P, the 2^k B_w
# from host doublings), 2^c - 1 mixed adds per window in all, then
# normalized to affine with one batched inversion.
# ------------------------------------------------------------------

_FIXED_BASE_C = 4
_FB_TABLES = {}


def _fixed_base_table(gs, base_point, device):
    """((X, Y) affine leaves (nl, W*2^c), inf mask (W*2^c,), W)."""
    key = (gs.curve.name, gs.group, base_point, str(device))
    if key in _FB_TABLES:
        return _FB_TABLES[key]
    c = _FIXED_BASE_C
    fr = FieldSpec.get(gs.curve.r)
    W_ = (fr.nl * 16 + c - 1) // c
    # mult[k][w] = 2^(c w + k) * base, host doublings
    mult = [[None] * W_ for _ in range(c)]
    b = base_point
    for w in range(W_):
        for k in range(c):
            mult[k][w] = b
            b = b + b
    T = gs.identity((W_, 1), device)
    for k in range(c):
        Bk = gs.points_to_device(mult[k], device)  # (nl, W) affine
        Bk = gs.map(lambda t: t[:, :, None], Bk)
        Tk = gs.add_affine(T, (Bk[0], Bk[1]))
        T = gs.map(lambda a, b_: torch.cat([a, b_], dim=-1), T, Tk)
    # T leaves (nl, W, 2^c): lane w*2^c + d = d * 2^(c w) * base
    T = gs.map(lambda t: t.reshape(t.shape[0], W_ << c), T)
    (tx, ty), inf = gs.to_affine(T)
    entry = ((tx, ty), inf, W_)
    _FB_TABLES[key] = entry
    return entry


def batch_mul_fixed_base_raw(gs, base_point, slimbs):
    """Device-resident fixed-base batch mul: raw scalar limbs (SL, n) in,
    projective point tensors (nl, n) out."""
    c = _FIXED_BASE_C
    (tx, ty), inf, W_ = _fixed_base_table(gs, base_point, slimbs.device)
    acc = gs.identity((slimbs.shape[1],), slimbs.device)
    for w in range(W_):
        idx = (w << c) + _extract_digit(slimbs, w, c).long()
        Q = (gs.cmap(lambda t: t[:, idx], tx), gs.cmap(lambda t: t[:, idx], ty))
        acc = gs.select(~inf[idx], gs.add_affine(acc, Q), acc)
    return acc


@torch.inference_mode()
def batch_mul_fixed_base(curve, group, base_point, scalars, point_cls, device):
    """scalars[i] * base_point for all i, via windowed fixed-base tables."""
    gs = get_group_spec(curve, group)
    slimbs = scalars_to_device(scalars, curve.r, device)
    return gs.points_from_device(batch_mul_fixed_base_raw(gs, base_point, slimbs), point_cls)
