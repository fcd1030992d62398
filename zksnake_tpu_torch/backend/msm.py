"""Multi-scalar multiplication and batched scalar multiplication on torch.

Port of zksnake_tpu/backend/msm.py. The MSM is the signed-digit, sort-based
Pippenger of the JAX package:

- balanced c-bit window digits, the carry taken up by the top window;
- top-window sub-bucket spreading (the top window has few distinct digits,
  so its runs would be n / V long without it);
- one sort per window by |digit|: every bucket's points form one contiguous
  run, Y is negated for negative digits, and identity inputs and |d| = 0 go
  to the dropped run; run bounds by searchsorted;
- the MSMs of a call over the same points sorted together, their windows
  side by side, in groups of at most SORT_GROUP_ELEMS sorted elements;
- bucket accumulation: kernel K2 (backend/kernels.py), all windows of a
  group in one launch, each (window, bucket) walking its own run; under
  ZKSNAKE_MXU_MONTMUL=1 kernel K2m, the same with every product's
  reductions on the tensor cores (the JAX package swaps its bucket
  kernel's body under the flag);
- the suffix-scan weighted reduction over every window at once, then a
  Horner pass across windows: kernel K4 (kernels.bucket_reduce), one pass
  for every MSM of a call in two launches;
- for bases that never change, a fixed-base path: a FixedBaseTable holds
  2^(c w) P_i for every window w, made once on the device, and an MSM over
  it is one window of W n points (sort_fixed_base), so K4 reduces one
  window an MSM, not W. Its c comes from fixed_base_window.

With metrics on (zksnake_tpu_torch.metrics), each stage is a span:
msm.sort, msm.accumulate and msm.reduce, the last with the children
msm.reduce.window and .horner on the card (K4, which also counts
reduce_kernel_passes), or .top, .scan, .tree and .horner on the CPU (its
plain version); both count the reduction's point ops, one a level, and
msm.reduce counts msm_windows, the windows it reduces.
msm_pippenger_many counts msm_points, the points of a call's MSMs, and
msm_fixed_points, those of its MSMs over tables.

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


def _coord(gs, v):
    """The limb tensors of one coordinate, as a list."""
    return [v] if gs.group == 1 else list(v)


def _sorted_runs(gs, digits, inf, xs, ys, B2, src=None):
    """Sort each row of `digits` (rows, m) by |digit| and gather the signed
    points of its slots: identity lanes (inf, (m,)) and |d| = 0 go to the
    dropped run. xs: the X leaves (nl, m'); ys: the Y leaves with -Y
    beside them (nl, 2 m'); src maps a slot to its point (the identity
    where None, m' = m). Returns (pts (L, nl, rows, m), starts, lens
    (rows, B2) int32 bounds of the run of |d| = b + 1)."""
    rows, m = digits.shape
    dev = digits.device
    mag = torch.where(inf[None], 0, digits.abs())
    order = torch.argsort(mag, dim=1, stable=True)  # (rows, m)
    ms = torch.gather(mag, 1, order)
    neg = torch.gather(digits < 0, 1, order)
    if src is not None:
        order = src(order)
    # Y and -Y side by side: one gather picks the signed Y of every slot
    ysrc_idx = (order + ys[0].shape[1] // 2 * neg.long()).reshape(-1)
    nl = gs.fs.nl
    pts = torch.empty((len(xs) + len(ys), nl, rows, m), dtype=DTYPE, device=dev)
    flat = order.reshape(-1)
    for i, leaf in enumerate(xs):
        torch.index_select(leaf, 1, flat, out=pts[i].view(nl, rows * m))
    for i, ycat in enumerate(ys):
        torch.index_select(ycat, 1, ysrc_idx, out=pts[len(xs) + i].view(nl, rows * m))
    bvals = torch.arange(1, B2 + 1, dtype=ms.dtype, device=dev).expand(rows, B2).contiguous()
    lo = torch.searchsorted(ms, bvals, right=False)
    hi = torch.searchsorted(ms, bvals, right=True)
    return pts, lo.to(DTYPE).contiguous(), (hi - lo).to(DTYPE).contiguous()


def sort_by_digit(gs, P, slimbs, c):
    """The accumulation input of one MSM, or of G MSMs over the same
    points: window digits, top-window spreading, and the sort by |digit| of
    every window of every MSM.

    slimbs: (SL, n) raw scalar limbs, or (SL, G, n) for G MSMs of P.
    Returns (pts, starts, lens, S_top, V_cap): pts (L, nl, G W, n) sorted
    X/Y planes with Y negated for negative digits (K2's input; MSM g's
    window w is row g W + w), starts/lens (G W, B2) int32 bounds of the run
    of |d| = b + 1."""
    n = slimbs.shape[-1]
    nbits = slimbs.shape[0] * 16
    dev = slimbs.device
    B2 = 1 << (c - 1)
    digits = _signed_window_digits(slimbs, c, nbits)  # (W, [G,] n) high-first
    W_total = digits.shape[0]
    if digits.ndim == 3:
        digits = digits.transpose(0, 1).reshape(-1, n)
    rows = digits.shape[0]

    # top-window skew fix: spread each true top bucket over S_top sub-bucket
    # lanes, |d| -> (i mod S_top) * V_cap + |d| (sign untouched)
    bound = min(gs.curve.r, (1 << nbits) - 1)
    V_top = (bound >> (c * (W_total - 1))) + 2 if W_total > 1 else B2
    V_cap = _next_pow2(max(V_top, 2))
    S_top = B2 // V_cap if V_cap < B2 else 1
    if S_top > 1:
        per_msm = digits.view(-1, W_total, n)
        d_top = per_msm[:, 0]
        j = (torch.arange(n, dtype=DTYPE, device=dev) % S_top) * V_cap
        mag0 = d_top.abs()
        pseudo = torch.where(mag0 > 0, j + mag0, 0)
        digits = torch.cat([torch.where(d_top < 0, -pseudo, pseudo)[:, None], per_msm[:, 1:]],
                           dim=1).view(rows, n)

    X, Y, Z = P
    ycat = [torch.cat([y, ny], dim=1)
            for y, ny in zip(_coord(gs, Y), _coord(gs, gs._neg_coord(Y)))]
    # identity inputs ride the dropped |d| = 0 run
    pts, starts, lens = _sorted_runs(gs, digits, gs.F.is_zero(Z), _coord(gs, X), ycat, B2)
    return pts, starts, lens, S_top, V_cap


# ------------------------------------------------------------------
# Fixed-base MSMs: one table of shifted bases, one window an MSM
#
# For bases that never change (an SRS on the card), sum_i s_i P_i =
# sum_w 2^(c w) sum_i d_(i,w) P_i = sum_(w,i) d_(i,w) (2^(c w) P_i): with
# the shifted bases 2^(c w) P_i in a table made once, an MSM's W windows
# of n points become one window of W n points. K4 then reduces one window
# an MSM, not W, and Horner has one step.
# ------------------------------------------------------------------


class FixedBaseTable:
    """The shifted bases 2^(c w) P_i of N bases P_i, for every window w of
    c bits of a scalar of the group's order (W = ceil(nbits / c)), affine
    on the device, window-major: leaves x (nl, W, N) and y2 (nl, 2, W, N)
    (Y, then -Y), inf (W, N) the identity mask. An MSM whose points are a
    table takes msm_pippenger_many's fixed-base path; `n` bases of it are
    used, the first n (prefix)."""

    def __init__(self, x, y2, inf, c, n):
        self.x, self.y2, self.inf, self.c, self.n = x, y2, inf, c, n
        self.W, self.N = inf.shape

    def prefix(self, n):
        """The table of the first n bases, over the same tensors."""
        if not 0 < n <= self.N:
            raise ValueError(f"a prefix of {n} of {self.N} bases")
        return FixedBaseTable(self.x, self.y2, self.inf, self.c, n)


def fixed_base_table(gs, P):
    """The FixedBaseTable of device-resident bases P (projective leaves
    (nl, N) with Z in {0, 1}) at the window size fixed_base_window picks
    for N bases, made on the device: row w + 1 from row w by c doublings
    over the N lanes, then every row to affine with one batched
    inversion."""
    N = gs.leaves(P)[0].shape[1]
    nbits = FieldSpec.get(gs.curve.r).nl * 16
    c = fixed_base_window(N, nbits)
    W = -(-nbits // c)
    rows = [P]
    for _ in range(W - 1):
        Q = rows[-1]
        for _ in range(c):
            Q = gs.double(Q)
        rows.append(Q)
    T = gs.map(lambda *r: torch.stack(r, dim=1).view(r[0].shape[0], -1), *rows)
    (X, Y), inf = gs.to_affine(T)
    x = gs.cmap(lambda t: t.view(t.shape[0], W, N), X)

    def pair(y, ny):
        return torch.stack([y, ny], dim=1).view(y.shape[0], 2, W, N)

    ny = gs._neg_coord(Y)
    y2 = pair(Y, ny) if gs.group == 1 else tuple(map(pair, Y, ny))
    return FixedBaseTable(x, y2, inf.view(W, N), c, N)


def fixed_base_window(n, nbits):
    """The window size c of the fixed-base path for n bases and nbits-bit
    scalars: the c in 8..13 with the fewest point-op products in the path,
    K2's n ceil(nbits / c) mixed adds (11 products each with a small b3),
    about that count over K2_CHUNK of fold adds and the one window's
    c 2^(c - 1) reduction adds in K4 (complete adds, 14 each). That prices
    K2's projective order; BLS12-381's G1, the path's group, takes the
    affine one (6 products an add and a share of an inversion, at
    kernels.k2_chunk's T), which this model does not price yet (ROADMAP
    queue 4): the c it picks is the one the EIP-7594 cell was measured
    at."""
    def products(c):
        adds = n * -(-nbits // c)
        return 11 * adds + 14 * (adds // kernels.K2_CHUNK + c * (1 << (c - 1)))

    return min(range(8, 14), key=products)


def sort_fixed_base(gs, table, slimbs):
    """sort_by_digit for MSMs over a FixedBaseTable: digit (w, i), window
    w low first, goes on table point (w, i), and each MSM is one row of
    W n slots sorted by |digit| (no top-window spreading: K2's chunks and
    fold lanes split long runs). slimbs: (SL, n) or (SL, G, n). Returns
    (pts (L, nl, G, W n), starts, lens (G, B2))."""
    n, W, N, c = table.n, table.W, table.N, table.c
    nbits = slimbs.shape[0] * 16
    if slimbs.shape[-1] != n or -(-nbits // c) != W:
        raise ValueError(f"scalars {tuple(slimbs.shape)} for a table of {W} windows of "
                         f"{c} bits over {n} bases")
    digits = _signed_window_digits(slimbs, c, nbits).flip(0)  # (W, [G,] n) low-first
    if digits.ndim == 2:
        digits = digits[:, None]
    digits = digits.transpose(0, 1).reshape(-1, W * n)  # slot w n + i
    src = None if n == N else (lambda o: o // n * N + o % n)
    xs = [t.view(t.shape[0], W * N) for t in _coord(gs, table.x)]
    ys = [t.view(t.shape[0], 2 * W * N) for t in _coord(gs, table.y2)]
    return _sorted_runs(gs, digits, table.inf[:, :n].reshape(-1), xs, ys, 1 << (c - 1), src)


# the most int32 elements of sorted point planes (sort_by_digit's pts) that
# one group of MSMs over the same points holds: 1 GiB
SORT_GROUP_ELEMS = 1 << 28


def _job_groups(gs, jobs, c):
    """The jobs in groups that sort_by_digit (sort_fixed_base) and K2 take
    in one call: jobs over the same points (the same tensors, the same view
    of them; the same table and prefix), in job order, each group's sorted
    planes within SORT_GROUP_ELEMS."""
    L = 2 * gs.group
    groups, filling = [], {}
    for i, (P, slimbs) in enumerate(jobs):
        if isinstance(P, FixedBaseTable):
            key, W = (_coord(gs, P.x)[0].data_ptr(), P.n), P.W
        else:
            key = tuple((t.data_ptr(), tuple(t.shape), t.stride()) for t in gs.leaves(P))
            W = -(-16 * slimbs.shape[0] // c)
        cap = max(1, SORT_GROUP_ELEMS // (L * gs.fs.nl * W * slimbs.shape[1]))
        g = filling.get(key)
        if g is None or len(g) == cap:
            g = filling[key] = []
            groups.append(g)
        g.append(i)
    return groups


def _msm_pass(gs, jobs, c):
    """One reduction pass of msm_pippenger_many: jobs all over point
    tensors at window c, or all over FixedBaseTables of one c (one window
    a job). Counts msm_windows, the windows K4 reduces."""
    mma = config.mxu_montmul()
    accumulate = kernels.bucket_accumulate_mma if mma else kernels.bucket_accumulate
    fixed = isinstance(jobs[0][0], FixedBaseTable)
    if fixed:
        c = jobs[0][0].c
        S_top, V_cap = 1, 1 << (c - 1)
    sums = [None] * len(jobs)
    for group in _job_groups(gs, jobs, c):
        P, slimbs = jobs[group[0]]
        if len(group) > 1:
            slimbs = torch.stack([jobs[i][1] for i in group], dim=1)
        with metrics.phase("msm.sort"):
            if fixed:
                pts, starts, lens = sort_fixed_base(gs, P, slimbs)
            else:
                pts, starts, lens, S_top, V_cap = sort_by_digit(gs, P, slimbs, c)
        with metrics.phase("msm.accumulate"):
            out = accumulate(gs, pts, starts, lens)  # (3|6, nl, G W, B2)
        del pts
        parts = out.view(out.shape[0], out.shape[1], len(group), -1, out.shape[3]).unbind(2)
        for i, part in zip(group, parts):
            sums[i] = part
    buckets = torch.stack(sums, dim=2)  # (3|6, nl, M, W, B2)
    with metrics.phase("msm.reduce"):
        metrics.count("msm_windows", buckets.shape[2] * buckets.shape[3])
        return gs.unflatten(list(kernels.bucket_reduce(gs, buckets, c, S_top, V_cap)))


def msm_pippenger_many(gs, jobs, c=None):
    """M MSMs of one group. jobs: [(P, slimbs)], slimbs (SL, n_i) raw
    16-bit scalar limbs; P projective coords (nl, n_i) with Z in {0, 1},
    taken at window size c, or a FixedBaseTable (of n_i bases), taken at
    its own c in one window. The jobs over the same points are sorted and
    bucket-accumulated (K2, or K2m under ZKSNAKE_MXU_MONTMUL=1) together,
    in groups (_job_groups), every other job on its own; the reduction (K4)
    runs once over the jobs of each kind (point tensors; tables of one c).
    Returns the projective results in job order, leaves (nl, M). Counts
    msm_points, the jobs' points together, msm_fixed_points, those of the
    jobs over tables, and msm_windows."""
    metrics.count("msm_points", sum(slimbs.shape[1] for _, slimbs in jobs))
    kinds = {}
    for i, (P, _) in enumerate(jobs):
        kinds.setdefault(P.c if isinstance(P, FixedBaseTable) else None, []).append(i)
    metrics.count("msm_fixed_points",
                  sum(jobs[i][1].shape[1] for k, ids in kinds.items() if k is not None
                      for i in ids))
    if None in kinds and c is None:
        raise ValueError("MSMs over point tensors need a window size c")
    if len(kinds) == 1:
        return _msm_pass(gs, jobs, c)
    order, parts = [], []
    for ids in kinds.values():
        parts.append(_msm_pass(gs, [jobs[i] for i in ids], c))
        order += ids
    back = torch.argsort(torch.tensor(order)).to(gs.leaves(parts[0])[0].device)
    return gs.map(lambda *t: torch.cat(t, dim=-1)[:, back], *parts)


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
