"""Batched elliptic-curve point arithmetic on torch tensors.

Port of zksnake_tpu/backend/curve_ops.py: homogeneous projective (X:Y:Z)
limb tensors (identity (0:1:0)), the Renes-Costello-Batina complete formulas
for a = 0 (eprint 2015/1060, Algorithms 7, 8 and 9), G2 over Fq2 limb pairs.
A G1 point is a tuple (X, Y, Z) of (nl, *batch) tensors; a G2 point is
((X.a, X.b), (Y.a, Y.b), (Z.a, Z.b)).

The products of each dependency level are stacked into one mont_mul
(`mul_many`), so a point op makes a few wide K1 launches instead of a dozen
narrow ones. Each add, double and mixed add counts one "point_ops" in
the open metrics spans (zksnake_tpu_torch.metrics.count), whatever the
batch.
"""

import numpy as np
import torch

from .. import metrics
from .field import (
    DTYPE,
    FieldSpec,
    _expand,
    broadcast_shapes,
    eq_zero,
    mod_add,
    mod_neg,
    mod_sub,
    mont_inv,
    mont_inv_batch,
    mont_mul,
)


def _stack_parts(fs, rows):
    """rows of equally many (nl, *batch_i) tensors -> one (nl, k, *batch)
    stack per position, batch dims broadcast."""
    batch = broadcast_shapes(*[t.shape[1:] for row in rows for t in row])
    return [
        torch.stack([_expand(row[j], fs.nl, batch) for row in rows], dim=1)
        for j in range(len(rows[0]))
    ]


def _stacked(fs, fn, pairs):
    """fn (mod_add or mod_sub) of k independent pairs as one stacked call."""
    if len(pairs) == 1:
        return [fn(fs, *pairs[0])]
    xs, ys = _stack_parts(fs, pairs)
    return list(fn(fs, xs, ys).unbind(1))


def _stacked2(fs, fn, pairs):
    """The same over Fq2 pairs: both parts of every pair in one call."""
    flat = [(a[j], b[j]) for a, b in pairs for j in (0, 1)]
    out = _stacked(fs, fn, flat)
    return [(out[2 * i], out[2 * i + 1]) for i in range(len(pairs))]


class DevFq:
    """Prime-field coordinate arithmetic on (nl, ...) limbs."""

    def __init__(self, fs: FieldSpec, plain=False):
        self.fs = fs
        self.plain = plain

    def mul(self, a, b):
        return mont_mul(self.fs, a, b, plain=self.plain)

    def mul_many(self, pairs):
        """k independent products as ONE stacked mont_mul."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        xs, ys = _stack_parts(self.fs, pairs)
        return list(self.mul(xs, ys).unbind(1))

    def add(self, a, b):
        return mod_add(self.fs, a, b)

    def sub(self, a, b):
        return mod_sub(self.fs, a, b)

    def add_many(self, pairs):
        return _stacked(self.fs, mod_add, pairs)

    def sub_many(self, pairs):
        return _stacked(self.fs, mod_sub, pairs)

    def neg(self, a):
        return mod_neg(self.fs, a)

    def zeros(self, shape, device):
        return torch.zeros((self.fs.nl,) + tuple(shape), dtype=DTYPE, device=device)

    def one(self, shape, device):
        return self.fs.one_mont_dev(shape, device).contiguous()

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(0), a, b)

    def is_zero(self, a):
        return eq_zero(self.fs, a)

    def const(self, v, device):
        """Host int -> Montgomery limb constant of shape (nl,)."""
        return self.fs.const_mont(v, device, 0)


class DevFq2:
    """Fq2 = Fq[u]/(u^2 + 1) arithmetic on pairs of (nl, ...) limb tensors."""

    def __init__(self, fs: FieldSpec, plain=False):
        self.fs = fs
        self.plain = plain

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """Karatsuba products of all pairs: one stacked mod_add for the
        (a0 + a1, b0 + b1) sums, one stacked mont_mul for the 3k base-field
        products, two stacked mod_subs for the recombination."""
        fs = self.fs
        k = len(pairs)
        A0, A1, B0, B1 = _stack_parts(fs, [(a[0], a[1], b[0], b[1]) for a, b in pairs])
        S = mod_add(fs, torch.cat([A0, B0], dim=1), torch.cat([A1, B1], dim=1))
        prod = mont_mul(fs, torch.cat([A0, A1, S[:, :k]], dim=1),
                        torch.cat([B0, B1, S[:, k:]], dim=1), plain=self.plain)
        t0, t1, t2 = prod[:, :k], prod[:, k:2 * k], prod[:, 2 * k:]
        d = mod_sub(fs, torch.cat([t0, t2], dim=1), torch.cat([t1, t0], dim=1))
        c0, c1 = d[:, :k], mod_sub(fs, d[:, k:], t1)  # t0 - t1, t2 - t0 - t1
        return [(c0[:, i], c1[:, i]) for i in range(k)]

    def add(self, a, b):
        return self.add_many([(a, b)])[0]

    def sub(self, a, b):
        return self.sub_many([(a, b)])[0]

    def add_many(self, pairs):
        return _stacked2(self.fs, mod_add, pairs)

    def sub_many(self, pairs):
        return _stacked2(self.fs, mod_sub, pairs)

    def neg(self, a):
        return (mod_neg(self.fs, a[0]), mod_neg(self.fs, a[1]))

    def zeros(self, shape, device):
        z = torch.zeros((self.fs.nl,) + tuple(shape), dtype=DTYPE, device=device)
        return (z, z)

    def one(self, shape, device):
        return (self.fs.one_mont_dev(shape, device).contiguous(),
                torch.zeros((self.fs.nl,) + tuple(shape), dtype=DTYPE, device=device))

    def select(self, cond, a, b):
        c = cond.unsqueeze(0)
        return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]))

    def is_zero(self, a):
        return eq_zero(self.fs, a[0]) & eq_zero(self.fs, a[1])

    def const(self, v, device):
        """Host (c0, c1) tuple -> Montgomery limb constants of shape (nl,)."""
        return (self.fs.const_mont(v[0], device, 0), self.fs.const_mont(v[1], device, 0))


class GroupSpec:
    """One curve group's device arithmetic. `plain` selects a plain
    mont_mul on every device (the reference a kernel is checked against):
    True K1's, "mma" K3's (field.mont_mul)."""

    def __init__(self, curve, group, plain=False):
        self.curve = curve
        self.group = group
        self.is_plain = plain
        self.fs = FieldSpec.get(curve.p)
        if group == 1:
            self.F = DevFq(self.fs, plain)
            self._b3_val = 3 * curve.b % curve.p
        else:
            self.F = DevFq2(self.fs, plain)
            b2 = curve.b2
            self._b3_val = (3 * b2[0] % curve.p, 3 * b2[1] % curve.p)
        self._b3_words = None

    def plain(self, mode=True):
        return get_group_spec(self.curve, self.group, plain=mode)

    def b3(self, device):
        return self.F.const(self._b3_val, device)

    def b3_small(self):
        """3b as a small integer k where it is one (G1: 3b = k; G2: 3b =
        k + k u), else 0: K2 then multiplies by 3b with additions."""
        v = self._b3_val
        k = v if self.group == 1 else (v[0] if v[0] == v[1] else 0)
        return k if 0 < k < 64 else 0

    def b3_words(self):
        """ctypes uint32 words of 3b in Montgomery form, for K2."""
        if self._b3_words is None:
            import ctypes

            fs = self.fs
            vals = [self._b3_val] if self.group == 1 else list(self._b3_val)
            words = []
            for v in vals:
                m = v * fs.R % fs.p
                words.extend((m >> (32 * i)) & 0xFFFFFFFF for i in range(fs.nl // 2))
            self._b3_words = (ctypes.c_uint32 * len(words))(*words)
        return self._b3_words

    # ---------- pytree helpers ----------
    def leaves(self, P):
        """Point (or coordinate tuple) -> flat list of limb tensors."""
        if self.group == 1:
            return list(P)
        return [t for coord in P for t in coord]

    def unflatten(self, leaves):
        if self.group == 1:
            return tuple(leaves)
        return tuple((leaves[2 * i], leaves[2 * i + 1]) for i in range(len(leaves) // 2))

    def map(self, fn, *Ps):
        """Apply fn leaf-wise across points of the same structure."""
        return self.unflatten([fn(*ts) for ts in zip(*[self.leaves(P) for P in Ps])])

    def cmap(self, fn, v):
        """Apply fn to each limb tensor of one coordinate."""
        return fn(v) if self.group == 1 else tuple(fn(t) for t in v)

    def identity(self, shape, device):
        F = self.F
        return (F.zeros(shape, device), F.one(shape, device), F.zeros(shape, device))

    # ---------- formulas ----------
    def add(self, P, Q):
        """Complete projective addition (RCB15 Algorithm 7, a = 0)."""
        metrics.count("point_ops")
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        b3 = self.b3(self.leaves(P)[0].device)
        xy1, xy2, yz1, yz2, xz1, xz2 = F.add_many(
            [(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2)]
        )
        t0, t1, t2, s3, s4, s5 = F.mul_many(
            [(X1, X2), (Y1, Y2), (Z1, Z2), (xy1, xy2), (yz1, yz2), (xz1, xz2)]
        )
        u01, u12, u02, t0_2 = F.add_many([(t0, t1), (t1, t2), (t0, t2), (t0, t0)])
        t3, t4, t5 = F.sub_many([(s3, u01), (s4, u12), (s5, u02)])  # X1Y2 + X2Y1, ...
        t0_3 = F.add(t0_2, t0)  # 3 X1X2
        t2b, y3p = F.mul_many([(b3, t2), (b3, t5)])
        z3s = F.add(t1, t2b)
        t1m = F.sub(t1, t2b)
        x3a, x3b, y3a, y3b, z3a, z3b = F.mul_many(
            [(t3, t1m), (t4, y3p), (y3p, t0_3), (t1m, z3s), (z3s, t4), (t0_3, t3)]
        )
        y3, z3 = F.add_many([(y3a, y3b), (z3a, z3b)])
        return (F.sub(x3a, x3b), y3, z3)

    def double(self, P):
        """Complete doubling (RCB15 Algorithm 9, a = 0)."""
        metrics.count("point_ops")
        F = self.F
        X, Y, Z = P
        b3 = self.b3(self.leaves(P)[0].device)
        t0, t1, t2 = F.mul_many([(Y, Y), (Y, Z), (Z, Z)])
        t0_2 = F.add(t0, t0)
        z3 = F.add(t0_2, t0_2)
        z3 = F.add(z3, z3)  # 8 Y^2
        t2b = F.mul(b3, t2)
        x3, z3, txy = F.mul_many([(t2b, z3), (t1, z3), (X, Y)])
        y3, t2b_2 = F.add_many([(t0, t2b), (t2b, t2b)])
        t0 = F.sub(t0, F.add(t2b_2, t2b))  # Y^2 - 3 b3 Z^2
        y3m, x3m = F.mul_many([(t0, y3), (t0, txy)])
        x3, y3 = F.add_many([(x3m, x3m), (x3, y3m)])
        return (x3, y3, z3)

    def add_affine(self, P, Q):
        """Complete mixed addition (RCB15 Algorithm 8, a = 0): Q = (X2, Y2)
        affine with Z2 = 1. Q must not be the identity (mask it in the
        caller's select); P may be anything, including Q or -Q."""
        metrics.count("point_ops")
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2 = Q
        b3 = self.b3(self.leaves(P)[0].device)
        xy1, xy2 = F.add_many([(X1, Y1), (X2, Y2)])
        t0, t1, s3, y2z1, x2z1 = F.mul_many(
            [(X1, X2), (Y1, Y2), (xy1, xy2), (Y2, Z1), (X2, Z1)]
        )
        # Y1Z2 + Y2Z1 and X1Z2 + X2Z1 (Z2 = 1), t0 + t1, 2 X1X2
        t4, t5, u01, t0_2 = F.add_many([(y2z1, Y1), (x2z1, X1), (t0, t1), (t0, t0)])
        t3 = F.sub(s3, u01)  # X1Y2 + X2Y1
        t0_3 = F.add(t0_2, t0)  # 3 X1X2
        t2b, y3p = F.mul_many([(b3, Z1), (b3, t5)])
        z3s = F.add(t1, t2b)
        t1m = F.sub(t1, t2b)
        x3a, x3b, y3a, y3b, z3a, z3b = F.mul_many(
            [(t3, t1m), (t4, y3p), (y3p, t0_3), (t1m, z3s), (z3s, t4), (t0_3, t3)]
        )
        y3, z3 = F.add_many([(y3a, y3b), (z3a, z3b)])
        return (F.sub(x3a, x3b), y3, z3)

    def to_affine(self, P):
        """Projective -> ((X/Z, Y/Z), inf_mask) with one batched inversion
        (Z = 0 lanes are reported in the mask; their coordinates are
        garbage by contract)."""
        fs = self.fs

        def _inv(x):
            if x.ndim == 2 and x.shape[1] > 1:
                return mont_inv_batch(fs, x)
            return mont_inv(fs, x)

        X, Y, Z = P
        inf = self.F.is_zero(Z)
        if self.group == 1:
            zi = _inv(torch.where(inf.unsqueeze(0), fs.one_mont_dev(Z.shape[1:], Z.device), Z))
        else:
            z0, z1 = Z
            norm = mod_add(fs, mont_mul(fs, z0, z0, self.is_plain),
                           mont_mul(fs, z1, z1, self.is_plain))
            ninv = _inv(torch.where(inf.unsqueeze(0), fs.one_mont_dev(z0.shape[1:], z0.device), norm))
            zi = (mont_mul(fs, z0, ninv, self.is_plain),
                  mont_mul(fs, mod_neg(fs, z1), ninv, self.is_plain))
        ax, ay = self.F.mul_many([(X, zi), (Y, zi)])
        return (ax, ay), inf

    def normalize(self, P):
        """Projective -> affine with Z in {0, 1} (the layout Pippenger's mixed
        adds and points_to_device use)."""
        (ax, ay), inf = self.to_affine(P)
        dev = inf.device
        Z = self.F.select(inf, self.F.zeros(inf.shape, dev), self.F.one(inf.shape, dev))
        return (ax, ay, Z)

    def _neg_coord(self, Y):
        """-Y of a coordinate (the MSM's negative digits)."""
        return self.F.neg(Y)

    def select(self, cond, P, Q):
        return tuple(self.F.select(cond, a, b) for a, b in zip(P, Q))

    def equal(self, P, Q):
        """Lane mask: P and Q are the same point, X1 Z2 = X2 Z1 and
        Y1 Z2 = Y2 Z1, both or neither at infinity (Z = 0), and neither
        (0 : 0 : 0), which is no point (for points on the curve; products
        are canonical, so equal elements have equal limbs)."""
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        a, b, c, d = self.F.mul_many([(X1, Z2), (X2, Z1), (Y1, Z2), (Y2, Z1)])

        def same(u, v):
            parts = zip(u, v) if self.group == 2 else [(u, v)]
            return torch.stack([(x == y).all(0) for x, y in parts]).all(0)

        def zero(u):
            parts = u if self.group == 2 else (u,)
            return torch.stack([(x == 0).all(0) for x in parts]).all(0)

        some1 = ~(zero(X1) & zero(Y1) & zero(Z1))
        some2 = ~(zero(X2) & zero(Y2) & zero(Z2))
        return same(a, b) & same(c, d) & (zero(Z1) == zero(Z2)) & some1 & some2

    # ---------- host <-> device conversion ----------
    def _batch_affine(self, points):
        """Affine coords of host points via ONE batched inversion."""
        from ..curves.tower import Fq2Ops
        from ..utils import batch_modinv

        p = self.fs.p
        idxs, zs = [], []
        for i, pt in enumerate(points):
            if pt._affine_cache is None:
                z = pt._jac[2]
                if self.group == 1:
                    if z != 0:
                        idxs.append(i)
                        zs.append(z)
                elif z != (0, 0):
                    idxs.append(i)
                    zs.append((z[0] * z[0] + z[1] * z[1]) % p)  # 1/z = conj(z)/norm
        if idxs:
            invs = batch_modinv(zs, p)
            if self.group == 1:
                for i, zinv in zip(idxs, invs):
                    X, Y, _ = points[i]._jac
                    zi2 = zinv * zinv % p
                    points[i]._affine_cache = ((X * zi2 % p, Y * zi2 % p * zinv % p),)
            else:
                f2 = Fq2Ops(p)
                for i, ninv in zip(idxs, invs):
                    X, Y, Z = points[i]._jac
                    zinv = (Z[0] * ninv % p, -Z[1] * ninv % p)
                    zi2 = f2.sqr(zinv)
                    points[i]._affine_cache = (
                        (f2.mul(X, zi2), f2.mul(Y, f2.mul(zi2, zinv))),
                    )
        return [pt._affine() for pt in points]

    def points_to_device(self, points, device):
        """Host PointG1/PointG2 list -> projective Montgomery limb tensors
        (nl, n) per coordinate, affine with Z in {0, 1}."""
        fs = self.fs
        n = len(points)
        affs = self._batch_affine(points)
        inf = np.array([a is None for a in affs])

        def dev(vals):
            return fs.to_device(fs.to_mont_host(vals), device)

        zcol = np.where(
            inf[None, :], np.zeros((fs.nl, n), np.uint32),
            np.broadcast_to(fs.one_mont[:, None], (fs.nl, n)),
        )
        Z = fs.to_device(zcol, device)
        if self.group == 1:
            X = dev([0 if a is None else a[0] for a in affs])
            Y = dev([1 if a is None else a[1] for a in affs])
            return (X, Y, Z)
        X = (dev([0 if a is None else a[0][0] for a in affs]),
             dev([0 if a is None else a[0][1] for a in affs]))
        Y = (dev([1 if a is None else a[1][0] for a in affs]),
             dev([0 if a is None else a[1][1] for a in affs]))
        return (X, Y, (Z, torch.zeros_like(Z)))

    def points_from_device(self, P, point_cls):
        """Projective limb tensors (nl, n) -> list of host points."""
        fs = self.fs
        p = fs.p
        vals = [fs.from_mont_host(t.reshape(fs.nl, -1)) for t in self.leaves(P)]
        out = []
        if self.group == 1:
            for x, y, z in zip(*vals):
                if z == 0:
                    out.append(point_cls.identity())
                else:
                    # homogeneous (X:Y:Z) -> Jacobian (X*Z, Y*Z^2, Z)
                    out.append(point_cls._from_jac((x * z % p, y * z % p * z % p, z)))
            return out
        from ..curves.tower import Fq2Ops

        f2 = Fq2Ops(p)
        for x0, x1, y0, y1, z0, z1 in zip(*vals):
            z = (z0, z1)
            if z == (0, 0):
                out.append(point_cls.identity())
            else:
                out.append(point_cls._from_jac(
                    (f2.mul((x0, x1), z), f2.mul((y0, y1), f2.sqr(z)), z)
                ))
        return out


_GROUP_SPECS = {}


def get_group_spec(curve, group, plain=False):
    key = (curve.name, group, plain)
    if key not in _GROUP_SPECS:
        _GROUP_SPECS[key] = GroupSpec(curve, group, plain)
    return _GROUP_SPECS[key]
