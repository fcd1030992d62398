"""Point arithmetic of the PyTorch port against the JAX package.

BN254 G1 and G2 at 8 lanes through zksnake_tpu.backend.curve_ops (JAX,
eager on the CPU) and zksnake_tpu_torch.backend.curve_ops (device="cpu").
Both run the same RCB15 formulas on canonical field elements, so every
output coordinate matches limb for limb. The lanes include the identity,
P + P and P + (-P). Each package gets the points and curve parameters of
its own curve module, made from the same scalars.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zksnake_tpu.backend.curve_ops import get_group_spec as jax_group
from zksnake_tpu.curves import ec_bn254
from zksnake_tpu_torch.backend.curve_ops import get_group_spec as torch_group

from torch_support import CURVE, PORT

JAX_CURVE = ec_bn254._curve


def host_points(group, seed, module=PORT):
    """P lanes, Q lanes (Q never the identity) and the lane pattern:
    lane 0 P = identity, lane 1 Q = P (doubling), lane 2 Q = -P; as points of
    `module` (the port's curve module, or the JAX package's)."""
    gen = module.g1() if group == 1 else module.g2()
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 40, size=16)]
    P = [gen * k for k in ks[:8]]
    Q = [gen * k for k in ks[8:]]
    P[0] = type(gen).identity()
    Q[1] = P[1]
    Q[2] = -P[2]
    return P, Q


def projective(gs_t, gs_j, pts):
    """The same projective (Z != 1) inputs for both packages: host points
    moved to the device and doubled there by the port (its doubling is
    held against the JAX package's below)."""
    Pt = gs_t.double(gs_t.points_to_device(pts, "cpu"))
    Pj = gs_t.unflatten([jnp.asarray(t.numpy().astype(np.uint32)) for t in gs_t.leaves(Pt)])
    return Pj, Pt


def same(Pj, Pt, gs_t):
    lj = [np.asarray(t).astype(np.int64) for t in jax.tree_util.tree_leaves(Pj)]
    lt = [t.numpy().astype(np.int64) for t in gs_t.leaves(Pt)]
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("group", [1, 2])
def test_add_double_add_affine_match_jax(group):
    gs_j, gs_t = jax_group(JAX_CURVE, group), torch_group(CURVE, group)
    P, Q = host_points(group, group)
    Pj, Pt = projective(gs_t, gs_j, P)
    Qj, Qt = projective(gs_t, gs_j, Q)
    same(gs_j.add(Pj, Qj), gs_t.add(Pt, Qt), gs_t)
    same(gs_j.double(Pj), gs_t.double(Pt), gs_t)
    # mixed add of the affine 2Q: lane 1 doubles, lane 2 cancels
    Q2 = [q + q for q in Q]
    P_jax, Q_jax = host_points(group, group, ec_bn254)
    Qa_j = gs_j.points_to_device([q + q for q in Q_jax])
    assert [q.to_bytes() for q in Q_jax] == [q.to_bytes() for q in Q]
    Qa_t = gs_t.points_to_device(Q2, "cpu")
    same(gs_j.add_affine(Pj, Qa_j[:2]), gs_t.add_affine(Pt, Qa_t[:2]), gs_t)
    got = gs_t.points_from_device(gs_t.add_affine(Pt, Qa_t[:2]), type(P[0]))
    want = [p + p + q + q for p, q in zip(P_jax, Q_jax)]  # the JAX host's sums
    assert [g.to_bytes() for g in got] == [w.to_bytes() for w in want]
    assert want[2].to_bytes() == type(P_jax[0]).identity().to_bytes()


def test_to_affine_matches_jax_g1():
    gs_j, gs_t = jax_group(JAX_CURVE, 1), torch_group(CURVE, 1)
    P, _ = host_points(1, 3)
    Pj, Pt = projective(gs_t, gs_j, P)
    (xj, yj), inf_j = gs_j.to_affine(Pj)
    (xt, yt), inf_t = gs_t.to_affine(Pt)
    np.testing.assert_array_equal(np.asarray(inf_j), inf_t.numpy())
    live = ~inf_t.numpy()
    for a, b in ((xj, xt), (yj, yt)):
        np.testing.assert_array_equal(np.asarray(a)[:, live].astype(np.int64),
                                      b.numpy()[:, live].astype(np.int64))


def test_to_affine_matches_host_g2():
    """Against the JAX package's host doubling of the same points."""
    gs_t = torch_group(CURVE, 2)
    P, _ = host_points(2, 4)
    Pt = gs_t.double(gs_t.points_to_device(P, "cpu"))
    (xt, yt), inf = gs_t.to_affine(Pt)
    fs = gs_t.fs
    P_jax, _ = host_points(2, 4, ec_bn254)
    for i, pt in enumerate(P_jax):
        dbl = pt + pt
        assert bool(inf[i]) == (dbl._affine() is None)
        if inf[i]:
            continue
        x, y = dbl._affine()
        assert (fs.from_mont_host(xt[0][:, i:i + 1])[0], fs.from_mont_host(xt[1][:, i:i + 1])[0]) == x
        assert (fs.from_mont_host(yt[0][:, i:i + 1])[0], fs.from_mont_host(yt[1][:, i:i + 1])[0]) == y


@pytest.mark.parametrize("group", [1, 2])
def test_points_round_trip(group):
    gs_t = torch_group(CURVE, group)
    P, _ = host_points(group, 5)
    assert gs_t.points_from_device(gs_t.points_to_device(P, "cpu"), type(P[0])) == P
