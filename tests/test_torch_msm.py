"""MSM of the PyTorch port against the JAX package and the host oracle.

- K2's plain version (zksnake_tpu_torch.backend.kernels.
  bucket_accumulate_plain) against the Pallas bucket kernel it replaces, in
  interpret mode, on the same sorted runs (G1, R = 3 rounds, B = 8 buckets);
  for G2 against the JAX package's per-round masked add loop, run eagerly.
  Both add each run in rank order with the same formula: the projective
  buckets match limb for limb.
- msm_pippenger against zksnake_tpu.backend.dispatch._host_msm (the host
  bigint oracle), G1 and G2, with identity points, zero scalars, r - 1 and
  a long run of repeated scalars: the port's points and the JAX package's
  are made from the same scalars, each by its own curve module, and the
  results are compared as compressed bytes.
- fixed-base and per-lane batch scalar multiplication against the JAX
  package's host g * s on the same scalars, compared as compressed bytes.
- the fixed-base MSM path (a FixedBaseTable of shifted bases, one window
  an MSM) against the plain path and the host oracle, as points; the
  table's rows against host doublings; the rule for its window size.

Everything runs on device="cpu" (the kernels' plain versions).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zksnake_tpu.backend.curve_ops import get_group_spec as jax_group
from zksnake_tpu.backend.dispatch import _host_msm
from zksnake_tpu.curves import ec_bls12_381, ec_bn254
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend import msm as tmsm
from zksnake_tpu_torch.backend.curve_ops import get_group_spec as torch_group
from zksnake_tpu_torch.backend.field import FieldSpec
from zksnake_tpu_torch.curves import get_curve_module
from zksnake_tpu_torch.ecc import EllipticCurve

from torch_support import CURVE, CURVES, PORT

JAX_CURVE = ec_bn254._curve


def gen_of(module, group):
    return module.g1() if group == 1 else module.g2()


def chain(gen, n, step_k, identities=()):
    """n distinct host points k0 G, (k0 + step) G, ... by host additions;
    the listed lanes are the identity."""
    out = []
    P = gen * 7
    step = gen * step_k
    for i in range(n):
        out.append(type(gen).identity() if i in identities else P)
        P = P + step
    return out


def sorted_runs(seed, B=8, R=3):
    """Run lengths (bucket 0 full, bucket 1 empty) and their starts."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, R + 1, size=B)
    lens[0], lens[1] = R, 0
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return starts.astype(np.int32), lens.astype(np.int32)


def port_buckets(gs_t, points, starts, lens):
    X, Y, _ = gs_t.points_to_device(points, "cpu")
    leaves = ([X] if gs_t.group == 1 else list(X)) + ([Y] if gs_t.group == 1 else list(Y))
    pts = torch.stack(leaves)[:, :, None, :].contiguous()  # (L, nl, W=1, n)
    out = kernels.bucket_accumulate_plain(
        gs_t, pts, torch.from_numpy(starts)[None], torch.from_numpy(lens)[None]
    )
    return [o[:, 0].numpy().astype(np.int64) for o in out], leaves


def test_bucket_plain_matches_pallas_kernel_g1(monkeypatch):
    monkeypatch.setenv("ZKSNAKE_PALLAS_INTERPRET", "1")
    from zksnake_tpu.backend import pallas_field

    R, B = 3, 8
    gs_j, gs_t = jax_group(JAX_CURVE, 1), torch_group(CURVE, 1)
    starts, lens = sorted_runs(11, B, R)
    points = chain(PORT.g1(), int(lens.sum()), 5)
    got, leaves = port_buckets(gs_t, points, starts, lens)
    # the Pallas kernel's packed round-major table of the same runs
    nl = gs_t.fs.nl
    PL = nl // 2
    table = np.zeros((R, 2 * PL, B), np.uint32)
    valid = np.zeros((R, B), np.int32)
    for k in range(R):
        for b in range(B):
            if k < lens[b]:
                valid[k, b] = 1
                for i, leaf in enumerate(leaves):
                    col = leaf[:, starts[b] + k].numpy().astype(np.uint32)
                    table[k, i * PL:(i + 1) * PL, b] = col[0::2] | (col[1::2] << 16)
    want = pallas_field.bucket_accumulate_pallas(
        gs_j, jnp.asarray(table), jnp.asarray(valid), R, B
    )
    for a, b in zip(jax.tree_util.tree_leaves(want), got):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b)


def test_bucket_plain_matches_jax_round_loop_g2():
    R, B = 3, 8
    gs_j, gs_t = jax_group(JAX_CURVE, 2), torch_group(CURVE, 2)
    starts, lens = sorted_runs(12, B, R)
    points = chain(PORT.g2(), int(lens.sum()), 3)
    got, leaves = port_buckets(gs_t, points, starts, lens)
    bucket = gs_j.identity((B,))
    n = int(lens.sum())
    for k in range(R):
        pos = np.minimum(starts + k, n - 1)
        X0, X1, Y0, Y1 = [jnp.asarray(l.numpy()[:, pos].astype(np.uint32)) for l in leaves]
        cand = gs_j.add_affine(bucket, ((X0, X1), (Y0, Y1)))
        bucket = gs_j.select(jnp.asarray(k < lens), cand, bucket)
    for a, b in zip(jax.tree_util.tree_leaves(bucket), got):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_bucket_mma_plain_matches_k2_plain(curve, group):
    """K2m's plain version (every product through K3's plain version)
    equals K2's limb for limb on seeded ragged runs over two windows, with
    empty buckets."""
    module = get_curve_module(curve, "cpu")
    gs_t = torch_group(module._curve, group)
    runs = [sorted_runs(20 + w + group, B=8, R=4) for w in range(2)]
    n = max(int(lens.sum()) for _, lens in runs)
    points = chain(gen_of(module, group), n, 7 + group)
    X, Y, _ = gs_t.points_to_device(points, "cpu")
    leaves = ([X] if group == 1 else list(X)) + ([Y] if group == 1 else list(Y))
    # window 1 reads the points in reverse order
    pts = torch.stack([torch.stack([t, t.flip(1)], dim=1) for t in leaves]).contiguous()
    starts = torch.from_numpy(np.stack([s for s, _ in runs]))
    lens = torch.from_numpy(np.stack([l for _, l in runs]))
    assert int((lens == 0).sum()) >= 2
    want = kernels.bucket_accumulate_plain(gs_t, pts, starts, lens, affine=True)
    got = kernels.bucket_accumulate_mma(gs_t, pts, starts, lens)  # the CPU route
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", [1, 2])
def test_msm_under_mxu_flag_matches_host_oracle(group, monkeypatch):
    """ZKSNAKE_MXU_MONTMUL=1 (lane threshold lowered): bucket sums through
    K2m's route, flat products through K3's; same MSM."""
    from zksnake_tpu_torch.backend import field as torch_field

    monkeypatch.setenv("ZKSNAKE_MXU_MONTMUL", "1")
    monkeypatch.setattr(torch_field, "MXU_MIN_LANES", 16)
    calls = []
    orig = kernels.bucket_accumulate_mma
    monkeypatch.setattr(kernels, "bucket_accumulate_mma",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(kernels, "bucket_accumulate", None)  # K2 must not run
    points, scalars = msm_case(group, 64, 30 + group)
    got = tmsm.msm_device(CURVE, group, points, scalars, type(points[0]), "cpu")
    jax_points, _ = msm_case(group, 64, 30 + group, ec_bn254)
    assert got.to_bytes() == _host_msm(ec_bn254, jax_points, scalars).to_bytes()
    assert calls == [1]


def msm_case(group, n, seed, module=PORT):
    """Points of `module` and scalars of one MSM case."""
    points = chain(gen_of(module, group), n, 11 + seed, identities={3, n - 1})
    rng = np.random.default_rng(seed)
    r = CURVE.r
    scalars = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
    scalars[0] = 0
    scalars[1] = r - 1
    scalars[2] = 1
    rep = scalars[5]
    for i in range(6, 36):  # a run of 30 repeats: one long bucket run
        scalars[i] = rep
    return points, scalars


@pytest.mark.parametrize("group", [1, 2])
def test_msm_matches_host_oracle_small(group):
    points, scalars = msm_case(group, 64, group)
    cls = type(points[0])
    got = tmsm.msm_device(CURVE, group, points, scalars, cls, "cpu")
    jax_points, _ = msm_case(group, 64, group, ec_bn254)
    assert got.to_bytes() == _host_msm(ec_bn254, jax_points, scalars).to_bytes()


@pytest.mark.parametrize("group", [1, 2])
def test_msm_through_ecc_matches_host_oracle(group):
    """n = 300 is past the dispatch threshold: EllipticCurve.multiexp runs
    the port's Pippenger on the given device."""
    points, scalars = msm_case(group, 300, 10 + group)
    got = EllipticCurve("BN254", device="cpu").multiexp(points, scalars)
    jax_points, _ = msm_case(group, 300, 10 + group, ec_bn254)
    assert got.to_bytes() == _host_msm(ec_bn254, jax_points, scalars).to_bytes()


@pytest.mark.parametrize("group", [1, 2])
def test_fixed_base_batch_mul_matches_host(group):
    gen = gen_of(PORT, group)
    r = CURVE.r
    scalars = [0, 1, 2, r - 1, 0xDEADBEEF, r // 3, (1 << 200) + 5, 255]
    got = tmsm.batch_mul_fixed_base(CURVE, group, gen, scalars, type(gen), "cpu")
    jax_gen = gen_of(ec_bn254, group)
    assert [p.to_bytes() for p in got] == [(jax_gen * s).to_bytes() for s in scalars]


def test_per_lane_batch_mul_matches_host():
    points = chain(PORT.g1(), 4, 9, identities={2})
    scalars = [3, CURVE.r - 2, 77, 0]
    got = tmsm.batch_mul_device(CURVE, 1, points, scalars, type(points[0]), "cpu")
    jax_points = chain(ec_bn254.g1(), 4, 9, identities={2})
    want = [(p * s).to_bytes() for p, s in zip(jax_points, scalars)]
    assert [p.to_bytes() for p in got] == want


def test_signed_digits_recompose():
    """Balanced window digits (high window first) recompose every scalar."""
    r = CURVE.r
    scalars = [0, 1, r - 1, r // 2, 12345678901234567890]
    s = tmsm.scalars_to_device(scalars, r, "cpu")
    for c in (3, 4, 7, 11, 13):
        d = tmsm._signed_window_digits(s, c, 256)
        assert int(d.abs().max()) <= 1 << (c - 1)
        for i, v in enumerate(scalars):
            acc = 0
            for w in range(d.shape[0]):
                acc = (acc << c) + int(d[w, i])
            assert acc == v


def test_msms_over_the_same_points_are_sorted_in_groups(monkeypatch):
    """msm_pippenger_many sorts and accumulates the MSMs over one set of
    points together (sort_by_digit on (SL, G, n) scalar limbs, their
    windows side by side), in groups cut by SORT_GROUP_ELEMS, and every
    result equals the MSM's alone limb for limb: five MSMs over 40 points
    (in groups of 2, 2 and 1 under a budget of two), two over a view of
    their first 32, one over other points."""
    gs = torch_group(CURVE, 1)
    c = 4
    W = -(-256 // c)
    points, _ = msm_case(1, 40, 5)
    other, _ = msm_case(1, 40, 6)
    P = gs.points_to_device(points, "cpu")
    Q = gs.points_to_device(other, "cpu")
    head = gs.map(lambda t: t[:, :32], P)
    rng = np.random.default_rng(7)
    scal = lambda n: tmsm.scalars_to_device(  # noqa: E731
        [int.from_bytes(rng.bytes(32), "little") for _ in range(n)], CURVE.r, "cpu")
    jobs = ([(P, scal(40)) for _ in range(3)] + [(head, scal(32)), (Q, scal(40))]
            + [(P, scal(40)) for _ in range(2)] + [(head, scal(32))])
    monkeypatch.setattr(tmsm, "SORT_GROUP_ELEMS", 2 * 2 * gs.fs.nl * W * 40)
    assert tmsm._job_groups(gs, jobs, c) == [[0, 1], [2, 5], [3, 7], [4], [6]]
    sorts = []
    real = tmsm.sort_by_digit
    monkeypatch.setattr(tmsm, "sort_by_digit",
                        lambda gs_, P_, s, c_: sorts.append(s.shape) or real(gs_, P_, s, c_))
    got = tmsm.msm_pippenger_many(gs, jobs, c)
    assert sorts == [(16, 2, 40), (16, 2, 40), (16, 2, 32), (16, 40), (16, 40)]
    for m, (Pj, s) in enumerate(jobs):
        alone = tmsm.msm_pippenger_many(gs, [(Pj, s)], c)
        for a, b in zip(gs.leaves(got), gs.leaves(alone)):
            assert torch.equal(a[:, m], b[:, 0])


# ---- the fixed-base path ----

JAX_MODULES = {"BN254": ec_bn254, "BLS12_381": ec_bls12_381}


def fixed_case(curve, group, n):
    """The port's group spec and n bases k0 G, (k0 + 13) G, ... (lane 3 the
    identity), made by the port's and by the JAX package's curve module."""
    port = get_curve_module(curve, "cpu")
    gs = torch_group(port._curve, group)
    return (gs, chain(gen_of(port, group), n, 13, identities={3}),
            chain(gen_of(JAX_MODULES[curve], group), n, 13, identities={3}))


def table_rows(gs, table, y, cls):
    """The table's points with Y (y = 0) or -Y (y = 1), host points by row."""
    nl, W, N = gs.fs.nl, table.W, table.N
    X = gs.cmap(lambda t: t.reshape(nl, W * N), table.x)
    Y = gs.cmap(lambda t: t[:, y].reshape(nl, W * N), table.y2)
    one = torch.from_numpy(gs.fs.one_mont.astype(np.int32))[:, None].expand(nl, W * N)
    Z1 = torch.where(table.inf.reshape(1, -1), 0, one)
    Z = Z1 if gs.group == 1 else (Z1, torch.zeros_like(Z1))
    pts = gs.points_from_device((X, Y, Z), cls)
    return [pts[w * N:(w + 1) * N] for w in range(W)]


def with_window(monkeypatch, c):
    """Tables made from here on take window size c."""
    monkeypatch.setattr(tmsm, "fixed_base_window", lambda n, nbits: c)


@pytest.mark.parametrize("curve", CURVES)
def test_fixed_base_table_rows_are_host_doublings(curve, monkeypatch):
    """Row w of the table holds 2^(c w) P_i, and its -Y half -2^(c w) P_i,
    the identity base the identity in every row: the JAX package's points
    doubled c w times, as compressed bytes."""
    gs, points, jax_points = fixed_case(curve, 1, 6)
    c = 5
    with_window(monkeypatch, c)
    table = tmsm.fixed_base_table(gs, gs.points_to_device(points, "cpu"))
    W = -(-16 * FieldSpec.get(gs.curve.r).nl // c)
    assert (table.c, table.W, table.N, table.n) == (c, W, 6, 6)
    assert table.x.shape == (gs.fs.nl, W, 6) and table.y2.shape == (gs.fs.nl, 2, W, 6)
    assert torch.equal(table.inf, torch.tensor([[i == 3 for i in range(6)]] * W))
    row = jax_points
    cls = type(points[0])
    for got, neg in zip(table_rows(gs, table, 0, cls), table_rows(gs, table, 1, cls)):
        assert [q.to_bytes() for q in got] == [p.to_bytes() for p in row]
        assert ([q.to_bytes() for i, q in enumerate(neg) if i != 3]
                == [(-p).to_bytes() for i, p in enumerate(row) if i != 3])
        for _ in range(c):
            row = [p + p for p in row]
    assert table.prefix(4).n == 4 and table.prefix(4).x is table.x
    with pytest.raises(ValueError):
        table.prefix(7)


@pytest.mark.parametrize("curve,group,c", [("BN254", 1, 4), ("BN254", 1, 5), ("BLS12_381", 1, 4),
                                            ("BLS12_381", 1, 5), ("BN254", 2, 5)])
def test_fixed_base_msm_matches_plain_and_host(curve, group, c, monkeypatch):
    """Five MSMs over a table of 40 bases (an identity among them) and a
    prefix view of its first 32, sorted in groups cut by SORT_GROUP_ELEMS:
    each equals the plain path's MSM over the same points and the host
    oracle, as points. Scalars 0, 1, r - 1 (the top window's carry) and
    B2 + 1 (a low digit of -B2 + 1) in every MSM."""
    gs, points, jax_points = fixed_case(curve, group, 40)
    r = gs.curve.r
    B2 = 1 << (c - 1)
    rng = np.random.default_rng(10 * c + group)

    def scalars(n):
        s = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
        s[0], s[1], s[2], s[4] = 0, 1, r - 1, B2 + 1
        return s

    P = gs.points_to_device(points, "cpu")
    with_window(monkeypatch, c)
    table = tmsm.fixed_base_table(gs, P)
    head = table.prefix(32)
    sets = [scalars(40), scalars(32), scalars(40), scalars(32), scalars(40)]
    tables = [table, head, table, head, table]
    jobs = [(t, tmsm.scalars_to_device(s, r, "cpu")) for t, s in zip(tables, sets)]
    monkeypatch.setattr(tmsm, "SORT_GROUP_ELEMS", 2 * 2 * group * gs.fs.nl * table.W * 40)
    assert tmsm._job_groups(gs, jobs, None) == [[0, 2], [1, 3], [4]]
    sorts = []
    real = tmsm.sort_fixed_base
    monkeypatch.setattr(tmsm, "sort_fixed_base",
                        lambda gs_, t, s: sorts.append(s.shape) or real(gs_, t, s))
    got = tmsm.msm_pippenger_many(gs, jobs)
    nl = FieldSpec.get(r).nl
    assert sorts == [(nl, 2, 40), (nl, 2, 32), (nl, 40)]
    plain = tmsm.msm_pippenger_many(
        gs, [(gs.map(lambda t: t[:, :s.shape[1]], P), s) for (_, s) in jobs], c)
    cls = type(points[0])
    got_pts = gs.points_from_device(got, cls)
    assert got_pts == gs.points_from_device(plain, cls)
    for pt, s in zip(got_pts, sets):
        want = _host_msm(JAX_MODULES[curve], jax_points[:len(s)], s)
        assert pt.to_bytes() == want.to_bytes()


def test_one_call_mixing_tables_and_point_tensors(monkeypatch):
    """Jobs over a table and over point tensors in one call: one K4 pass a
    kind, the results in job order, each the MSM's alone."""
    gs, points, _ = fixed_case("BN254", 1, 24)
    c = 5
    P = gs.points_to_device(points, "cpu")
    with_window(monkeypatch, c)
    table = tmsm.fixed_base_table(gs, P)
    rng = np.random.default_rng(3)
    s = [tmsm.scalars_to_device([int.from_bytes(rng.bytes(32), "little") for _ in range(24)],
                                CURVE.r, "cpu") for _ in range(4)]
    jobs = [(P, s[0]), (table, s[1]), (P, s[2]), (table.prefix(24), s[3])]
    passes = []
    real = kernels.bucket_reduce
    monkeypatch.setattr(kernels, "bucket_reduce",
                        lambda gs_, b, *a: passes.append(tuple(b.shape[2:4])) or real(gs_, b, *a))
    got = gs.points_from_device(tmsm.msm_pippenger_many(gs, jobs, c), type(points[0]))
    assert passes == [(2, -(-256 // c)), (2, 1)]
    for m, job in enumerate(jobs):
        assert got[m] == gs.points_from_device(tmsm.msm_pippenger_many(gs, [job], c),
                                               type(points[0]))[0]
    with pytest.raises(ValueError):
        tmsm.msm_pippenger_many(gs, jobs)  # the point tensors' jobs need c


def test_fixed_base_window_rule():
    """The fixed-base path's window size: the fewest point-op products over
    c in 8..13 (K2's mixed adds, the fold's, one window's reduction)."""
    picks = {n: tmsm.fixed_base_window(n, 256) for n in (16, 4032, 4096, 1 << 16)}
    assert picks == {16: 8, 4032: 11, 4096: 11, 1 << 16: 13}
    gs, points, _ = fixed_case("BN254", 1, 16)
    table = tmsm.fixed_base_table(gs, gs.points_to_device(points, "cpu"))
    assert (table.c, table.W) == (8, 32)  # the table takes the rule's c
