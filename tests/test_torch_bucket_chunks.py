"""K2's output, affine normal form, against the rank-order walk, on the CPU.

K2 (csrc/bucket.cu) sums every run in its own order (chunks of
consecutive points summed in affine coordinates, then a fold) and returns
each bucket sum in affine normal form: (X, Y, 1), or (0, 1, 0) for the
identity, Montgomery form; BN254's G1 build sums in projective coordinates
and returns projective sums, which the card tests bring to that form. The
form is unique, so K2's plain version (bucket_accumulate_plain(...,
affine=True): the rank-order walk, then one batched normalisation) is what
the wrapper runs on the CPU and what the kernel equals on the card. Here,
on seeded runs (T = kernels.K2_CHUNK):

- the affine sums are the same points as the rank-order sums (the JAX
  package's order, bucket_accumulate_plain(..., affine=False)), compared
  by cross-multiplication, and, limb for limb, the host's affine
  coordinates of those points laid out by points_to_device (Z in {0, 1}),
  for G1 and G2 on both curves, over runs of length 0, 1, T, T + 1 and
  several T, and over the runs of a small MSM whose top window is spread
  over sub-buckets;
- runs that meet every exceptional case of K2's batch-affine walk (a
  repeated point, a point then its negation then more points, runs that
  cancel to the identity, empty runs, overlapping runs) give the JAX
  package's host sums, as compressed bytes, laid out as points_to_device
  lays them out;
- a small MSM whose runs are longer than T (so the fold runs) matches the
  JAX package's host bigint MSM (zksnake_tpu.backend.dispatch._host_msm);
- the point comparison these checks rely on (GroupSpec.equal) finds
  (0 : 0 : 0) equal to nothing and the identity equal only to itself.
"""

import random

import numpy as np
import pytest
import torch

from zksnake_tpu.backend.dispatch import _host_msm
from zksnake_tpu.curves import ec_bls12_381, ec_bn254
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend import msm as tmsm
from zksnake_tpu_torch.backend.curve_ops import get_group_spec
from zksnake_tpu_torch.curves import get_curve_module

from torch_support import CURVES, chain_points

T = kernels.K2_CHUNK
JAX_MODULES = {"BN254": ec_bn254, "BLS12_381": ec_bls12_381}


def planes(gs, points):
    """(L, nl, n) X and Y planes of host points (none the identity)."""
    X, Y, _ = gs.points_to_device(points, "cpu")
    return torch.stack(([X] if gs.group == 1 else list(X)) + ([Y] if gs.group == 1 else list(Y)))


def runs_case(curve, group, run_lens, lead=3, seed=0):
    """Two windows over the same n points: window 0 in chain order, window 1
    in a seeded permutation. Each row starts with `lead` slots outside every
    run (the |digit| = 0 points), then the runs of `run_lens` in order
    (window 1 takes them reversed)."""
    module = get_curve_module(curve, "cpu")
    gs = get_group_spec(module._curve, group)
    n = lead + sum(run_lens)
    leaves = planes(gs, chain_points(module, group, n, 3 + group))
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    pts = torch.stack([leaves, leaves[:, :, perm]], dim=2).contiguous()
    lens = np.array([run_lens, run_lens[::-1]], dtype=np.int32)
    starts = lead + np.concatenate([np.zeros((2, 1), np.int64), np.cumsum(lens, 1)[:, :-1]], 1)
    return gs, pts, torch.from_numpy(starts.astype(np.int32)), torch.from_numpy(lens)


def as_points(gs, sums):
    return gs.unflatten([t.reshape(t.shape[0], -1) for t in sums])


def assert_same_points(gs, a, b):
    assert a.shape == b.shape
    assert bool(gs.plain().equal(as_points(gs, a), as_points(gs, b)).all())


def host_layout(gs, sums, cls):
    """sums' points through the host (bigint, class cls) and back:
    points_to_device's layout, affine with Z in {0, 1}."""
    host = gs.points_from_device(as_points(gs, sums), cls)
    return torch.stack(gs.leaves(gs.points_to_device(host, "cpu"))).reshape(sums.shape)


def assert_normal_form(gs, sums, rank):
    """sums is rank's points in affine normal form, limb for limb: the
    host's affine coordinates of rank's points."""
    assert_same_points(gs, sums, rank)
    cls = type(get_curve_module(gs.curve.name, "cpu").g1() if gs.group == 1 else
               get_curve_module(gs.curve.name, "cpu").g2())
    assert torch.equal(sums, host_layout(gs, rank, cls))


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_chunked_sums_are_the_rank_order_points(curve, group):
    gs, pts, starts, lens = runs_case(curve, group,
                                      [0, 1, T, T + 1, 3 * T, 2 * T + 5, 9 * T + 3], seed=group)
    rank = kernels.bucket_accumulate_plain(gs, pts, starts, lens)
    # the CPU route of the wrapper: the affine plain version
    sums = kernels.bucket_accumulate(gs, pts, starts, lens)
    assert_normal_form(gs, sums, rank)
    # Z is Montgomery one for every finite sum, zero for an empty run, which
    # is (0, 1, 0)
    Z, fin = sums[2 * gs.group:], lens > 0
    one = torch.stack(gs.leaves((gs.F.one((), "cpu"),)))[:, :, None]
    assert torch.equal(Z[:, :, fin], one.expand(-1, -1, int(fin.sum())))
    assert not bool(Z[:, :, ~fin].any())
    assert torch.equal(sums[..., 0, 0], torch.stack(gs.leaves(gs.identity((), "cpu"))))
    # the rank-order walk's representatives are not that form
    assert not torch.equal(sums[:, :, 0, 3], rank[:, :, 0, 3])


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_chunked_sums_match_rank_order_limbs_when_runs_fit_a_chunk(curve, group):
    gs, pts, starts, lens = runs_case(curve, group, [0, 1, 5, T, T, 2], seed=10 + group)
    rank = kernels.bucket_accumulate_plain(gs, pts, starts, lens)
    assert_normal_form(gs, kernels.bucket_accumulate_plain(gs, pts, starts, lens, affine=True),
                       rank)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_chunked_sums_of_a_spread_top_window(curve, group):
    """The runs sort_by_digit makes for 96 points, 40 of them with one
    scalar (runs longer than 2T in every window but the top one), c = 6:
    the top window is spread over sub-buckets, with empty buckets."""
    module = get_curve_module(curve, "cpu")
    gs = get_group_spec(module._curve, group)
    n = 96
    P = gs.points_to_device(chain_points(module, group, n, 7 + group), "cpu")
    rng = random.Random(group)
    r = module._curve.r
    scalars = [rng.randrange(r) for _ in range(n)]
    scalars[10:50] = [scalars[10]] * 40
    s = tmsm.scalars_to_device(scalars, r, "cpu")
    pts, starts, lens, S_top, _ = tmsm.sort_by_digit(gs, P, s, 6)
    assert S_top > 1 and int((lens == 0).sum()) > 0 and int(lens.max()) > 2 * T
    rank = kernels.bucket_accumulate_plain(gs, pts, starts, lens)
    assert_normal_form(gs, kernels.bucket_accumulate_plain(gs, pts, starts, lens, affine=True),
                       rank)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_affine_sums_of_exceptional_runs_are_the_host_sums(curve, group):
    """One row of slots a, a, b | a, -a, c, d | a, -a | b, -b, a, -a | a, a,
    a, -b | c, c, -c, d, -d, -d (a, b, c, d host points): window 0's runs
    are those groups (a doubling; an identity mid-run, then a restart; two
    runs that cancel; more doublings and cancellations) with an empty run
    between them; window 1's runs overlap (each starts inside another).
    The sums are the JAX package's, by its host point arithmetic."""
    module = get_curve_module(curve, "cpu")
    gs = get_group_spec(module._curve, group)
    port = dict(zip("abcd", chain_points(module, group, 4, 3 + group)))
    jax = dict(zip("abcd", chain_points(JAX_MODULES[curve], group, 4, 3 + group)))
    groups = ["a a b", "a -a c d", "a -a", "b -b a -a", "a a a -b", "c c -c d -d -d"]
    slots = " ".join(groups).split()

    def point(name, points):
        return -points[name[1:]] if name[0] == "-" else points[name]

    row = [point(s, port) for s in slots]
    n = len(row)
    pts = planes(gs, row)[:, :, None].expand(-1, -1, 2, -1).contiguous()
    sizes = [len(g.split()) for g in groups]
    firsts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    starts = [list(firsts[:3]) + [0] + list(firsts[3:]), [0, 1, 4, 5, 8, 12, 2]]
    lens = [sizes[:3] + [0] + sizes[3:], [n, 6, 9, 3, 13, 10, 0]]
    starts = torch.tensor(starts, dtype=torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32)
    assert bool((lens.sum(1) > n).any())  # window 1's runs overlap
    jrow = [point(s, jax) for s in slots]
    want = []
    for w in range(2):
        for s, m in zip(starts[w].tolist(), lens[w].tolist()):
            acc = type(jax["a"]).identity()
            for p in jrow[s:s + m]:
                acc = acc + p
            want.append(acc.to_bytes())
    got = kernels.bucket_accumulate_plain(gs, pts, starts, lens, affine=True)
    cls = type(port["a"])
    assert [p.to_bytes() for p in gs.points_from_device(as_points(gs, got), cls)] == want
    assert torch.equal(got, host_layout(gs, got, cls))


@pytest.mark.parametrize("group", [1, 2])
def test_msm_with_folded_runs_matches_host_oracle(group, monkeypatch):
    """A small MSM on the CPU route (K2's affine plain version): 60 of 100
    scalars equal, so some runs span several chunks, as the kernel's fold
    sees them."""
    seen = []
    orig = kernels.bucket_accumulate
    monkeypatch.setattr(kernels, "bucket_accumulate",
                        lambda gs, pts, starts, lens: seen.append(int(lens.max()))
                        or orig(gs, pts, starts, lens))
    port = get_curve_module("BN254", "cpu")
    r = port._curve.r
    rng = random.Random(50 + group)
    scalars = [rng.randrange(r) for _ in range(100)]
    scalars[20:80] = [scalars[20]] * 60
    points = chain_points(port, group, 100, 13)
    got = tmsm.msm_device(port._curve, group, points, scalars, type(points[0]), "cpu")
    jax_points = chain_points(ec_bn254, group, 100, 13)
    assert got.to_bytes() == _host_msm(ec_bn254, jax_points, scalars).to_bytes()
    assert seen and max(seen) > T


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_point_equality_needs_real_points(curve, group):
    """GroupSpec.equal, on which every as-points check above and on the card
    rests: another representative of a point equals it; (0 : 0 : 0), which
    no kernel may output, equals no point and not itself; the identity
    equals the identity and no finite point."""
    module = get_curve_module(curve, "cpu")
    gs = get_group_spec(module._curve, group)
    P = gs.points_to_device(chain_points(module, group, 2, 3), "cpu")
    ident = gs.identity((2,), "cpu")
    zeros = gs.map(torch.zeros_like, P)
    rep = gs.add(P, ident)  # P, scaled
    swapped = gs.map(lambda t: t.flip(-1), P)
    cases = [(P, rep, True), (P, zeros, False), (zeros, P, False), (zeros, zeros, False),
             (ident, ident, True), (ident, P, False), (P, ident, False), (P, swapped, False)]
    assert not torch.equal(gs.leaves(rep)[0], gs.leaves(P)[0])
    for a, b, want in cases:
        assert gs.plain().equal(a, b).tolist() == [want, want]
