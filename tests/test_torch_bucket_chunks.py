"""K2's chunked order against the rank-order walk, on the CPU.

K2 (csrc/bucket.cu) cuts every run into chunks of at most T =
kernels.K2_CHUNK consecutive points, sums each chunk from the identity and
folds a bucket's chunk partials with the complete projective add, over
kernels.K2_FOLD_LANES lanes in a fixed order.
Its plain version (bucket_accumulate_plain(..., chunk=T)) is what the
wrapper runs on the CPU and what the kernel equals limb for limb on the
card. Here, on seeded ragged runs:

- the chunked sums are the same points as the rank-order sums (the JAX
  package's order, bucket_accumulate_plain(..., chunk=None)), compared by
  cross-multiplication, for G1 and G2 on both curves, over runs of length
  0, 1, T, T + 1 and several T (up to 10 chunks, so every fold lane has a
  segment and the tree runs), and over the runs of a small MSM whose top
  window is spread over sub-buckets;
- where every run is at most T long the two are equal limb for limb;
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
from zksnake_tpu.curves import ec_bn254
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend import msm as tmsm
from zksnake_tpu_torch.backend.curve_ops import get_group_spec
from zksnake_tpu_torch.curves import get_curve_module

from torch_support import CURVES, chain_points

T = kernels.K2_CHUNK


def runs_case(curve, group, run_lens, lead=3, seed=0):
    """Two windows over the same n points: window 0 in chain order, window 1
    in a seeded permutation. Each row starts with `lead` slots outside every
    run (the |digit| = 0 points), then the runs of `run_lens` in order
    (window 1 takes them reversed)."""
    module = get_curve_module(curve, "cpu")
    gs = get_group_spec(module._curve, group)
    n = lead + sum(run_lens)
    X, Y, _ = gs.points_to_device(chain_points(module, group, n, 3 + group), "cpu")
    leaves = ([X] if group == 1 else list(X)) + ([Y] if group == 1 else list(Y))
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    pts = torch.stack([torch.stack([t, t[:, perm]], dim=1) for t in leaves]).contiguous()
    lens = np.array([run_lens, run_lens[::-1]], dtype=np.int32)
    starts = lead + np.concatenate([np.zeros((2, 1), np.int64), np.cumsum(lens, 1)[:, :-1]], 1)
    return gs, pts, torch.from_numpy(starts.astype(np.int32)), torch.from_numpy(lens)


def as_points(gs, sums):
    return gs.unflatten([t.reshape(t.shape[0], -1) for t in sums])


def assert_same_points(gs, a, b):
    assert a.shape == b.shape
    assert bool(gs.plain().equal(as_points(gs, a), as_points(gs, b)).all())


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_chunked_sums_are_the_rank_order_points(curve, group):
    gs, pts, starts, lens = runs_case(curve, group,
                                      [0, 1, T, T + 1, 3 * T, 2 * T + 5, 9 * T + 3], seed=group)
    rank = kernels.bucket_accumulate_plain(gs, pts, starts, lens)
    chunked = kernels.bucket_accumulate_plain(gs, pts, starts, lens, chunk=T)
    assert_same_points(gs, chunked, rank)
    # runs of 0 to T points are one chunk or none: the same limbs
    assert torch.equal(chunked[:, :, 0, :3], rank[:, :, 0, :3])
    assert torch.equal(chunked[..., 0, 0], torch.stack(gs.leaves(gs.identity((), "cpu"))))
    # a run of T + 1 or more is folded: another representative of the point
    assert not torch.equal(chunked[:, :, 0, 3], rank[:, :, 0, 3])
    # the CPU route of the wrapper is the chunked plain version
    assert torch.equal(kernels.bucket_accumulate(gs, pts, starts, lens), chunked)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_chunked_sums_match_rank_order_limbs_when_runs_fit_a_chunk(curve, group):
    gs, pts, starts, lens = runs_case(curve, group, [0, 1, 5, T, T, 2], seed=10 + group)
    rank = kernels.bucket_accumulate_plain(gs, pts, starts, lens)
    assert torch.equal(kernels.bucket_accumulate_plain(gs, pts, starts, lens, chunk=T), rank)


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
    chunked = kernels.bucket_accumulate_plain(gs, pts, starts, lens, chunk=T)
    assert_same_points(gs, chunked, rank)
    short = lens <= T
    assert torch.equal(chunked[:, :, short], rank[:, :, short])


@pytest.mark.parametrize("group", [1, 2])
def test_msm_with_folded_runs_matches_host_oracle(group, monkeypatch):
    """A small MSM on the CPU route (K2's chunked plain version): 60 of 100
    scalars equal, so some runs span several chunks and the fold runs."""
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
