"""K2m's plain version against K2's, and the chunk table both kernels size
their scratch from, on the CPU.

K2m (csrc/bucket_mma.cu) runs K2's chunk and fold kernels
(csrc/bucket_chunks.cuh) on the tensor-core product. Both return every
bucket sum in affine normal form, which is unique, so K2m's plain version,
which its wrapper runs on the CPU, is bucket_accumulate_plain(...,
mode="mma", affine=True): K2's plain version (the rank-order walk, then one
batched normalisation) with every field product through K3's plain
version. Both products are canonical, so the two are equal limb for limb.
Here, on seeded runs:

- runs of 0, 1, T, T + 1 and 2T + 1 points over two windows, G1 and G2 of
  both curves;
- the runs sort_by_digit makes where the top window is spread over
  sub-buckets, with empty buckets and runs longer than 2T;
- overlapping runs (each window's runs total more than its n points), which
  the plain versions take as they take any runs;
- kernels.k2_chunk, the chunk length the wrapper passes for each build;
- kernels.chunk_table and kernels.chunk_scratch, the chunk table and the
  scratch the wrapper gives both kernels without waiting for the card: the
  scratch holds every chunk of runs that total at most n points a window,
  and overlapping runs have chunks past it, whose buckets the fold sums
  from their points (the card tests hold both kernels to their plain
  versions there).
"""

import random

import numpy as np
import pytest
import torch

from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend import msm as tmsm
from zksnake_tpu_torch.backend.curve_ops import get_group_spec
from zksnake_tpu_torch.curves import get_curve_module

from torch_support import CURVES, chain_points

T = kernels.K2_CHUNK


def point_rows(gs, points, perm):
    """(L, nl, 2, n) planes: row 0 the points in order, row 1 permuted."""
    X, Y, _ = gs.points_to_device(points, "cpu")
    leaves = ([X] if gs.group == 1 else list(X)) + ([Y] if gs.group == 1 else list(Y))
    return torch.stack([torch.stack([t, t[:, perm]], dim=1) for t in leaves]).contiguous()


def both_plains(gs, pts, starts, lens):
    k2 = kernels.bucket_accumulate_plain(gs, pts, starts, lens, affine=True)
    k2m = kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode="mma", affine=True)
    return k2, k2m


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_mma_chunked_plain_equals_k2_chunked_plain(curve, group):
    """Two windows, each a row of `lead` slots outside every run, then the
    runs in order (window 1 takes them reversed, over permuted points)."""
    module = get_curve_module(curve, "cpu")
    gs = get_group_spec(module._curve, group)
    run_lens = [0, 1, T, T + 1, 2 * T + 1, 0, 3]
    lead = 2
    n = lead + sum(run_lens)
    perm = torch.from_numpy(np.random.default_rng(group).permutation(n))
    pts = point_rows(gs, chain_points(module, group, n, 3 + group), perm)
    lens = np.array([run_lens, run_lens[::-1]], dtype=np.int32)
    starts = lead + np.concatenate([np.zeros((2, 1), np.int64), np.cumsum(lens, 1)[:, :-1]], 1)
    starts, lens = torch.from_numpy(starts.astype(np.int32)), torch.from_numpy(lens)
    k2 = kernels.bucket_accumulate_plain(gs, pts, starts, lens, affine=True)
    # the wrapper's CPU route: the affine plain version with K3's products
    k2m = kernels.bucket_accumulate_mma(gs, pts, starts, lens)
    assert torch.equal(k2m, k2)
    # the normal form of K3's rank-order walk: not the walk's limbs
    rank = kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode="mma")
    assert not torch.equal(k2m[:, :, 0, 3], rank[:, :, 0, 3])
    assert torch.equal(k2m, kernels.affine_normal_form(gs.plain("mma"), rank))


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_mma_chunked_plain_on_a_spread_top_window(curve, group):
    """The runs sort_by_digit makes for 64 points, 30 of them with one
    scalar (runs longer than 2T in every window but the top one), c = 6:
    the top window is spread over sub-buckets, with empty buckets."""
    module = get_curve_module(curve, "cpu")
    gs = get_group_spec(module._curve, group)
    n = 64
    P = gs.points_to_device(chain_points(module, group, n, 9 + group), "cpu")
    rng = random.Random(70 + group)
    r = module._curve.r
    scalars = [rng.randrange(r) for _ in range(n)]
    scalars[10:40] = [scalars[10]] * 30
    s = tmsm.scalars_to_device(scalars, r, "cpu")
    pts, starts, lens, S_top, _ = tmsm.sort_by_digit(gs, P, s, 6)
    assert S_top > 1 and int((lens == 0).sum()) > 0 and int(lens.max()) > 2 * T
    k2, k2m = both_plains(gs, pts, starts, lens)
    assert torch.equal(k2m, k2)


@pytest.mark.parametrize("group", [1, 2])
def test_mma_chunked_plain_on_overlapping_runs(group):
    """Runs that share slots: every window's runs total more than its n
    points, as a direct call may give them (sort_by_digit never does)."""
    module = get_curve_module("BN254", "cpu")
    gs = get_group_spec(module._curve, group)
    n = 20
    pts = point_rows(gs, chain_points(module, group, n, 5), torch.arange(n).flip(0))
    starts = torch.tensor([[0, 2, 0, 11], [3, 0, 5, 1]], dtype=torch.int32)
    lens = torch.tensor([[n, 2 * T + 1, T + 1, 9], [17, n, 1, T]], dtype=torch.int32)
    assert bool((lens.sum(1) > n).all())
    k2, k2m = both_plains(gs, pts, starts, lens)
    assert torch.equal(k2m, k2)


@pytest.mark.parametrize("chunk", [1, 4, T])
def test_chunk_table_and_scratch_on_overlapping_runs(chunk):
    """Every run the whole row: the table counts every run's chunks, in
    int64, and passes the scratch, so the fold sums those buckets from
    their points."""
    Wn, n, B2 = 2, 16, 3
    lens = torch.full((Wn, B2), n, dtype=torch.int32)
    lens[1, 2] = 5
    coff = kernels.chunk_table(lens, chunk)
    per = [-(-int(x) // chunk) for x in lens.reshape(-1)]
    assert coff.dtype == torch.int64 and coff.tolist() == np.cumsum(per).tolist()
    cap = kernels.chunk_scratch(Wn, B2, n, chunk)
    assert cap == (Wn * n + (chunk - 1) * Wn * B2) // chunk
    assert int(coff[-1]) > cap


@pytest.mark.parametrize("chunk", [1, 3, T])
def test_chunk_scratch_holds_every_chunk_of_disjoint_runs(chunk):
    """Seeded runs that total at most n points a window (empty runs, runs
    of 1 and of chunk + 1, the worst case for the count): the table's last
    entry never passes the scratch, so the main fold takes every bucket."""
    rng = np.random.default_rng(chunk)
    for _ in range(200):
        Wn, B2, n = int(rng.integers(1, 4)), int(rng.integers(1, 9)), int(rng.integers(0, 40))
        lens = np.zeros((Wn, B2), np.int64)
        for w in range(Wn):
            left = n
            for b in rng.permutation(B2):
                pick = int(rng.choice([0, 1, chunk + 1, int(rng.integers(0, n + 1))]))
                lens[w, b] = min(pick, left)
                left -= lens[w, b]
        coff = kernels.chunk_table(torch.from_numpy(lens.astype(np.int32)), chunk)
        assert int(coff[-1]) <= kernels.chunk_scratch(Wn, B2, n, chunk)


def test_chunk_table_of_sorted_runs_and_of_none():
    """sort_by_digit's disjoint runs: the table's last entry is the sum of
    the buckets' chunks, within the scratch; no runs, no chunks, and a
    scratch of one chunk."""
    module = get_curve_module("BN254", "cpu")
    gs = get_group_spec(module._curve, 1)
    n = 64
    P = gs.points_to_device(chain_points(module, 1, n, 3), "cpu")
    r = module._curve.r
    rng = random.Random(5)
    s = tmsm.scalars_to_device([rng.randrange(r) for _ in range(n)], r, "cpu")
    _, starts, lens, _, _ = tmsm.sort_by_digit(gs, P, s, 5)
    coff = kernels.chunk_table(lens, T)
    assert int(coff[-1]) == int(((lens.long() + T - 1) // T).sum())
    assert int(coff[-1]) <= kernels.chunk_scratch(lens.shape[0], lens.shape[1], n, T)
    assert kernels.chunk_table(torch.zeros((0, 4), dtype=torch.int32), T).numel() == 0
    assert kernels.chunk_scratch(0, 4, n, T) == 1


@pytest.mark.parametrize("slots,members,want", [
    (1_550_000, 0, T), (5_500_000, 0, T), (1_550_000, 16, 4), (3_100_000, 16, 6),
    (5_500_000, 16, 8), (1, 16, 2), (1 << 36, 16, 16)])
def test_chunk_length_follows_the_build(slots, members, want):
    """kernels.k2_chunk: K2_CHUNK where the build sums one chunk a thread
    in projective coordinates (k2_members 0); in the affine order
    round(sqrt(slots / 90,000)) within 2 .. 16 (4 at a Groth16 MSM's 1.55M
    slots, 8 at the EIP-7594 call's 5.5M)."""
    assert kernels.k2_chunk(slots, members) == want
