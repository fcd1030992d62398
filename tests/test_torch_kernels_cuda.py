"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card: it carries the `cuda` marker and skips
(from inside the test, through the `card` fixture) where there is none. On
the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

K1, K2, K2m and K4 (16- and 24-limb builds) and K3 must match their plain
versions limb for limb (integer field arithmetic has no tolerance; K2 and
K2m their plain version in affine normal form, on overlapping runs, planted
doublings and cancellations and the EIP-7594 request's fixed-base rows too,
the projective order's sums, BN254's G1, once brought to that form, and
K2m K2), and so must the relayout
kernels S1-S8 and the G2 probe S9 on ragged edges (a start of n - 1, R not a
multiple of 4, planes not a multiple of any tile, all-ones bytes); each
wrapper must count one launch per call, refuse what its kernel does not take,
and the MSM and the fixture proofs must come out the same on the card as on
the host. The MSM oracle is the JAX package's host bigint MSM, whose modules
import no jax, so the file runs where jax is not installed.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

from zksnake_tpu.backend.dispatch import _host_msm
from zksnake_tpu.curves import ec_bn254
from zksnake_tpu_torch import BLS12_381_MODULUS, BN254_MODULUS, BN254_SCALAR_FIELD
from zksnake_tpu_torch.backend import kernels, relayout
from zksnake_tpu_torch.backend import msm as tmsm
from zksnake_tpu_torch.backend.curve_ops import get_group_spec
from zksnake_tpu_torch.backend.field import FieldSpec
from zksnake_tpu_torch.curves import get_curve_module
from zksnake_tpu_torch.scripts import debug_g2_block
from zksnake_tpu_torch.scripts.k2_chunk_sweep import distinct_points, eip7594_inputs

from torch_support import CURVES

pytestmark = pytest.mark.cuda

FIXTURES = Path(__file__).resolve().parent / "fixtures"
FIELDS = [BN254_SCALAR_FIELD, BN254_MODULUS, BLS12_381_MODULUS]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def random_elems(fs, n, seed):
    """(nl, n) int32 limbs of values < p; lanes 0, 1, 2 hold 0, 1, p - 1."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(fs.nl, n), dtype=np.int64)
    limbs[-1] = rng.integers(0, int(fs.p_limbs[-1]), size=n)
    limbs[:, :3] = fs.raw_to_host([0, 1, fs.p - 1])[:, :n]
    return torch.from_numpy(limbs.astype(np.int32))


@pytest.mark.parametrize("p", FIELDS)
def test_mont_mul_kernel_matches_plain(card, p):
    fs = FieldSpec.get(p)
    a = random_elems(fs, 4099, 1).to(card)
    b = random_elems(fs, 4099, 2).flip(1).contiguous().to(card)
    before = kernels.LAUNCHES["mont_mul"]
    got = kernels.mont_mul(fs, a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, kernels.mont_mul_plain(fs, a, b))


@pytest.mark.parametrize("p", FIELDS)
@pytest.mark.parametrize("n", [1, 31, 4099, (1 << 17) + 3])
def test_mont_mul_mma_kernel_matches_plain(card, p, n):
    """K3 against its plain version and against K1 at the edges of its
    tiling: one lane, a ragged warp tile (31), a ragged block (4099) and a
    grid-stride loop over more tiles than one wave of blocks (2^17 + 3)."""
    fs = FieldSpec.get(p)
    a = random_elems(fs, n, 3).to(card)
    b = random_elems(fs, n, 4).flip(1).contiguous().to(card)
    before = kernels.LAUNCHES["mont_mul_mma"]
    got = kernels.mont_mul_mma(fs, a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mont_mul_mma"] == before + 1
    assert torch.equal(got, kernels.mont_mul_mma_plain(fs, a, b))
    assert torch.equal(got, kernels.mont_mul(fs, a, b))


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_bucket_kernel_matches_plain(card, curve, group):
    cm = get_curve_module(curve, card)
    gs = get_group_spec(cm._curve, group)
    gen = cm.g1() if group == 1 else cm.g2()
    base = gs.points_to_device([gen * (i + 1) for i in range(32)], card)
    P = gs.map(lambda t: t.repeat(1, 16), base)  # 512 points
    rng = random.Random(group)
    r = cm._curve.r
    s = tmsm.scalars_to_device([rng.randrange(r) for _ in range(512)], r, card)
    pts, starts, lens, _, _ = tmsm.sort_by_digit(gs, P, s, 7)
    before = kernels.LAUNCHES["bucket_accumulate"]
    got = kernels.bucket_accumulate(gs, pts, starts, lens)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucket_accumulate"] == before + 1
    want = kernels.bucket_accumulate_plain(gs, pts, starts, lens, affine=True)
    assert_plain_sums(gs, got, want)


# K2 and K2m: the wrapper and the plain version's product mode; the plain
# version returns the sums in affine normal form (affine=True)
BUCKET_KERNELS = {"k2": ("bucket_accumulate", True), "k2m": ("bucket_accumulate_mma", "mma")}


def assert_plain_sums(gs, got, want, kernel="k2"):
    """K2's or K2m's sums `got` are their plain version's `want` (affine
    normal form): limb for limb where the build sums in affine coordinates,
    and once brought to that form where it sums in the projective order
    (kernels.k2_members 0, BN254's G1), which returns projective sums."""
    if kernels.k2_members(gs, kernel == "k2m"):
        assert torch.equal(got, want)
    else:
        assert torch.equal(kernels.affine_normal_form(gs, got), want)


def point_planes(gs, cm, n, device, seed):
    """(L, nl, n) X and Y planes of k2_chunk_sweep.distinct_points."""
    return torch.stack(gs.leaves(distinct_points(gs, cm, n, device, seed))[:2 * gs.group])


@pytest.mark.parametrize("kernel", sorted(BUCKET_KERNELS))
@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_bucket_kernel_chunks_match_plain_at_the_edges(card, curve, group, kernel):
    """K2 and K2m against their plain version, limb for limb, where the
    chunk table is ragged: a run of 5000 points (more than one block's
    k2_members x 128 chunks), a block whose chunks run from window 0
    through window 1 into window 2, runs of 1, T, T + 1 and 2T + 1 points
    (T the wrapper's chunk length, kernels.k2_chunk), empty buckets and an
    empty window, over distinct points."""
    name, mode = BUCKET_KERNELS[kernel]
    cm = get_curve_module(curve, card)
    gs = get_group_spec(cm._curve, group)
    n, lead = 5300, 5
    members = kernels.k2_members(gs, kernel == "k2m")
    T = kernels.k2_chunk(3 * n, members)
    assert -(-5000 // T) > 128 * max(members, 1)
    run_lens = [[0, 5000, 1, T + 1, 0, T, 2 * T + 1, 100],
                [3, 0, T, 15, 40, 1, 0, 2], [0] * 8]
    lens = torch.tensor(run_lens, dtype=torch.int32)
    starts = lead + torch.cumsum(lens, 1, dtype=torch.int32) - lens
    pts = point_planes(gs, cm, 3 * n, card, 60 + group).reshape(2 * group, gs.fs.nl, 3, n)
    pts = pts.contiguous()
    before = kernels.LAUNCHES[name]
    got = getattr(kernels, name)(gs, pts, starts.to(card), lens.to(card))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = kernels.bucket_accumulate_plain(gs, pts, starts.to(card), lens.to(card), mode=mode,
                                           affine=True)
    assert_plain_sums(gs, got, want, kernel)
    assert_plain_sums(gs, got[:, :, 2:], want[:, :, 2:], kernel)  # the empty window


@pytest.mark.parametrize("kernel", sorted(BUCKET_KERNELS))
@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_bucket_kernels_match_plain_on_overlapping_runs(card, curve, group, kernel):
    """Runs that share slots, as a direct call may give them: each window's
    runs total several times its n points, so the chunk table has more
    chunks than the scratch (sized from n) holds, and the buckets with
    chunks past it, one across its end, are folded from their points. K2
    and K2m must compute their plain versions' function on them, limb for
    limb."""
    name, mode = BUCKET_KERNELS[kernel]
    gs = get_group_spec(get_curve_module(curve, card)._curve, group)
    n, B2 = 300, 16
    T = kernels.k2_chunk(2 * n, kernels.k2_members(gs, kernel == "k2m"))
    rng = np.random.default_rng(80 + group)
    lens = torch.from_numpy(rng.integers(0, n + 1, size=(2, B2)).astype(np.int32))
    lens[0, :3] = torch.tensor([n, 1, 2 * T + 1], dtype=torch.int32)
    starts = torch.from_numpy(rng.integers(0, n + 1, size=(2, B2)).astype(np.int32))
    starts = torch.minimum(starts, n - lens)
    coff, cap = kernels.chunk_table(lens, T), kernels.chunk_scratch(2, B2, n, T)
    first = coff - (lens.reshape(-1).long() + T - 1) // T
    assert int(coff[-1]) > cap and bool(((first < cap) & (coff > cap)).any())
    cm = get_curve_module(curve, card)
    pts = point_planes(gs, cm, 2 * n, card, 90 + group).reshape(2 * group, gs.fs.nl, 2, n)
    pts = pts.contiguous()
    starts, lens = starts.to(card), lens.to(card)
    got = getattr(kernels, name)(gs, pts, starts, lens)
    torch.cuda.synchronize()
    want = kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode=mode, affine=True)
    assert_plain_sums(gs, got, want, kernel)


@pytest.mark.parametrize("kernel", sorted(BUCKET_KERNELS))
@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_bucket_kernels_take_the_exceptional_cases(card, curve, group, kernel):
    """Runs over four points a, b, c, d and their negations that meet every
    exceptional case of the chunk kernel's batch-affine add (a repeated
    point: a doubling; a point then its negation: the identity mid-run,
    then the identity taking the next point; runs that cancel whole) and
    chunks that cancel, whose partials the fold skips. K2 and K2m must give
    their plain version's sums (assert_plain_sums) and, in the affine order,
    count those members in `bucket_exceptional`; on distinct points, and in
    the projective order, whose complete add has no exceptional case, the
    count is 0."""
    from zksnake_tpu_torch import metrics

    name, mode = BUCKET_KERNELS[kernel]
    cm = get_curve_module(curve, card)
    gs = get_group_spec(cm._curve, group)
    gen = cm.g1() if group == 1 else cm.g2()
    a, b, c, d = [gen * k for k in (3, 5, 7, 11)]
    row = [a, a, b, a, -a, c, d, a, -a, b, -b, a, -a, a, a, a, -b, c, c, -c, d, -d, -d]
    X, Y, _ = gs.points_to_device(row * 4, card)
    planted = torch.stack(([X] if group == 1 else list(X)) + ([Y] if group == 1 else list(Y)))
    n = planted.shape[-1]
    fresh = point_planes(gs, cm, n, card, 7 + group)
    pts = torch.stack([planted, fresh], dim=2).contiguous()
    starts = torch.tensor([[0, 3, 7, 9, 13, 17, 23, 0, 46], [0, 3, 7, 9, 13, 17, 23, 0, 46]],
                          dtype=torch.int32, device=card)
    lens = torch.tensor([[3, 4, 2, 4, 4, 6, 23, 0, n - 46]] * 2, dtype=torch.int32, device=card)

    def counted(rows):
        metrics.enable()
        metrics.reset()
        try:
            with metrics.phase("k2"):
                got = getattr(kernels, name)(gs, pts[:, :, rows].contiguous(),
                                             starts[rows].contiguous(), lens[rows].contiguous())
            return got, metrics.report()["k2"]["bucket_exceptional"]
        finally:
            metrics.enable(False)
            metrics.reset()

    got, odd = counted([0, 1])
    want = kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode=mode, affine=True)
    assert_plain_sums(gs, got, want, kernel)
    assert (odd > 0) == (kernels.k2_members(gs, kernel == "k2m") > 0)
    got, odd = counted([1])
    assert_plain_sums(gs, got, want[:, :, 1:], kernel)
    assert odd == 0


@pytest.mark.parametrize("kernel", sorted(BUCKET_KERNELS))
def test_bucket_kernels_at_the_eip7594_fixed_base_rows(card, kernel):
    """The EIP-7594 request's K2 call (k2_chunk_sweep.eip7594_inputs),
    reduced: BLS12-381 G1, MSMs over the prefix of 256 of a FixedBaseTable
    of 320 distinct bases (fixed_base_window's c), each MSM one row of W *
    256 slots sorted by |digit|, 6 jobs in one call. K2 and K2m against
    their plain version, limb for limb."""
    name, mode = BUCKET_KERNELS[kernel]
    gs, pts, starts, lens, c, jobs = eip7594_inputs(card, N=320, cell=64, jobs=6, seed=3)
    assert pts.shape[2] == jobs == 6
    assert pts.shape[3] == -(-16 * FieldSpec.get(gs.curve.r).nl // c) * 256
    got = getattr(kernels, name)(gs, pts, starts, lens)
    want = kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode=mode, affine=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
def test_bucket_mma_kernel_matches_plain_and_k2(card, curve, group):
    """K2m on ragged runs (empty buckets in the spread top window) against
    its plain version (assert_plain_sums) and against K2, limb for limb:
    both sum in one order, with canonical products."""
    cm = get_curve_module(curve, card)
    gs = get_group_spec(cm._curve, group)
    gen = cm.g1() if group == 1 else cm.g2()
    base = gs.points_to_device([gen * (i + 1) for i in range(32)], card)
    P = gs.map(lambda t: t.repeat(1, 8), base)  # 256 points
    rng = random.Random(40 + group)
    r = cm._curve.r
    s = tmsm.scalars_to_device([rng.randrange(r) for _ in range(256)], r, card)
    pts, starts, lens, _, _ = tmsm.sort_by_digit(gs, P, s, 6)
    assert int((lens == 0).sum()) > 0
    before = dict(kernels.LAUNCHES)
    got = kernels.bucket_accumulate_mma(gs, pts, starts, lens)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucket_accumulate_mma"] == before["bucket_accumulate_mma"] + 1
    assert kernels.LAUNCHES["bucket_accumulate"] == before["bucket_accumulate"]
    assert_plain_sums(gs, got, kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode="mma",
                                                               affine=True), "k2m")
    assert torch.equal(got, kernels.bucket_accumulate(gs, pts, starts, lens))


def reduce_inputs(curve, group, c, M, W, device, seed):
    """K4's input: (3|6, nl, M, W, 2^(c - 1)) bucket sums of real points:
    sums of two generator multiples (projective, Z not 1), a fifth of the
    lanes the identity, lane b + 1 equal to lane b for every b = 0 mod 4
    and lane B2 / 2 to lane 0 (the complete add on P + P in the scan and
    the tree), and window 1 of MSM 0 summing to the identity (lanes 0 and 1
    hold 2Q and -Q, the rest the identity)."""
    cm = get_curve_module(curve, device)
    gs = get_group_spec(cm._curve, group)
    gen = cm.g1() if group == 1 else cm.g2()
    rng = np.random.default_rng(seed)
    base = gs.points_to_device([gen * (i + 1) for i in range(16)], device)
    a, b = (torch.from_numpy(rng.integers(0, 16, size=30)).to(device) for _ in range(2))
    Q = gen * 5
    extra = gs.points_to_device([Q + Q, -Q, type(gen).identity()], device)
    pool = gs.map(lambda s, e: torch.cat([s, e], dim=1),
                  gs.add(gs.map(lambda t: t[:, a], base), gs.map(lambda t: t[:, b], base)),
                  extra)  # 30 sums, then 2Q, -Q, the identity
    B2 = 1 << (c - 1)
    idx = rng.integers(0, 30, size=(M, W, B2))
    idx[rng.random(size=idx.shape) < 0.2] = 32
    idx[..., 1::4] = idx[..., 0::4]
    idx[..., B2 // 2] = idx[..., 0]
    idx[0, 1] = 32
    idx[0, 1, :2] = [30, 31]
    idx = torch.from_numpy(idx).to(device)
    return gs, torch.stack([t[:, idx] for t in gs.leaves(pool)]).contiguous()


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("c", [3, 7, 9, 11, 13])
@pytest.mark.parametrize("M", [1, 4])
def test_bucket_reduce_kernel_matches_plain(card, curve, group, c, M):
    """K4 against its plain version, limb for limb, on three windows of
    real bucket sums (reduce_inputs): identities, equal neighbours, a
    window that sums to the identity; with M = 4 the top window spread
    over S_top = 4 sub-buckets, with M = 1 not spread (S_top = 1)."""
    gs, buckets = reduce_inputs(curve, group, c, M, 3, card, 100 * c + 10 * M + group)
    B2 = 1 << (c - 1)
    S_top, V_cap = (4, B2 // 4) if M == 4 else (1, B2)
    before = kernels.LAUNCHES["bucket_reduce"]
    got = kernels.bucket_reduce(gs, buckets, c, S_top, V_cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucket_reduce"] == before + 1
    assert got.shape == (3 * group, gs.fs.nl, M)
    assert torch.equal(got, kernels.bucket_reduce_plain(gs, buckets, c, S_top, V_cap))


def test_groth16_prove_on_card_reduces_through_k4(card):
    """A Groth16 prove on the card reduces its G1 MSMs and its G2 MSM in two
    K4 passes: two launches, msm.reduce counting reduce_kernel_passes 2 and
    the plain version's point ops (one a level: the top fold, the suffix
    scan, the window tree, Horner's doublings and adds) under the children
    msm.reduce.window and .horner."""
    from zksnake_tpu_torch import ConstraintSystem, R1CS, Var, metrics
    from zksnake_tpu_torch.groth16 import Groth16

    inp, out = Var("inp"), Var("out")
    v = [Var(f"v{i}") for i in range(15)]
    cs = ConstraintSystem(["inp"], ["out"], BN254_SCALAR_FIELD)
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, 15):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[14])
    cs.set_public(out)
    r1cs = R1CS(cs, "BN254")
    r1cs.compile()
    pub, priv = r1cs.generate_witness(cs.solve({"inp": 3}))
    g16 = Groth16(r1cs, "BN254", device=card)
    g16.setup()
    before = kernels.LAUNCHES["bucket_reduce"]
    metrics.enable()
    metrics.reset()
    try:
        proof = g16.prove(pub, priv)
        rep = metrics.report()
    finally:
        metrics.enable(False)
        metrics.reset()
    assert g16.verify(proof, pub)
    assert kernels.LAUNCHES["bucket_reduce"] == before + 2
    c = tmsm._pick_window(g16._get_device_prover().n)
    W, B2 = -(-256 // c), 1 << (c - 1)
    V_cap = tmsm._next_pow2(max((BN254_SCALAR_FIELD >> (c * (W - 1))) + 2, 2))
    S_top = B2 // V_cap if V_cap < B2 else 1
    red = rep["msm.reduce"]
    assert (red["calls"], red["reduce_kernel_passes"]) == (2, 2)
    assert red["point_ops"] == 2 * (S_top.bit_length() - 1 + 2 * (c - 1) + W * (c + 1))
    for name in ("msm.reduce.window", "msm.reduce.horner"):
        assert rep[name]["calls"] == 2 and rep[name]["parent"] == "msm.reduce"
    assert not {"msm.reduce.top", "msm.reduce.scan", "msm.reduce.tree"} & set(rep)


def test_eip7594_request_on_card_equals_the_reference(card):
    """One full-size EIP-7594 request on the card (6 blobs of 4096, cells
    of 64), through the benchmark's adapter: every commitment, cell and
    cell proof equal to the plain reference's, its 774 MSMs in one K4 pass
    of one window each (the SRS's fixed-base table), 3,121,152 points in
    all, and no K2 member meeting an exceptional case."""
    from portbench import harness
    from portbench.protocols import kzg_cells
    from zksnake_tpu_torch import metrics

    seed = 2**35 + 7
    config = harness.load_json(
        str(Path(harness.HERE) / "configs" / "eip7594-cells-bls12_381-6blobs.json"))
    proto = kzg_cells.Protocol(config, seed, card)
    proto.setup()
    try:
        inputs = proto.request(0)
        metrics.enable()
        metrics.reset()
        try:
            out = proto.prove(inputs)
            rep = metrics.report()
        finally:
            metrics.enable(False)
            metrics.reset()
    finally:
        proto.close()
    msm = rep["kzg.cells.msm"]
    assert (msm["reduce_kernel_passes"], msm["msm_points"]) == (1, 6 * (4096 + 128 * 4032))
    assert (msm["msm_windows"], msm["msm_fixed_points"]) == (774, msm["msm_points"])
    assert msm["bucket_exceptional"] == 0  # no doubling or cancellation in K2 on random blobs
    got = harness.check(proto, None, [(0, 1.0, out)], seed)
    assert got == {"checked": 1, "mismatched": 0, "wrong": []}


def test_fixed_base_msm_on_card_equals_the_plain_path(card):
    """Three BLS12-381 G1 MSMs over the first 4,032 bases of a 4,096-base
    fixed-base table, on the card at the path's own window size, equal
    as points to the plain path's over the same points (an identity base
    among them; scalars 0, 1, r - 1)."""
    cm = get_curve_module("BLS12_381", card)
    gs = get_group_spec(cm._curve, 1)
    g = cm.g1()
    points, P, step = [], g * 5, g * 977
    for _ in range(4096):
        points.append(P)
        P = P + step
    points[10] = type(g).identity()
    bases = gs.points_to_device(points, card)
    r = cm._curve.r
    table = tmsm.fixed_base_table(gs, bases)
    assert (table.c, table.W) == (11, 24)
    rng = random.Random(41)
    scalars = [[rng.randrange(r) for _ in range(4032)] for _ in range(3)]
    for s in scalars:
        s[:3] = [0, 1, r - 1]
    slimbs = [tmsm.scalars_to_device(s, r, card) for s in scalars]
    got = tmsm.msm_pippenger_many(gs, [(table.prefix(4032), s) for s in slimbs])
    head = gs.map(lambda t: t[:, :4032], bases)
    want = tmsm.msm_pippenger_many(gs, [(head, s) for s in slimbs], tmsm._pick_window(4032))
    assert gs.points_from_device(got, type(g)) == gs.points_from_device(want, type(g))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    fs = FieldSpec.get(BN254_MODULUS)
    a = random_elems(fs, 64, 3).to(card)
    for fn in (kernels.mont_mul, kernels.mont_mul_mma):
        with pytest.raises(TypeError):
            fn(fs, a.long(), a.long())
        with pytest.raises(ValueError):
            fn(fs, a[:, ::2], a[:, ::2])
        with pytest.raises(ValueError):
            fn(fs, a, a.cpu())
    gs = get_group_spec(get_curve_module("BN254", card)._curve, 1)
    pts = torch.zeros((2, 16, 1, 8), dtype=torch.int32, device=card)
    runs = torch.zeros((1, 4), dtype=torch.int32, device=card)
    for fn in (kernels.bucket_accumulate, kernels.bucket_accumulate_mma):
        with pytest.raises(ValueError):
            fn(gs, pts[:1], runs, runs)  # G1 takes X and Y planes
        with pytest.raises(TypeError):
            fn(gs, pts.long(), runs, runs)
        with pytest.raises(ValueError):
            fn(gs, pts, runs, runs.cpu())
    buckets = torch.zeros((3, 16, 2, 2, 4), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        kernels.bucket_reduce(gs, buckets.long(), 3, 1, 4)
    with pytest.raises(ValueError):
        kernels.bucket_reduce(gs, buckets.transpose(2, 3), 3, 1, 4)  # not contiguous
    with pytest.raises(ValueError):
        kernels.bucket_reduce(gs, buckets[:2].contiguous(), 3, 1, 4)  # G1 takes X, Y, Z
    with pytest.raises(ValueError):
        kernels.bucket_reduce(gs, buckets, 4, 1, 8)  # 4 lanes a window, not 2^(c - 1)


@pytest.mark.parametrize("group", [1, 2])
def test_msm_on_card_matches_host_oracle(card, group):
    def case(module):
        gen = module.g1() if group == 1 else module.g2()
        points = [gen * (3 * i + 1) for i in range(300)]
        points[7] = type(gen).identity()
        return points

    cm = get_curve_module("BN254", card)
    points = case(cm)
    rng = random.Random(10 + group)
    r = cm._curve.r
    scalars = [rng.randrange(r) for _ in range(300)]
    scalars[0], scalars[1] = 0, r - 1
    got = tmsm.msm_device(cm._curve, group, points, scalars, type(points[0]), card)
    assert got.to_bytes() == _host_msm(ec_bn254, case(ec_bn254), scalars).to_bytes()


@pytest.mark.parametrize("mxu", ["0", "1"])
@pytest.mark.parametrize("curve", CURVES)
def test_fixture_proof_on_card(card, curve, mxu, monkeypatch):
    from zksnake_tpu_torch import BLS12_381_SCALAR_FIELD, ConstraintSystem, R1CS, Var
    from zksnake_tpu_torch.backend import field
    from zksnake_tpu_torch.groth16 import Groth16, protocol

    monkeypatch.setenv("ZKSNAKE_MXU_MONTMUL", mxu)
    monkeypatch.setattr(field, "MXU_MIN_LANES", 16)  # K3 at this small size too
    rng = random.Random(f"g16-{curve}")
    monkeypatch.setattr(protocol, "get_random_int", lambda n_max: 1 + rng.randrange(n_max))
    inp, out = Var("inp"), Var("out")
    v = [Var(f"v{i}") for i in range(15)]
    fr = BN254_SCALAR_FIELD if curve == "BN254" else BLS12_381_SCALAR_FIELD
    cs = ConstraintSystem(["inp"], ["out"], fr)
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, 15):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[14])
    cs.set_public(out)
    r1cs = R1CS(cs, curve)
    r1cs.compile()
    pub, priv = r1cs.generate_witness(cs.solve({"inp": 3}))
    g16 = Groth16(r1cs, curve, device=card)
    before = kernels.LAUNCHES["mont_mul_mma"]
    g16.setup()
    proof = g16.prove(pub, priv)
    assert (kernels.LAUNCHES["mont_mul_mma"] > before) == (mxu == "1")
    want = (FIXTURES / f"groth16_{curve.lower()}.hex").read_text().strip()
    assert proof.to_bytes() == bytes.fromhex(want)
    assert g16.verify(proof, pub)


def u32_planes(shape, seed):
    """int32 planes of uniform 32-bit words (negative where the top bit is set)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


def ragged_starts(n, b2, seed):
    """b2 sorted starts in [0, n), the first 0 and the last n - 1."""
    rng = np.random.default_rng(seed)
    st = np.sort(rng.integers(0, n, size=b2))
    st[0], st[-1] = 0, n - 1
    return torch.from_numpy(st.astype(np.int32))


@pytest.mark.parametrize("name", ["expand_rows", "expand_rows_pm"])
@pytest.mark.parametrize("w, R", [(32, 37), (32, 385), (6, 37)])
def test_expand_rows_kernels_match_plain(card, name, w, R):
    """S1 and S7: rows of 32 words (the script's) and of 6 (source windows
    off 16-byte alignment), R odd, a window that ends at the last row."""
    n = 1000
    src, starts = u32_planes((n + R, w), 1), ragged_starts(n, 50, 2)
    before = kernels.LAUNCHES[name]
    got = getattr(relayout, name)(src.to(card), starts.to(card), R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(got.cpu(), relayout.expand_rows_plain(src, starts, R))


@pytest.mark.parametrize("R", [37, 392])
def test_expand_cols_kernel_matches_plain(card, R):
    """S3: every limb row's window starts at any word offset."""
    n = 1000
    x, starts = u32_planes((16, n + R), 3), ragged_starts(n, 50, 4)
    before = kernels.LAUNCHES["expand_cols"]
    got = relayout.expand_cols(x.to(card), starts.to(card), R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expand_cols"] == before + 1
    assert torch.equal(got.cpu(), relayout.expand_cols_plain(x, starts, R))


@pytest.mark.parametrize("name", ["expand_rows", "expand_rows_pm", "expand_cols"])
def test_expand_kernels_zero_windows_outside_the_source(card, name):
    """S1, S7 and S3: a start past n or below 0 gives a bucket of zeros,
    as the plain versions do; the buckets around it are copied."""
    n, R = 300, 37
    x = u32_planes((n + R, 6) if name != "expand_cols" else (16, n + R), 7)
    starts = torch.tensor([0, n, n + 1, n + R, -1, 5, 1 << 30], dtype=torch.int32)
    plain = relayout.expand_cols_plain if name == "expand_cols" else relayout.expand_rows_plain
    want = plain(x, starts, R)
    assert not want[[2, 3, 4, 6]].any() and want[[0, 1, 5]].all()
    got = getattr(relayout, name)(x.to(card), starts.to(card), R)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["transpose_tile", "copy_tile", "transpose_fat",
                                  "transpose_mma", "transpose_flat"])
@pytest.mark.parametrize("shape", [(100, 76), (37, 53), (32, 1000), (200, 320)])
def test_relayout_2d_kernels_match_plain(card, name, shape):
    """S2, S4, S5, S6 and S8 on planes that are no multiple of their tiles
    (and, at 37 x 53, of the 16-byte chunk); row 3 is all 0xFF bytes."""
    x = u32_planes(shape, 5)
    x[3] = -1
    plain = relayout.copy_plain if name == "copy_tile" else relayout.transpose_plain
    before = kernels.LAUNCHES[name]
    got = getattr(relayout, name)(x.to(card))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(got.cpu(), plain(x))


@pytest.mark.parametrize("shape", [(1, 4), (3, 5), (33, 132), (70, 301), (129, 2048),
                                   (4100, 260)])
def test_copy_tile_matches_plain_on_ragged_shapes(card, shape):
    """S4's TMA tiles at the array's edge in both directions (33 x 132, 4100
    x 260), a grid of more tiles than blocks (4100 x 260), and rows of 5 or
    301 words (a byte stride TMA cannot take: the kernel's 16-byte path and
    its word tail)."""
    x = u32_planes(shape, 7)
    before = kernels.LAUNCHES["copy_tile"]
    got = relayout.copy_tile(x.to(card))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["copy_tile"] == before + 1
    assert torch.equal(got.cpu(), relayout.copy_plain(x))


@pytest.mark.parametrize("variant", sorted(kernels.G2_BLOCK_VARIANTS))
def test_g2_block_kernel_matches_plain(card, variant):
    """S9 at 100 lanes (not a multiple of the 128-thread block)."""
    ins = debug_g2_block.inputs(variant, 100, card)
    before = kernels.LAUNCHES["g2_block"]
    got = kernels.g2_block(variant, ins)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["g2_block"] == before + 1
    want = kernels.g2_block_plain(variant, ins)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes", [1, 31, 100, 1024, (1 << 14) + 3])
@pytest.mark.parametrize("variant", ["addaff", "select"])
def test_g2_block_kernel_matches_plain_at_ragged_widths(card, variant, lanes):
    """The add (16 lanes an add, 8 adds a block) and the select, at widths
    that are not a multiple of a block."""
    ins = debug_g2_block.inputs(variant, lanes, card)
    got = kernels.g2_block(variant, ins)
    torch.cuda.synchronize()
    want = kernels.g2_block_plain(variant, ins)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes", [3, 100, 1024])
def test_g2_add_on_real_points(card, lanes):
    """BN254 G2 points: the identity, P = Q, P = -Q and Z1 != 1 lanes; the
    kernel equals the plain version and its sums are the host's."""
    planes, sums = debug_g2_block.point_inputs(lanes, card)
    got = kernels.g2_block("addaff", planes)
    torch.cuda.synchronize()
    for g, w in zip(got, kernels.g2_block_plain("addaff", planes)):
        assert torch.equal(g, w)
    assert [p.to_bytes() for p in debug_g2_block.points_of(got)] == [
        p.to_bytes() for p in sums]


def test_relayout_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = u32_planes((64, 64), 6).to(card)
    starts = torch.zeros(4, dtype=torch.int32, device=card)
    misaligned = torch.zeros(1 + 64 * 64, dtype=torch.int32, device=card)[1:].view(64, 64)
    for fn in (relayout.transpose_tile, relayout.copy_tile, relayout.transpose_fat,
               relayout.transpose_mma, relayout.transpose_flat):
        with pytest.raises(TypeError):
            fn(x.long())
        with pytest.raises(ValueError):
            fn(x[:, ::2])
        with pytest.raises(ValueError):
            fn(misaligned)
    for fn in (relayout.expand_rows, relayout.expand_rows_pm, relayout.expand_cols):
        with pytest.raises(ValueError):
            fn(x, starts.cpu(), 4)
        with pytest.raises(TypeError):
            fn(x, starts.long(), 4)
    ins = debug_g2_block.inputs("fq2mul", 8, card)
    with pytest.raises(ValueError):
        kernels.g2_block("fq2mul", ins[:3])
    with pytest.raises(ValueError):
        kernels.g2_block("fq2mul", ins[:3] + [ins[3].cpu()])
    with pytest.raises(TypeError):
        kernels.g2_block("fq2mul", [t.long() for t in ins])
