"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card: it carries the `cuda` marker and skips
(from inside the test, through the `card` fixture) where there is none. On
the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

K1, K2 and K2m (16- and 24-limb builds) and K3 must match their plain versions limb
for limb (integer field arithmetic has no tolerance), each wrapper must
count one launch per call, refuse what its kernel does not take, and the
MSM and the fixture proofs must come out the same on the card as on the
host. The MSM oracle is the JAX package's host bigint MSM, whose modules
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
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend import msm as tmsm
from zksnake_tpu_torch.backend.curve_ops import get_group_spec
from zksnake_tpu_torch.backend.field import FieldSpec
from zksnake_tpu_torch.curves import get_curve_module

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
    limbs[:, :3] = fs.raw_to_host([0, 1, fs.p - 1])
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
def test_mont_mul_mma_kernel_matches_plain(card, p):
    """K3 (ragged edge included: 4099 lanes is not a multiple of the block)
    against its plain version and against K1."""
    fs = FieldSpec.get(p)
    a = random_elems(fs, 4099, 3).to(card)
    b = random_elems(fs, 4099, 4).flip(1).contiguous().to(card)
    before = kernels.LAUNCHES["mont_mul_mma"]
    got = kernels.mont_mul_mma(fs, a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mont_mul_mma"] == before + 1
    assert torch.equal(got, kernels.mont_mul_mma_plain(fs, a, b))
    assert torch.equal(got, kernels.mont_mul(fs, a, b))


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
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
    assert torch.equal(got, kernels.bucket_accumulate_plain(gs, pts, starts, lens))


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
@pytest.mark.parametrize("group", [1, 2])
def test_bucket_mma_kernel_matches_plain_and_k2(card, curve, group):
    """K2m on ragged runs (empty buckets in the spread top window, and a
    last block past the final bucket: c = 6 gives 43 x 32 = 1376 lanes, not
    a multiple of the 64-lane block) against its plain version and against
    K2, limb for limb."""
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
    assert torch.equal(got, kernels.bucket_accumulate_mma_plain(gs, pts, starts, lens))
    assert torch.equal(got, kernels.bucket_accumulate(gs, pts, starts, lens))


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
@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
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
