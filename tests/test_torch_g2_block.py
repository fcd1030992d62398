"""S9 of the PyTorch port (the one-launch BN254 G2 probes) against the JAX
package.

Every variant of scripts/debug_g2_mosaic.py at 64 lanes: the port's
kernels.g2_block on CPU tensors (its plain version) against the JAX
package's own functions on the CPU, on the same canonical limb planes:
get_group_spec(ec_bn254._curve, 2) with its add_affine, F.mul_many, F.mul,
F.select and F.is_zero, and zksnake_tpu.backend.field.mont_mul on the
stacked tensor. addaff1 runs add_affine with DevFq2.mul_many patched to the
original's per-pair products, as the script does. Field arithmetic is
exact, so the comparison is limb for limb. The add also runs on real G2
points (the identity, P = Q, P = -Q, Z1 != 1), and its kernel's schedule
(kernels.g2_add_schedule, the table csrc/g2_add_schedule.cuh is written
from) runs level by level through the plain field ops against the plain
add. The kernel itself runs only on a card
(tests/test_torch_kernels_cuda.py).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zksnake_tpu.backend.curve_ops import DevFq2, get_group_spec
from zksnake_tpu.backend.field import mod_add, mod_sub, mont_mul
from zksnake_tpu.curves import ec_bn254
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.scripts import debug_g2_block

import torch_support  # noqa: F401  (torch on one thread)

LANES = 64


def mul_many_naive(self, pairs):
    """scripts/debug_g2_mosaic.py:46-56: one Karatsuba product per pair."""
    out = []
    f = self.fs
    for (a0, a1), (b0, b1) in pairs:
        t0 = mont_mul(f, a0, b0)
        t1 = mont_mul(f, a1, b1)
        t2 = mont_mul(f, mod_add(f, a0, a1), mod_add(f, b0, b1))
        out.append((mod_sub(f, t0, t1), mod_sub(f, mod_sub(f, t2, t0), t1)))
    return out


def jax_outputs(variant, vals):
    """The body of debug_g2_mosaic.py's kernel (:71-94), outside Pallas."""
    gs = get_group_spec(ec_bn254._curve, 2)
    if variant in ("addaff", "addaff1"):
        P = ((vals[0], vals[1]), (vals[2], vals[3]), (vals[4], vals[5]))
        Q = ((vals[6], vals[7]), (vals[8], vals[9]))
        x3, y3, z3 = gs.add_affine(P, Q)
        return [x3[0], x3[1], y3[0], y3[1], z3[0], z3[1]]
    if variant == "fq2mul":
        (c0, c1), = gs.F.mul_many([((vals[0], vals[1]), (vals[2], vals[3]))])
        return [c0, c1]
    if variant == "fq2mul1":
        c0, c1 = gs.F.mul((vals[0], vals[1]), (vals[2], vals[3]))
        return [c0, c1]
    if variant == "select":
        cond = vals[0][0] > 0
        s = gs.F.select(cond, (vals[0], vals[1]), (vals[2], vals[3]))
        z = gs.F.is_zero(s)
        return [s[0], jnp.where(z[None], s[1], vals[0])]
    k = 3 if variant == "fqmul3d" else int(variant[7:])
    a = jnp.stack([vals[i % 2] for i in range(k)], axis=1)
    b = jnp.stack([vals[(i + 1) % 2] for i in range(k)], axis=1)
    p = mont_mul(gs.fs, a, b)
    return [p[:, 0], p[:, k - 1]]


@pytest.mark.parametrize("variant", sorted(kernels.G2_BLOCK_VARIANTS))
def test_g2_block_matches_jax(variant, monkeypatch):
    if variant == "addaff1":
        monkeypatch.setattr(DevFq2, "mul_many", mul_many_naive)
    ins = debug_g2_block.inputs(variant, LANES, "cpu")
    got = kernels.g2_block(variant, ins)
    want = jax_outputs(variant, [jnp.asarray(t.numpy().astype(np.uint32)) for t in ins])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


def test_select_takes_both_branches_and_the_zero_test():
    """Lane 0 of every input is 0: the select takes the second pair, which
    is zero, so the second output is its u part; elsewhere it is input 0."""
    ins = debug_g2_block.inputs("select", LANES, "cpu")
    cond = (ins[0][0] > 0).numpy()
    assert not cond[0] and cond.sum() > LANES // 2
    s0, out1 = kernels.g2_block("select", ins)
    assert torch.equal(s0[:, 0], torch.zeros(16, dtype=torch.int32))
    assert torch.equal(out1[:, 1:], ins[0][:, 1:])


def test_debug_g2_block_script_runs_every_variant():
    for variant in kernels.G2_BLOCK_VARIANTS:
        res = debug_g2_block.run(variant, "cpu", 16)
        assert res["variant"] == variant and res["lanes"] == 16


def test_inputs_are_canonical():
    from zksnake_tpu_torch.backend.field import FieldSpec
    from zksnake_tpu_torch.curves.params import CURVES

    fs = FieldSpec.get(CURVES["BN254"].p)
    for t in debug_g2_block.inputs("addaff", LANES, "cpu"):
        vals = fs.raw_from_host(t)
        assert max(vals) < fs.p and vals[:3] == [0, 1, fs.p - 1]


def jax_add(planes):
    vals = [jnp.asarray(t.numpy().astype(np.uint32)) for t in planes]
    return jax_outputs("addaff", vals)


@pytest.mark.parametrize("lanes", [1, 3, 20])
def test_add_on_real_points_matches_jax(lanes):
    """Real BN254 G2 points: the port's add limb for limb with the JAX
    package's GroupSpec.add_affine, and the right sums as points."""
    planes, want = debug_g2_block.point_inputs(lanes, "cpu")
    got = kernels.g2_block("addaff", planes)
    for g, w in zip(got, jax_add(planes)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    sums = debug_g2_block.points_of(got)
    assert [s.to_bytes() for s in sums] == [w.to_bytes() for w in want]
    if lanes > 2:  # P + (-P): Z3 = 0
        assert not got[4][:, 2].any() and not got[5][:, 2].any()


def test_add_schedule_reads_only_earlier_levels():
    """Every op of a level reads slots that an earlier level (or the
    inputs, 3b or the zero slot) wrote, and no two ops of a level write
    one slot: the kernel's lanes run a level's ops in any order."""
    sch = kernels.g2_add_schedule()
    written = set(range(10)) | set(sch["b3"]) | {sch["zero"]}
    kinds = []
    for kind, ops in sch["levels"]:
        kinds.append(kind)
        dsts = [op[0] for op in ops]
        assert len(set(dsts)) == len(dsts)
        reads = {s for op in ops for s in op[1:6]}
        assert reads <= written and not reads & set(dsts)
        assert not set(dsts) & ({sch["zero"]} | set(sch["b3"]))
        assert all(0 <= s < sch["slots"] for op in ops for s in op[:6])
        if kind == "mul":
            assert all(op[3] == sch["zero"] and op[6] == 0 for op in ops)
        written |= set(dsts)
    assert kinds.count("mul") == 3
    assert [len(ops) for kind, ops in sch["levels"] if kind == "mul"] == [15, 6, 18]


@pytest.mark.parametrize("lanes", [1, 31, 100])
@pytest.mark.parametrize("source", ["random", "points"])
def test_add_schedule_model_matches_plain(source, lanes):
    """The schedule run level by level (kernels.g2_add_model) equals the
    plain add limb for limb, at ragged widths."""
    if source == "random":
        planes = debug_g2_block.inputs("addaff", lanes, "cpu")
    else:
        planes, _ = debug_g2_block.point_inputs(lanes, "cpu")
    gs = kernels._g2_block_spec()
    got = kernels.g2_add_model(gs.fs, planes, gs.b3("cpu"))
    want = kernels.g2_block_plain("addaff", planes)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_add_schedule_header_is_current():
    """csrc/g2_add_schedule.cuh is the table g2_add_schedule() writes
    (rewrite it with kernels.write_g2_add_schedule())."""
    with open(os.path.join(kernels.CSRC, "g2_add_schedule.cuh")) as f:
        assert f.read() == kernels.g2_add_schedule_header()



def test_g2_block_refuses_what_it_does_not_take():
    ins = debug_g2_block.inputs("fq2mul", 8, "cpu")
    with pytest.raises(ValueError):
        kernels.g2_block("fqstack7", ins)
    with pytest.raises(ValueError):
        kernels.g2_block("fq2mul", ins[:3])
    with pytest.raises(ValueError):
        kernels.g2_block("fq2mul", [t.to("meta") for t in ins])
