"""S9 of the PyTorch port (the one-launch BN254 G2 probes) against the JAX
package.

Every variant of scripts/debug_g2_mosaic.py at 64 lanes: the port's
kernels.g2_block on CPU tensors (its plain version) against the JAX
package's own functions on the CPU, on the same canonical limb planes:
get_group_spec(ec_bn254._curve, 2) with its add_affine, F.mul_many, F.mul,
F.select and F.is_zero, and zksnake_tpu.backend.field.mont_mul on the
stacked tensor. addaff1 runs add_affine with DevFq2.mul_many patched to the
original's per-pair products, as the script does. Field arithmetic is
exact, so the comparison is limb for limb. The kernel itself runs only on a
card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zksnake_tpu.backend.curve_ops import DevFq2, get_group_spec
from zksnake_tpu.backend.field import mod_add, mod_sub, mont_mul
from zksnake_tpu.curves import ec_bn254
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.scripts import debug_g2_block

torch.set_num_threads(1)

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


def test_g2_block_refuses_what_it_does_not_take():
    ins = debug_g2_block.inputs("fq2mul", 8, "cpu")
    with pytest.raises(ValueError):
        kernels.g2_block("fqstack7", ins)
    with pytest.raises(ValueError):
        kernels.g2_block("fq2mul", ins[:3])
    with pytest.raises(ValueError):
        kernels.g2_block("fq2mul", [t.to("meta") for t in ins])
