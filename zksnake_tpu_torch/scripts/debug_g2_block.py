"""One-launch BN254 G2 probes on one CUDA card.

Port of the JAX package's scripts/debug_g2_mosaic.py, which put one piece
of the G2 arithmetic inside a one-block Pallas kernel to bisect a crash of
Mosaic (the TPU's Pallas compiler). Here each variant is one launch of the
S9 kernel (csrc/g2_block.cu, through kernels.g2_block), checked bit for bit
against its plain PyTorch version (kernels.g2_block_plain).

Variants:
  addaff   - one G2 mixed add (curve_ops add_affine; Karatsuba Fq2 products)
  addaff1  - the same add with its Karatsuba products issued pair by pair
             (the original patched DevFq2.mul_many so); on the card it is
             addaff's kernel, which spreads each level of the add's products
             over a lane group whatever order they were issued in
  fq2mul   - a single Fq2 (Karatsuba) product, mul_many of one pair
  fq2mul1  - the same product through DevFq2.mul
  fqmul3d  - one Fq mont_mul on a stacked (nl, 3, B) tensor
  fqstack5 / fqstack6 / fqstack15 / fqstack18 - the same at other stack widths
  select   - Fq2 select + is_zero

point_inputs makes the add's planes from real G2 points instead.

One deviation from the original: it drew 15-bit limbs, which for BN254 are
often not below p; the field operations take canonical elements, so the
inputs here are values below p (lanes 0, 1 and 2 hold 0, 1 and p - 1).

Usage: python -m zksnake_tpu_torch.scripts.debug_g2_block <variant>
"""

import argparse
import time

import numpy as np
import torch

from ..backend import kernels

LANES = 1024  # the original's B


def inputs(variant, lanes, device, seed=3):
    """The variant's (16, lanes) int32 limb planes of BN254 Fq elements < p."""
    from ..backend.field import FieldSpec
    from ..curves.params import CURVES

    fs = FieldSpec.get(CURVES["BN254"].p)
    rng = np.random.default_rng(seed)
    n_in = kernels.G2_BLOCK_VARIANTS[variant][2]
    out = []
    for _ in range(n_in):
        limbs = rng.integers(0, 1 << 16, size=(fs.nl, lanes), dtype=np.int64)
        limbs[-1] = rng.integers(0, int(fs.p_limbs[-1]), size=lanes)
        special = fs.raw_to_host([0, 1, fs.p - 1])[:, : min(3, lanes)]
        limbs[:, : special.shape[1]] = special
        out.append(torch.from_numpy(limbs.astype(np.int32)).to(device))
    return out


def point_inputs(lanes, device, seed=5):
    """The add's ten (16, lanes) planes made from real BN254 G2 points, and
    the host sums P_i + Q_i its outputs stand for. Q is affine (Z2 = 1) and
    never the identity; P is (0 : 1 : 0) on lane 0, Q = P on lane 1 (the
    doubling the complete formula covers), Q = -P on lane 2, and on every
    odd lane P is projective with Z1 != 1 (its affine coordinates times a
    random nonzero Fq2 scale)."""
    import random

    from ..backend.curve_ops import get_group_spec
    from ..curves import get_curve_module
    from ..curves.tower import Fq2Ops

    mod = get_curve_module("BN254", "cpu")
    gs = get_group_spec(mod._curve, 2)
    fs = gs.fs
    f2 = Fq2Ops(fs.p)
    rng = random.Random(seed)
    gen = mod.g2()

    def walk(n):  # base, base + step, base + 2 step, ...: one host add a point
        pt, step, out = gen * rng.randrange(1, 1 << 64), gen * rng.randrange(1, 1 << 64), []
        for _ in range(n):
            out.append(pt)
            pt = pt + step
        return out

    P, Q = walk(lanes), walk(lanes)
    if lanes > 0:
        P[0] = type(gen).identity()
    if lanes > 1:
        Q[1] = P[1]
    if lanes > 2:
        Q[2] = -P[2]
    coords = [[] for _ in range(10)]
    for i, (a, q) in enumerate(zip(gs._batch_affine(P), gs._batch_affine(Q))):
        if a is None:
            x, y, z = (0, 0), (1, 0), (0, 0)
        else:
            lam = (rng.randrange(1, fs.p), rng.randrange(fs.p)) if i % 2 else (1, 0)
            x, y, z = f2.mul(a[0], lam), f2.mul(a[1], lam), lam
        for c, v in zip(coords, (*x, *y, *z, *q[0], *q[1])):
            c.append(v)
    planes = [fs.to_device(fs.to_mont_host(c), device) for c in coords]
    return planes, [a + b for a, b in zip(P, Q)]


def points_of(outs):
    """The add's six output planes -> host BN254 G2 points."""
    from ..backend.curve_ops import get_group_spec
    from ..curves import get_curve_module

    mod = get_curve_module("BN254", "cpu")
    gs = get_group_spec(mod._curve, 2)
    o = [t.cpu() for t in outs]
    return gs.points_from_device(((o[0], o[1]), (o[2], o[3]), (o[4], o[5])), type(mod.g2()))


def run(variant, device="cuda", lanes=LANES):
    """One launch of `variant`, checked against its plain version."""
    device = torch.device(device)
    ins = inputs(variant, lanes, device)
    t0 = time.perf_counter()
    got = kernels.g2_block(variant, ins)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    want = kernels.g2_block_plain(variant, ins)
    if len(got) != len(want) or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"g2_block {variant}: kernel != plain version")
    return {"variant": variant, "lanes": lanes, "s": dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variant", choices=sorted(kernels.G2_BLOCK_VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("debug_g2_block: no CUDA device")
    res = run(args.variant, args.device)
    print(f"@@OK@@ {res['variant']} ran in {res['s']:.6f}s and equals its plain version",
          flush=True)


if __name__ == "__main__":
    main()
