"""K2's and K2m's constants, measured: build csrc/bucket.cu (K2) or
csrc/bucket_mma.cu (K2m, --kernel k2m) in variants and time each, at every
chunk length asked for, against the port's own kernel on one CUDA card.

A variant is K/G or K/G/M: the chunks a lane of the chunk kernel sums at
once (K, Shape in the kernel's source, for both groups; 0 the projective
order, one chunk a thread), the fold's lanes a bucket (G,
bucket_chunks.cuh, which the two kernels share) and the blocks an SM
should hold (M, Shape's MINB: it caps the registers; left as the source
has it where not given). The chunk length T is the wrapper's to pass, so
every variant runs at each T of --chunks (0: the wrapper's own,
kernels.k2_chunk) without another build. Each variant is a copy of the
kernel's sources with those constants rewritten, built for each curve's
limb count into zksnake_tpu_torch/_build/sweep/ (registers and spills
from ptxas), run through the port's launch path on each case and checked
against the port's kernel as points (both brought to affine normal form,
kernels.affine_normal_form). A case is curve:group[:points[:c[:msms]]],
the sorted windows of `msms` MSMs (default 1) over `points` distinct
points (default 2^log2n) with seeded random scalars, window c (default
--c), or "eip7594", the EIP-7594 request's K2 call (57 fixed-base MSMs of
24 x 4032 slots, BLS12-381 G1). The port's kernel is first checked against
its plain version: limb for limb where it returns the affine normal form,
after bringing its sums there where it sums in projective coordinates
(kernels.k2_members). Times: CUDA events, the mean of 3 calls after one
warm-up; the chunk and fold kernels' own device times from torch.profiler.
Prints one JSON line a variant build and a (variant or the port, T, case).

Usage: python -m zksnake_tpu_torch.scripts.k2_chunk_sweep [--kernel k2|k2m]
           [--variants K/G[/M],...] [--chunks T,...]
           [--cases BN254:1,BN254:1:32774:11,BN254:1:65536:11:2,eip7594]
           [--log2n 16] [--c 11]
"""

import argparse
import ctypes
import json
import os
import random
import re
import subprocess

import torch

from ..backend import kernels
from ..backend import msm as tmsm
from ..backend.curve_ops import get_group_spec
from ..curves import get_curve_module

CURVES = {"BN254": 16, "BLS12_381": 24}
SWEEP_DIR = os.path.join(kernels.BUILD_DIR, "sweep")
# kernel -> (its source, the port's library prefix, its wrapper)
KERNELS = {"k2": ("bucket.cu", "bucket", "bucket_accumulate"),
           "k2m": ("bucket_mma.cu", "bucket_mma", "bucket_accumulate_mma")}
# the lines a variant rewrites: the fold's lanes, and each group's Shape
HEADER = "bucket_chunks.cuh"
FOLD_LANES = re.compile(r"constexpr int G = \d+;")
SHAPES = re.compile(r"(static constexpr int BT = \d+, K = )[^,]+(, MINB = )([^;]+);")
DEFAULT_VARIANTS = "8/4,16/2,16/1"


def variant_sources(kernel, k, g, minb=None):
    """{file name: text}: the variant's copies of the kernel's sources."""
    src_name = KERNELS[kernel][0]
    files = {f: open(os.path.join(kernels.CSRC, f)).read()
             for f in (src_name, HEADER, "field.cuh")}
    if len(FOLD_LANES.findall(files[HEADER])) != 1 or len(SHAPES.findall(files[src_name])) != 2:
        raise SystemExit(f"k2_chunk_sweep: {src_name}'s constants changed; update the sweep")
    files[HEADER] = FOLD_LANES.sub(f"constexpr int G = {g};", files[HEADER])
    files[src_name] = SHAPES.sub(
        lambda m: f"{m[1]}{k}{m[2]}{m[3] if minb is None else minb};", files[src_name])
    return files


def build(kernel, variants, nls):
    """Build every (variant, limb count) in parallel; {(spec, nl): library}
    (ctypes, typed by kernels.bucket_lib)."""
    src_name, prefix, _ = KERNELS[kernel]
    procs = {}
    for i, (spec, kgm) in enumerate(variants.items()):
        vdir = os.path.join(SWEEP_DIR, f"{kernel}_v{i}")
        os.makedirs(vdir, exist_ok=True)
        for name, text in variant_sources(kernel, *kgm).items():
            with open(os.path.join(vdir, name), "w") as f:
                f.write(text)
        for nl in nls:
            tag = f"{kernel}_v{i}/{prefix}{nl}"
            so = os.path.join(SWEEP_DIR, tag + ".so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DZK_NL={nl}", "-o", so,
                   os.path.join(vdir, src_name)]
            procs[spec, nl] = (tag, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (spec, nl), (tag, so, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(SWEEP_DIR, tag + ".ptxas.txt"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise SystemExit(f"k2_chunk_sweep: nvcc of {spec} ({nl} limbs) failed:\n{log}")
        print(json.dumps({"kernel": kernel, "variant": spec, "nl": nl, "ptxas": [
            {"kernel": k, "registers": r, "spill_bytes": sp}
            for k, r, sp in kernels.ptxas_report(os.path.join("sweep", tag))]}), flush=True)
        libs[spec, nl] = kernels.bucket_lib(ctypes.CDLL(so), kernel == "k2m")
    return libs


def distinct_points(gs, cm, n, device, seed):
    """n distinct points, B_(i mod 64) + H_(i div 64) for seeded multiples
    B and H of the generator, affine with Z in {0, 1}."""
    gen = cm.g1() if gs.group == 1 else cm.g2()
    rng = random.Random(seed)
    m = -(-n // 64)
    B = gs.points_to_device([gen * rng.randrange(1, 1 << 64) for _ in range(64)], device)
    H = gs.points_to_device([gen * rng.randrange(1, 1 << 64) for _ in range(m)], device)
    return gs.normalize(gs.add(gs.map(lambda t: t.repeat(1, m)[:, :n], B),
                               gs.map(lambda t: t.repeat_interleave(64, dim=1)[:, :n], H)))


def inputs(curve_name, group, n, c, msms, device):
    """The sorted windows of `msms` MSMs over n distinct points of the group
    (distinct_points), seeded random scalars, window c."""
    cm = get_curve_module(curve_name, device)
    gs = get_group_spec(cm._curve, group)
    P = distinct_points(gs, cm, n, device, 0x2B + group)
    rng = random.Random(0x2B + group)
    r = cm._curve.r
    s = torch.stack([tmsm.scalars_to_device([rng.randrange(r) for _ in range(n)], r, device)
                     for _ in range(msms)], dim=1)
    pts, starts, lens, _, _ = tmsm.sort_by_digit(gs, P, s if msms > 1 else s[:, 0], c)
    return gs, pts, starts, lens, f"{msms} x {n} points c={c}"


def eip7594_inputs(device, N=4096, cell=64, jobs=None, seed=0x7594):
    """The EIP-7594 request's K2 call (6 blobs; KZGCells.compute_cells_and_
    proofs): BLS12-381 G1 MSMs over the prefix of N - cell bases of a
    FixedBaseTable of N distinct points (fixed_base_window(N)'s c, one
    window of W (N - cell) slots a job), `jobs` of them (default: as many as
    one sort group holds, msm._job_groups: 57 of the request's 768
    cell-proof jobs at N = 4096). Returns (gs, pts, starts, lens, c, jobs)."""
    cm = get_curve_module("BLS12_381", device)
    gs = get_group_spec(cm._curve, 1)
    table = tmsm.fixed_base_table(gs, distinct_points(gs, cm, N, device, seed))
    table = table.prefix(N - cell)
    n = N - cell
    jobs = jobs or max(1, tmsm.SORT_GROUP_ELEMS // (2 * gs.fs.nl * table.W * n))
    rng = random.Random(seed)
    r = cm._curve.r
    slimbs = torch.stack([tmsm.scalars_to_device([rng.randrange(r) for _ in range(n)], r, device)
                          for _ in range(jobs)], dim=1)
    pts, starts, lens = tmsm.sort_fixed_base(gs, table, slimbs)
    return gs, pts, starts, lens, table.c, jobs


def time_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn):
    """{kernel name: device ms} of one call of fn, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            key = next((k for k in ("chunk_kernel", "fold_kernel") if k in e.key), e.key[:40])
            if key == "fold_kernel" and "true>(" in e.key:  # the sums to normal form
                key = "fold_kernel, normal form"
            out[key] = out.get(key, 0.0) + e.device_time_total / 1e3
    return out


def parse_case(case, log2n, c):
    """(curve, group, points, c, msms) of a --cases entry; None: eip7594."""
    if case == "eip7594":
        return None
    parts = case.split(":")
    nums = [int(x) for x in parts[2:]] + [None] * 3
    return (parts[0], int(parts[1]), nums[0] or 1 << log2n, nums[1] or c, nums[2] or 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k2")
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help="comma-separated K/G[/M] builds of the kernel ('' for none)")
    ap.add_argument("--chunks", default="0",
                    help="comma-separated chunk lengths T to run the port and each variant at "
                         "(0: the wrapper's own)")
    ap.add_argument("--cases", default="BN254:1,BN254:2,BLS12_381:1,BLS12_381:2",
                    help="comma-separated curve:group[:points[:c[:msms]]], or eip7594")
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--c", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_chunk_sweep: no CUDA device")
    variants = {spec: tuple(int(x) for x in spec.split("/"))
                for spec in args.variants.split(",") if spec}
    chunks = [int(t) for t in args.chunks.split(",")]
    cases = [parse_case(case, args.log2n, args.c) for case in args.cases.split(",")]
    mma = args.kernel == "k2m"
    libs = build(args.kernel, variants,
                 sorted({CURVES[case[0] if case else "BLS12_381"] for case in cases}))
    dev = torch.device("cuda")
    _, prefix, wrapper = KERNELS[args.kernel]
    for case in cases:
        if case is None:
            gs, pts, starts, lens, c, jobs = eip7594_inputs(dev)
            curve_name, group = "BLS12_381", 1
            shape = f"{jobs} fixed-base MSMs of {pts.shape[-1]} slots c={c}"
        else:
            curve_name, group, n, c, msms = case
            gs, pts, starts, lens, shape = inputs(curve_name, group, n, c, msms, dev)
        nl = CURVES[curve_name]
        want = kernels.bucket_accumulate_plain(gs, pts, starts, lens,
                                               mode="mma" if mma else True, affine=True)
        port = getattr(kernels, wrapper)(gs, pts, starts, lens)
        members = kernels.k2_members(gs, mma)
        if not torch.equal(port if members else kernels.affine_normal_form(gs, port), want):
            raise SystemExit(f"{args.kernel} {curve_name} G{group} differs from its plain "
                             f"version")
        lib = kernels._lib(f"{prefix}{nl}")
        for spec, vlib in [("port", lib)] + [(v, libs[v, nl]) for v in variants]:
            for t in chunks:
                run = lambda: kernels._bucket_launch(  # noqa: E731
                    gs, pts, starts, lens, mma, build=(vlib, t or None))  # noqa: B023
                if not torch.equal(kernels.affine_normal_form(gs, run()), want):
                    raise SystemExit(f"{args.kernel} {spec} T={t} {curve_name} G{group} "
                                     f"differs from the port's")
                T = t or kernels.k2_chunk(pts.shape[2] * pts.shape[3],
                                          vlib.zk_bucket_members(group))
                print(json.dumps({
                    "kernel": args.kernel, "variant": spec, "chunk": T, "curve": curve_name,
                    "group": group, "shape": shape, "additions": int(lens.sum()),
                    "chunks": int(kernels.chunk_table(lens, T)[-1]), "ms": time_ms(run),
                    "kernels_ms": kernel_ms(run), "device": torch.cuda.get_device_name(0)}),
                    flush=True)
        del pts, want, port


if __name__ == "__main__":
    main()
