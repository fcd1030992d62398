"""K2's constants, measured: build csrc/bucket.cu in variants and time each
against the port's own K2 at the prove shape on one CUDA card.

A variant is T/G/ring: the chunk length T, the fold's lanes a bucket G, and
which builds prefetch their points through the shared-memory ring: "port"
(as bucket.cu has it), "all" or "none". Each variant is a copy of bucket.cu
with those constants rewritten, built for each curve's limb count into
zksnake_tpu_torch/_build/sweep/ (registers and spills from ptxas), run on
one MSM's sorted windows (2^17 points (i % 64 + 1) G with seeded random
scalars, c = 11, G1 and G2 of BN254 and BLS12-381) and checked against the
port's K2 on the same data: limb for limb where T and G are the port's, as
points otherwise. The port's K2 is first checked limb for limb against its
chunked plain version. Times: CUDA events, the mean of 3 calls after one
warm-up, the port's build timed before and after the variants; the chunk
and fold kernels' own device times from torch.profiler. Prints one JSON
line a variant build and a (variant or the port, curve, group).

Usage: python -m zksnake_tpu_torch.scripts.k2_chunk_sweep
           [--variants 4/4/port,12/4/port,8/8/port,8/4/all,8/4/none]
           [--curves BN254,BLS12_381] [--groups 1,2] [--log2n 17] [--c 11]
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
from ..backend.curve_ops import get_group_spec
from ..backend.msm import scalars_to_device, sort_by_digit
from ..curves import get_curve_module

CURVES = {"BN254": 16, "BLS12_381": 24}
SWEEP_DIR = os.path.join(kernels.BUILD_DIR, "sweep")
# bucket.cu's lines a variant rewrites: the constants, and BN254 G1's ring
CONSTANTS = re.compile(r"constexpr int T = \d+, G = \d+;")
RINGS = re.compile(r"STAGES = [^;]+;")
G1_RING = "STAGES = NW == 8 ? 0 : 3;"


def variant_source(t, g, ring):
    src = open(os.path.join(kernels.CSRC, "bucket.cu")).read()
    if len(CONSTANTS.findall(src)) != 1 or G1_RING not in src or len(RINGS.findall(src)) != 2:
        raise SystemExit("k2_chunk_sweep: bucket.cu's constants changed; update the sweep")
    src = CONSTANTS.sub(f"constexpr int T = {t}, G = {g};", src)
    if ring == "all":
        src = src.replace(G1_RING, "STAGES = 3;")
    elif ring == "none":
        src = RINGS.sub("STAGES = 0;", src)
    elif ring != "port":
        raise SystemExit(f"k2_chunk_sweep: ring {ring!r} is not port, all or none")
    return src


def build(variants, nls):
    """Build every (variant, limb count) in parallel; {(spec, nl): library}."""
    os.makedirs(SWEEP_DIR, exist_ok=True)
    procs = {}
    for i, (spec, (t, g, ring)) in enumerate(variants.items()):
        src = variant_source(t, g, ring)
        for nl in nls:
            tag = f"bucket{nl}_v{i}"
            cu, so = os.path.join(SWEEP_DIR, tag + ".cu"), os.path.join(SWEEP_DIR, tag + ".so")
            with open(cu, "w") as f:
                f.write(src)
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DZK_NL={nl}", "-I", kernels.CSRC,
                   "-o", so, cu]
            procs[spec, nl] = (tag, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (spec, nl), (tag, so, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(SWEEP_DIR, tag + ".ptxas.txt"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise SystemExit(f"k2_chunk_sweep: nvcc of {spec} ({nl} limbs) failed:\n{log}")
        print(json.dumps({"variant": spec, "nl": nl, "ptxas": [
            {"kernel": k, "registers": r, "spill_bytes": sp}
            for k, r, sp in kernels.ptxas_report(os.path.join("sweep", tag))]}), flush=True)
        fn = ctypes.CDLL(so).zk_bucket_accumulate
        fn.argtypes = kernels._lib(f"bucket{nl}").zk_bucket_accumulate.argtypes
        fn.restype = ctypes.c_int
        libs[spec, nl] = fn
    return libs


def launch(fn, gs, pts, starts, lens, t):
    """One variant's K2 call (the port's launch, with chunks of t)."""
    nl, (_, _, Wn, n), B2 = gs.fs.nl, pts.shape, starts.shape[1]
    coff = torch.cumsum(torch.div(lens.reshape(-1) + (t - 1), t, rounding_mode="floor"),
                        0, dtype=torch.int32)
    cmax = (Wn * n + (t - 1) * Wn * B2) // t
    part = torch.empty((3 * gs.group, nl, cmax), dtype=torch.int32, device=pts.device)
    out = torch.empty((3 * gs.group, nl, Wn, B2), dtype=torch.int32, device=pts.device)
    fs = gs.fs
    rc = fn(pts.data_ptr(), starts.data_ptr(), lens.data_ptr(), coff.data_ptr(),
            part.data_ptr(), out.data_ptr(), nl, gs.group, Wn, B2, n, cmax,
            ctypes.addressof(fs.words("p")), fs.pinv32, ctypes.addressof(fs.words("one")),
            ctypes.addressof(gs.b3_words()), gs.b3_small(), torch.cuda.current_stream().cuda_stream)
    kernels._check(rc, "k2_chunk_sweep variant")
    return out


def inputs(curve_name, group, logn, c, device):
    cm = get_curve_module(curve_name, device)
    gs = get_group_spec(cm._curve, group)
    gen = cm.g1() if group == 1 else cm.g2()
    base = gs.points_to_device([gen * (i + 1) for i in range(64)], device)
    n = 1 << logn
    P = gs.map(lambda t: t.repeat(1, n // 64), base)
    rng = random.Random(0x2B + group)
    r = cm._curve.r
    s = scalars_to_device([rng.randrange(r) for _ in range(n)], r, device)
    pts, starts, lens, _, _ = sort_by_digit(gs, P, s, c)
    return gs, pts, starts, lens


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
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = next((k for k in ("chunk_kernel", "fold_kernel") if k in e.name), e.name[:40])
            out[key] = out.get(key, 0.0) + e.device_time_total / 1e3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="4/4/port,12/4/port,8/8/port,8/4/all,8/4/none",
                    help="comma-separated T/G/ring builds of csrc/bucket.cu "
                         "(ring: port, all or none)")
    ap.add_argument("--curves", default="BN254,BLS12_381")
    ap.add_argument("--groups", default="1,2")
    ap.add_argument("--log2n", type=int, default=17)
    ap.add_argument("--c", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_chunk_sweep: no CUDA device")
    variants = {}
    for spec in args.variants.split(","):
        t, g, ring = spec.split("/")
        variants[spec] = (int(t), int(g), ring)
    curves = {k: CURVES[k] for k in args.curves.split(",")}
    libs = build(variants, list(curves.values()))
    dev = torch.device("cuda")
    port_tg = (kernels.K2_CHUNK, kernels.K2_FOLD_LANES)
    for curve_name, nl in curves.items():
        for group in [int(g) for g in args.groups.split(",")]:
            gs, pts, starts, lens = inputs(curve_name, group, args.log2n, args.c, dev)
            port = lambda: kernels.bucket_accumulate(gs, pts, starts, lens)  # noqa: E731
            want = port()
            if not torch.equal(want, kernels.bucket_accumulate_plain(
                    gs, pts, starts, lens, chunk=kernels.K2_CHUNK)):
                raise SystemExit(f"K2 {curve_name} G{group} differs from its chunked plain version")
            as_points = lambda x: gs.unflatten(list(x.reshape(x.shape[0], nl, -1)))  # noqa: E731
            port_before = time_ms(port)
            rows = [{"variant": f"port {kernels.K2_CHUNK}/{kernels.K2_FOLD_LANES}",
                     "curve": curve_name, "group": group, "points": 1 << args.log2n,
                     "c": args.c, "kernels_ms": kernel_ms(port)}]
            for spec, (t, g, ring) in variants.items():
                run = lambda: launch(libs[spec, nl], gs, pts, starts, lens, t)  # noqa: E731, B023
                got = run()
                same = torch.equal(got, want) if (t, g) == port_tg else \
                    bool(gs.equal(as_points(got), as_points(want)).all())
                if not same:
                    raise SystemExit(f"K2 {spec} {curve_name} G{group} differs from the port's K2")
                rows.append({"variant": spec, "curve": curve_name, "group": group,
                             "points": 1 << args.log2n, "c": args.c,
                             "chunks": int(((lens.long() + t - 1) // t).sum()),
                             "equal_to_port": "limbs" if (t, g) == port_tg else "points",
                             "ms": time_ms(run), "kernels_ms": kernel_ms(run)})
            rows[0]["ms"] = port_ms = (port_before + time_ms(port)) / 2
            for row in rows:
                row.update(port_ms=port_ms, device=torch.cuda.get_device_name(0))
                print(json.dumps(row), flush=True)
            del pts, want


if __name__ == "__main__":
    main()
