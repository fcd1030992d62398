"""K2's and K2m's constants, measured: build csrc/bucket.cu (K2) or
csrc/bucket_mma.cu (K2m, --kernel k2m) in variants and time each against
the port's own kernel at the prove shape on one CUDA card.

A variant is T/G/ring: the chunk length T, the fold's lanes a bucket G
(both in bucket_chunks.cuh, which the two kernels share), and, for K2,
which builds prefetch their points through the shared-memory ring:
"port" (as bucket.cu has it), "all" (BN254's G1 too, 3 steps) or "none".
K2m's product is collective over the warp and reads its points directly
(no build of it takes a ring), so its variants are T/G/port. Each variant
is a copy of the kernel's sources with those constants rewritten, built
for each curve's limb count into zksnake_tpu_torch/_build/sweep/
(registers and spills from ptxas), run on one MSM's sorted windows (2^17 points (i % 64 + 1) G
with seeded random scalars, c = 11, G1 and G2 of BN254 and BLS12-381)
through the port's launch path and checked against the port's kernel on
the same data: limb for limb where T and G are the port's, as points
otherwise. The port's kernel is first checked limb for limb against its
chunked plain version. Times: CUDA events, the mean of 3 calls after one
warm-up, the port's build timed before and after the variants; the chunk
and fold kernels' own device times from torch.profiler. Prints one JSON
line a variant build and a (variant or the port, curve, group).

Usage: python -m zksnake_tpu_torch.scripts.k2_chunk_sweep [--kernel k2|k2m]
           [--variants T/G/ring,...]
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
# kernel -> (its source, the port's library prefix, its wrapper)
KERNELS = {"k2": ("bucket.cu", "bucket", "bucket_accumulate"),
           "k2m": ("bucket_mma.cu", "bucket_mma", "bucket_accumulate_mma")}
# the lines a variant rewrites: the shared constants, and K2's rings
HEADER = "bucket_chunks.cuh"
CONSTANTS = re.compile(r"constexpr int T = \d+, G = \d+;")
RINGS = re.compile(r"STAGES = [^;]+;")
G1_RING = "STAGES = NW == 8 ? 0 : 3;"
DEFAULT_VARIANTS = {"k2": "4/4/port,12/4/port,8/8/port,8/4/all,8/4/none",
                    "k2m": "4/4/port,12/4/port,8/8/port"}


def variant_sources(kernel, t, g, ring):
    """{file name: text}: the variant's copies of the kernel's sources."""
    src_name = KERNELS[kernel][0]
    files = {f: open(os.path.join(kernels.CSRC, f)).read()
             for f in (src_name, HEADER, "field.cuh")}
    head, src = files[HEADER], files[src_name]
    if len(CONSTANTS.findall(head)) != 1 or (
            kernel == "k2" and (len(RINGS.findall(src)) != 2 or G1_RING not in src)):
        raise SystemExit(f"k2_chunk_sweep: {src_name}'s constants changed; update the sweep")
    files[HEADER] = CONSTANTS.sub(f"constexpr int T = {t}, G = {g};", head)
    if ring == "all" and kernel == "k2":
        src = src.replace(G1_RING, "STAGES = 3;")
    elif ring == "none" and kernel == "k2":
        src = RINGS.sub("STAGES = 0;", src)
    elif ring != "port":
        raise SystemExit(f"k2_chunk_sweep: ring {ring!r} is not port"
                         + (", all or none" if kernel == "k2" else " (K2m takes no ring)"))
    files[src_name] = src
    return files


def build(kernel, variants, nls):
    """Build every (variant, limb count) in parallel; {(spec, nl): C function}."""
    src_name, prefix, _ = KERNELS[kernel]
    procs = {}
    for i, (spec, (t, g, ring)) in enumerate(variants.items()):
        vdir = os.path.join(SWEEP_DIR, f"{kernel}_v{i}")
        os.makedirs(vdir, exist_ok=True)
        for name, text in variant_sources(kernel, t, g, ring).items():
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
        lib = ctypes.CDLL(so)
        fn = lib.zk_bucket_accumulate_mma if kernel == "k2m" else lib.zk_bucket_accumulate
        fn.argtypes = kernels.BUCKET_ARGTYPES[kernel == "k2m"]
        fn.restype = ctypes.c_int
        libs[spec, nl] = fn
    return libs


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
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k2")
    ap.add_argument("--variants", default=None,
                    help="comma-separated T/G/ring builds of the kernel (ring: port, all or "
                         "none; K2m: port only); default " + "; ".join(
                             f"{k}: {v}" for k, v in DEFAULT_VARIANTS.items()))
    ap.add_argument("--curves", default="BN254,BLS12_381")
    ap.add_argument("--groups", default="1,2")
    ap.add_argument("--log2n", type=int, default=17)
    ap.add_argument("--c", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_chunk_sweep: no CUDA device")
    variants = {}
    for spec in (args.variants or DEFAULT_VARIANTS[args.kernel]).split(","):
        t, g, ring = spec.split("/")
        variants[spec] = (int(t), int(g), ring)
    curves = {k: CURVES[k] for k in args.curves.split(",")}
    mma = args.kernel == "k2m"
    libs = build(args.kernel, variants, list(curves.values()))
    dev = torch.device("cuda")
    port_tg = (kernels.K2_CHUNK, kernels.K2_FOLD_LANES)
    wrapper = getattr(kernels, KERNELS[args.kernel][2])
    for curve_name, nl in curves.items():
        for group in [int(g) for g in args.groups.split(",")]:
            gs, pts, starts, lens = inputs(curve_name, group, args.log2n, args.c, dev)
            port = lambda: wrapper(gs, pts, starts, lens)  # noqa: E731
            want = port()
            if not torch.equal(want, kernels.bucket_accumulate_plain(
                    gs, pts, starts, lens, mode="mma" if mma else True,
                    chunk=kernels.K2_CHUNK)):
                raise SystemExit(f"{args.kernel} {curve_name} G{group} differs from its "
                                 f"chunked plain version")
            as_points = lambda x: gs.unflatten(list(x.reshape(x.shape[0], nl, -1)))  # noqa: E731
            port_before = time_ms(port)
            rows = [{"kernel": args.kernel,
                     "variant": f"port {kernels.K2_CHUNK}/{kernels.K2_FOLD_LANES}",
                     "curve": curve_name, "group": group, "points": 1 << args.log2n,
                     "c": args.c, "kernels_ms": kernel_ms(port)}]
            for spec, (t, g, ring) in variants.items():
                run = lambda: kernels._bucket_launch(  # noqa: E731
                    gs, pts, starts, lens, mma, build=(libs[spec, nl], t))  # noqa: B023
                got = run()
                same = torch.equal(got, want) if (t, g) == port_tg else \
                    bool(gs.equal(as_points(got), as_points(want)).all())
                if not same:
                    raise SystemExit(f"{args.kernel} {spec} {curve_name} G{group} differs "
                                     f"from the port's")
                rows.append({"kernel": args.kernel, "variant": spec, "curve": curve_name,
                             "group": group, "points": 1 << args.log2n, "c": args.c,
                             "chunks": int(kernels.chunk_table(lens, t)[-1]),
                             "equal_to_port": "limbs" if (t, g) == port_tg else "points",
                             "ms": time_ms(run), "kernels_ms": kernel_ms(run)})
            rows[0]["ms"] = port_ms = (port_before + time_ms(port)) / 2
            for row in rows:
                row.update(port_ms=port_ms, device=torch.cuda.get_device_name(0))
                print(json.dumps(row), flush=True)
            del pts, want


if __name__ == "__main__":
    main()
