"""Primitive benchmarks of the gather-free MSM pipeline on one CUDA card.

Port of the JAX package's scripts/bench_sortdma.py, its TPU probe of how
fast a round-major MSM table can be built from point planes sorted by
digit. Every stage keeps the original's name, shapes, numpy seed and value
range; the u32 words are held in int32 tensors (the same bits).

    python -m zksnake_tpu_torch.scripts.bench_sortdma [--stages sort,transpose,dma] [--log2n 20]

Stages (n = 2^log2n points, B2 = 4096 buckets, NL = 16 limbs):
  sort           sort by a 13-bit key, 2 NL payload planes gathered along
  transpose      (B2, R, 2 NL) -> (R, 2 NL, B2), R = 385
  dma            S1: out[b] = src[start_b : start_b + R] of (n + R, 2 NL)
  tkernel        S2: (B2, NL R) -> (NL R, B2) through 32 x 32 tiles, R = 392
  expand_dma     S3: out[b] = X[:, start_b : start_b + R] of (NL, n + R)
  expand_scan    the same expansion as one torch gather of whole windows
  tk_copy        S4: identity copy, tile by tile (TMA)
  tk_fat         S5: the transpose in 64 x 64 tiles, 16 bytes a thread
  tk_mxu         S6: the transpose on the tensor cores
  expand_dma_pm  S7: S1's function at R = 392 (its own kernel counter)
  tk_flat        S8: (2 NL, n) -> (n, 2 NL), whole 128-byte output rows
  transpose210   (B2, NL, R) -> (R, NL, B2)
  take_cols      gather of (NL, n + R) columns, then (2, 0, 1) transpose
  take_rows      gather of (n + R, NL) rows, then (0, 2, 1) transpose
The S stages launch the hand-written kernels of backend/relayout.py
(csrc/relayout.cu); the other six are torch ops.

It runs in one process (the original ran each stage in a subprocess, since
a failure poisoned the TPU process). Each stage runs once to warm up and
once timed between two CUDA events (the host clock on the CPU), then
spot-checks its output as the original does. One JSON line per stage, with
"s" and "gb_per_s" as in the original, then the list of all of them.
"""

import argparse
import collections
import json
import time

import numpy as np
import torch

from ..backend import relayout

NL = 16
# the original's sizes; tests and rehearsals pass smaller ones
SIZES = {"b2": 4096, "r_dma": 385, "r": 392}

Stage = collections.namedtuple("Stage", "run args nbytes info check")

# kernel stage -> (kernel name, its plain version)
KERNELS = {
    "dma": ("expand_rows", relayout.expand_rows_plain),
    "tkernel": ("transpose_tile", relayout.transpose_plain),
    "expand_dma": ("expand_cols", relayout.expand_cols_plain),
    "tk_copy": ("copy_tile", relayout.copy_plain),
    "tk_fat": ("transpose_fat", relayout.transpose_plain),
    "tk_mxu": ("transpose_mma", relayout.transpose_plain),
    "expand_dma_pm": ("expand_rows_pm", relayout.expand_rows_plain),
    "tk_flat": ("transpose_flat", relayout.transpose_plain),
}


def _planes(rng, high, size, device):
    """rng.integers(0, high) as u32, moved to `device` as int32 bits."""
    a = rng.integers(0, high, size=size).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def _starts(rng, n, b2, device):
    return torch.from_numpy(np.sort(rng.integers(0, n, size=b2)).astype(np.int32)).to(device)


def _check_buckets(idx, want):
    """Buckets `idx` of out against want(b): the original's spot check."""

    def check(out, args):
        for b in idx:
            if not torch.equal(out[b], want(b, args)):
                raise AssertionError(f"mismatch in bucket {b}")

    return check


def _check_corner(out, args):
    x = args[0]
    if not torch.equal(out[:256, :256], x[:256, :256].t()):
        raise AssertionError("transpose mismatch")


def make(stage, n, device, sizes=None):
    """The stage's function, inputs (drawn as the original draws them),
    bytes moved (the original's count) and spot check."""
    sz = dict(SIZES, **(sizes or {}))
    b2, r = sz["b2"], sz["r"]
    m = NL * r
    last = lambda *bs: sorted({min(b, b2 - 1) for b in bs})  # noqa: E731
    if stage == "sort":
        rng = np.random.default_rng(3)
        keys = torch.from_numpy(rng.integers(0, 1 << 13, size=n).astype(np.int32)).to(device)
        planes = torch.stack([_planes(rng, 1 << 16, n, device) for _ in range(2 * NL)])

        def run(keys, planes):
            k, order = torch.sort(keys, stable=True)
            return k, planes.index_select(1, order)[0]

        return Stage(run, (keys, planes), None, {"n": n, "payload_planes": 2 * NL}, None)
    if stage == "transpose":
        x = _planes(np.random.default_rng(4), 1 << 16, (b2, sz["r_dma"], 2 * NL), device)
        return Stage(lambda x: x.permute(1, 2, 0).contiguous(), (x,), x.numel() * 4, {}, None)
    if stage in ("dma", "expand_dma_pm"):
        rd = sz["r_dma"] if stage == "dma" else r
        rng = np.random.default_rng(5 if stage == "dma" else 7)
        src = _planes(rng, 1 << 16 if stage == "dma" else 1 << 30, (n + rd, 2 * NL), device)
        starts = _starts(rng, n, b2, device)
        run = relayout.expand_rows if stage == "dma" else relayout.expand_rows_pm
        want = lambda b, a: a[0][int(a[1][b]) : int(a[1][b]) + rd]  # noqa: E731
        idx = last(0, 17, b2 - 1) if stage == "dma" else last(0, 17, 39)
        return Stage(run, (src, starts, rd), b2 * rd * 2 * NL * 4, {}, _check_buckets(idx, want))
    if stage in ("expand_dma", "expand_scan"):
        rng = np.random.default_rng(7 if stage == "expand_dma" else 8)
        x = _planes(rng, 1 << 30, (NL, n + r), device)
        starts = _starts(rng, n, b2, device)
        if stage == "expand_dma":
            run = relayout.expand_cols
        else:
            def run(x, starts, r):  # every window of x, gathered at the starts
                return x.unfold(1, r, 1).transpose(0, 1).index_select(0, starts)
        want = lambda b, a: a[0][:, int(a[1][b]) : int(a[1][b]) + r]  # noqa: E731
        check = _check_buckets(last(0, 33, b2 - 1), want) if stage == "expand_dma" else None
        return Stage(run, (x, starts, r), b2 * NL * r * 4, {}, check)
    if stage in ("tkernel", "tk_copy", "tk_fat", "tk_mxu"):
        x = _planes(np.random.default_rng(6), 1 << 30, (b2, m), device)
        run = {"tkernel": relayout.transpose_tile, "tk_copy": relayout.copy_tile,
               "tk_fat": relayout.transpose_fat, "tk_mxu": relayout.transpose_mma}[stage]
        check = None if stage == "tk_copy" else _check_corner
        return Stage(run, (x,), b2 * m * 4, {}, check)
    if stage == "tk_flat":
        x = _planes(np.random.default_rng(9), 1 << 30, (2 * NL, n), device)

        def check(out, args):
            if not torch.equal(out[:256], args[0][:, :256].t()):
                raise AssertionError("tk_flat mismatch")

        return Stage(relayout.transpose_flat, (x,), 2 * NL * n * 4, {}, check)
    if stage == "transpose210":
        x = _planes(np.random.default_rng(4), 1 << 16, (b2, NL, r), device)
        return Stage(lambda x: x.permute(2, 1, 0).contiguous(), (x,), x.numel() * 4, {}, None)
    if stage in ("take_cols", "take_rows"):
        rng = np.random.default_rng(6)
        shape = (NL, n + r) if stage == "take_cols" else (n + r, NL)
        src = _planes(rng, 1 << 30, shape, device)
        starts = _starts(rng, n, b2, device)

        def take_cols(src, starts):  # pos (B2 R,) bucket-major, strided columns
            pos = (starts[:, None] + torch.arange(r, device=src.device)).reshape(-1)
            return src.index_select(1, pos).reshape(NL, b2, r).permute(2, 0, 1).contiguous()

        def take_rows(src, starts):  # pos (R B2,) round-major, contiguous rows
            pos = (torch.arange(r, device=src.device)[:, None] + starts[None, :]).reshape(-1)
            return src.index_select(0, pos).reshape(r, b2, NL).permute(0, 2, 1).contiguous()

        run = take_cols if stage == "take_cols" else take_rows
        return Stage(run, (src, starts), b2 * r * NL * 4, {}, None)
    raise ValueError(f"unknown stage {stage!r}")


STAGES = ["sort", "transpose", "dma", "tkernel", "expand_dma", "expand_scan", "tk_copy",
          "tk_fat", "tk_mxu", "expand_dma_pm", "tk_flat", "transpose210", "take_cols",
          "take_rows"]


def _timed(fn, args, device):
    """fn(*args) once to warm up, then once timed: (output, seconds)."""
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def measure(stage, n, device="cuda", sizes=None):
    """One stage: its result line as a dict."""
    device = torch.device(device)
    st = make(stage, n, device, sizes)
    out, dt = _timed(st.run, st.args, device)
    if st.check is not None:
        st.check(out, st.args)
    res = {"stage": stage, **st.info, "s": dt}
    if st.nbytes is not None:
        res["gb_per_s"] = st.nbytes / dt / 1e9
    return res


def run_stages(stages, n, device="cuda", sizes=None, echo=True):
    """Every stage of `stages` in turn; prints each result line (echo)."""
    results = []
    for stage in stages:
        results.append(measure(stage, n, device, sizes))
        if echo:
            print(json.dumps(results[-1]), flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", default="sort,transpose,dma")
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_sortdma: no CUDA device")
    results = run_stages(args.stages.split(","), 1 << args.log2n, args.device)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
