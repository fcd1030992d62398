#!/usr/bin/env python3
"""Drive the PyTorch port's Groth16 prover (BN254 and BLS12-381), its
PlonK prover (BN254), its two measurement entry points, its sumcheck, its
commitments (KZG, IPA-PCS, Merkle), Bulletproofs and GKR once on one CUDA
card.

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --phases 0,1,2  # a subset (kernel checks only)
    python3 chip_smoke.py --rehearse      # the same phases at toy sizes on
                                          # the CPU; prints no result, exits 1

Phases, one line each or more:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions, the
     kernels' build from zksnake_tpu_torch/csrc (registers and spills; only
     the libraries of the chosen phases, PHASE_LIBS, and K1's);
  1. K1 (mont_mul) against its plain version, bit for bit, at (16, 2^20) for
     BN254 Fr and Fq and (24, 2^18) for BLS12-381 Fq, with 0, 1, p-1 lanes;
  2. K3 (mont_mul_mma) against its plain version, bit for bit, at the same
     shapes, timed in turns with K1; then against K1 and timed in turns with
     it at every launch width of the flagged warm proves of phases 11 and 12
     (K3_PATH_WIDTHS), with each path's loss, launches x (ms - bound);
  3. K2 (bucket_accumulate) against its plain version (affine normal form),
     bit for bit, on one MSM's windows over distinct points at the prove
     shape (2^17 points, c = 11), G1 and G2 of BN254 (16-limb build) and of
     BLS12-381 (24-limb build), at the G1 MSM's shape (2^20 points, c = 13)
     and at the EIP-7594 request's call (57 fixed-base MSMs, c = 11); its
     bounds at RCB15's and at batch-affine's products, the chunk length,
     the chunks, the exceptional members and the CUDA launches of one call;
  4. K2m (bucket_accumulate_mma) against its plain version and
     against K2, bit for bit, at the four prove shapes, at the G1 MSM's
     shape and at the flagged PlonK prove's (2^15 + 6 points, c = 11), each
     timed in turns with K2;
  5. a device-resident BN254 G1 MSM at 2^20 against the host oracle
     G * sum(s_i (i % 64 + 1)) for points (i % 64 + 1) G;
  6. the same MSM with ZKSNAKE_MXU_MONTMUL=1 (K2m for the buckets; the
     reduction is K4's under the flag too);
  7. the same MSM over BN254 G2 at 2^20, against G2 * sum(s_i (i % 64 + 1));
  8. the pinned proof fixtures tests/fixtures/groth16_{bn254,bls12_381}.hex
     reproduced on the card under the deterministic randomness streams;
  9. the same for tests/fixtures/plonk_{bn254,bls12_381}.hex, with the
     thresholds lowered so the setup's commitments and the fused prover run
     on the card;
 10. a main path: the mult-chain circuit at 2^17 constraints through
     Groth16(r1cs, "BN254", device="cuda"): setup, a cold and a warm prove,
     verify, with every kernel's launch count during the warm prove;
 11. a main path: the same at 2^17 over BLS12-381, a cold and a warm prove by
     default, then a warm prove with ZKSNAKE_MXU_MONTMUL=1 under the same
     r, s: the two proofs are byte-equal and verify, and K3 and K2m launch
     (and K2 does not) only under the flag, K4 with and without it, K3 at
     K3_PATH_WIDTHS' widths;
 12. a main path: the mult chain at 2^15 gates through Plonk(plonkish,
     "BN254", device="cuda"): front end, setup, a cold and a warm prove,
     verify, then a warm prove with ZKSNAKE_MXU_MONTMUL=1 under the same 11
     blinds: byte-equal proofs that verify; K1, K2 and K4 launch without
     the flag, K3, K2m and K4 (and no K2) under it, K3 at K3_PATH_WIDTHS'
     widths;
 13. a measurement path: every stage of zksnake_tpu_torch.scripts.bench_sortdma
     at its full shapes (n = 2^20, B2 = 4096, R = 385 / 392, NL = 16,
     M = 6272), each S1-S8 kernel launched on it; then each of them against
     its plain version, bit for bit, timed beside its bound and its plain
     version, and in turns with the fastest single PyTorch call of the same
     function;
 14. a measurement path: every variant of
     zksnake_tpu_torch.scripts.debug_g2_block at B = 1024 lanes (one S9
     launch each, checked by the script against its plain version); then
     each variant timed (a replayed CUDA graph of launches, and the eager
     call) beside its bound, the launch floor (one tiny PyTorch launch in
     a replayed graph) and its plain version; the add at 1024, 2^14 and
     2^17 lanes checked against its plain version and timed; the add on
     1024 pairs of real G2 points, against the plain version and the
     host's sums;
 15. the sumcheck of a dense random MLE through Sumcheck(n, r,
     device="cuda").prove, BN254 at 2^20 entries and BLS12-381 at 2^16: a
     cold and a warm prove, the device driver's rounds (one a variable) and
     K1's launches counted; the claim equals the table's sum, verify (with
     the MLE) accepts, the final evaluation and a 10-variable partial
     evaluation equal the host walk's, and the round polynomials and
     challenges equal the host path's on the first 2^14 entries;
 16. KZG at 2^20 coefficients (BN254) and 4096 (BLS12-381): setup under a
     seeded tau, commit (equal to G1 * f(tau) by one host scalar mul), open,
     verify, a tampered evaluation rejected, multi_open / multi_verify of
     three polynomials at two points and a tampered proof rejected; K2 and K4
     launch in commit, open and multi_open; then the host conversions apart:
     the setup's batch mul and its points' way to the host, and the SRS's
     way to device limbs with and without its affine normalization;
 17. the IPA-PCS over BN254 at n = 2^12 (hash-to-curve basis, commit, open,
     verify, the first round of the basis fold timed on the host,
     multi-open; K2 and K4 launch in commit and open); 64-bit Bulletproofs
     range proofs and the 64-element inner-product argument on both curves
     (prove, verify, a bytes round trip); GKR on tests/test_gkr.py's three
     circuits and a 10-gate, 4-layer circuit on both curves; a Merkle tree of
     4096 leaves; the RFC 9380 BLS12-381 hash-to-curve vectors;
 18. sharded proving (backend/sharding.py): (a) a one-rank NCCL mesh at
     full width: the mult chain at 2^17 constraints through
     Groth16(r1cs, "BN254", device="cuda", mesh=mesh) (setup, a cold and a
     warm prove, verify; the four-step QAP and the permuted key), the proof
     byte-equal to a one-device Groth16's under the same keys and r, s, K1
     and K2 launched (K3 and K2m not); the sharded G1 and G2 MSMs at 2^20
     against the host oracle; the four-step NTT at 2^20 against ntt_device,
     limb for limb; (b) 4 spawned ranks of one gloo group, all on the one
     card: the sharded G1 and G2 MSMs at 2^16, the four-step NTT at 2^16
     and Groth16 proves at 2^12 constraints (the sharded QAP) and at n = 8
     (the mesh does not divide the split: the replicated QAP), every rank's
     proofs equal to the one-device proofs;
 19. K4 (bucket_reduce) against its plain version, bit for bit, at the
     Groth16 prove's reduction shapes (c = 11, 24 windows; G1 with M = 4
     MSMs, G2 with M = 1; BN254 and BLS12-381, the top window spread as
     sort_by_digit spreads it) and at an EIP-7594 request's fixed-base pass
     (BLS12-381 G1, c = fixed_base_window(4096, 256), one window, 774 MSMs,
     no top-window fold), timed alone and by kernel (windows, Horner)
     beside its bounds, with the plain version's time.

It exits non-zero on any failure, when no CUDA device is present, and when
jax or any module of zksnake_tpu was imported. The last four lines are the
total seconds, the kernels' JSON record, the card's name and power limit,
and {"ok": true, "device": {...}}. A "details" line before them holds every
measurement as JSON.
"""

import argparse
import collections
import contextlib
import json
import os
import random
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

K1_SHAPES = [("BN254_Fr", 16, 20), ("BN254_Fq", 16, 20), ("BLS12_381_Fq", 24, 18)]
K2_CURVES = ["BN254", "BLS12_381"]
PROVE_LOGN = 17
MSM_LOGN = 20
PLONK_LOGN = 15
RELAYOUT_LOGN = 20  # bench_sortdma's n
G2_BLOCK_LANES = 1024  # debug_g2_mosaic.py's B
# S9's add: the script's width and two wider ones, to a reduction's 2^17
# points
G2_ADD_WIDTHS = (1024, 1 << 14, 1 << 17)
# phase 15: dense MLE tables (Spartan- and HyperPlonk-sized on BN254); the
# round polynomials are held to the host path's on a smaller table, since
# the host path makes four full partial evaluations a round
SUMCHECK_LOGN = {"BN254": 20, "BLS12_381": 16}
SUMCHECK_HOST_LOGN = 14
SUMCHECK_PARTIAL_VARS = 10
# phase 16: KZG coefficients (BN254: the PlonK size a powers-of-tau SRS
# serves; BLS12-381: EIP-4844's FIELD_ELEMENTS_PER_BLOB)
KZG_LOGN = {"BN254": 20, "BLS12_381": 12}
# phase 17: the IPA-PCS basis, the Bulletproofs bit size, GKR's wide circuit
# (the GKR takes one sumcheck variable a wire, so a layer of w wires walks
# tables of 2^w entries on the host)
IPA_LOGN = 12
RANGE_BITS = 64
GKR_WIDE = (10, 4)  # gates a layer, layers
MERKLE_LEAVES = 4096
# K3's launches by (field, lanes) in the flagged warm proves of phases 11
# (Groth16 BLS12-381, 2^17 constraints: 120) and 12 (PlonK BN254, 2^15
# gates: 200), as those phases count them (they fail if the count differs):
# the QAP's or the rounds' scalar-field products; the MSMs' base-field
# products are K2m's and K4's own
K3_PATH_WIDTHS = {
    "groth16_bls12_381": {
        ("BLS12_381_Fr", 131072): 63, ("BLS12_381_Fr", 65536): 51, ("BLS12_381_Fr", 262144): 5,
        ("BLS12_381_Fr", 131074): 1,
    },
    "plonk_bn254": {
        ("BN254_Fr", 65536): 66, ("BN254_Fr", 262144): 40, ("BN254_Fr", 131072): 23,
        ("BN254_Fr", 524288): 21, ("BN254_Fr", 393216): 17, ("BN254_Fr", 32774): 7,
        ("BN254_Fr", 32770): 5, ("BN254_Fr", 32768): 4, ("BN254_Fr", 32772): 4,
        ("BN254_Fr", 32773): 4, ("BN254_Fr", 32769): 3, ("BN254_Fr", 32771): 2,
        ("BN254_Fr", 98310): 1, ("BN254_Fr", 196608): 1, ("BN254_Fr", 229397): 1,
        ("BN254_Fr", 491610): 1,
    },
}

# Peak rates of one NVIDIA H100 SXM (dense): HBM3 3.35 TB/s and int8 tensor
# cores 1,979 TOP/s (NVIDIA's data sheet); 32-bit integer multiply-adds at 64
# per SM per clock (NVIDIA's throughput table, compute capability 9.0) x 132 SMs
# x 1.98 GHz, the clock behind the sheet's 67 TFLOP/s float32.
HBM_BYTES_S = 3.35e12
INT8_TC_OPS_S = 1979e12
CLOCK_HZ = 1.98e9
IMAD_OPS_S = 132 * 64 * CLOCK_HZ


def log(msg):
    print(msg, flush=True)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the slowest operation type over its peak rate. ops: [(count, rate)]."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max((n / rate for n, rate in ops), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cios_imads(nw):
    """32-bit integer multiply-adds of one CIOS product of nw-word elements
    (field.cuh::fmul: nw^2 for a*b, nw^2 for m*p, nw for m = t0 pinv), each
    32x32->64 multiply counted as two (its low and high halves)."""
    return 2 * (2 * nw * nw + nw)


class Ctx:
    def __init__(self, device, rehearse):
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.rehearse = rehearse
        self.kernels = {}
        self.paths = {}
        self.detail = {}
        self.libs = []  # the libraries phase 0 builds

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, reps):
        """Mean ms of fn over reps runs after one warm-up (CUDA events on the
        card, the host clock on the CPU)."""
        torch = self.torch
        fn()
        self.sync()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def graph_ms(self, fn, reps):
        """Mean device ms of fn over reps calls captured in one CUDA graph
        and replayed, so the host's launch overhead drops out (time_ms on
        the CPU)."""
        torch = self.torch
        if self.device.type != "cuda":
            return self.time_ms(fn, reps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class flag_env:
    """ZKSNAKE_MXU_MONTMUL set to `value` inside the block, restored after."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.saved = os.environ.get("ZKSNAKE_MXU_MONTMUL")
        os.environ["ZKSNAKE_MXU_MONTMUL"] = self.value

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("ZKSNAKE_MXU_MONTMUL", None)
        else:
            os.environ["ZKSNAKE_MXU_MONTMUL"] = self.saved


# ------------------------------------------------------------------ phases --


def phase_build(ctx):
    torch = ctx.torch
    from zksnake_tpu_torch.backend import kernels

    if ctx.device.type == "cuda":
        ctx.detail["smi"] = smi_line()
        t0 = time.perf_counter()
        kernels.build(ctx.libs)
        build_s = time.perf_counter() - t0
        ptxas = {name: kernels.ptxas_report(name) for name in ctx.libs}
        ctx.detail["ptxas"] = ptxas
        ctx.detail["build_s"] = build_s
        log(f"[0] card: {ctx.detail['smi']}")
        log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"[0] kernels built in {build_s:.3f} s from zksnake_tpu_torch/csrc")
        for name, rows in ptxas.items():
            log(f"[0] ptxas {name}: " + ", ".join(
                f"{k} {r} registers, {sp} B spilled" for k, r, sp in rows))
    else:
        log(f"[0] rehearsal on the CPU, torch {torch.__version__}")


def _random_elems(fs, nl, n, rng):
    """(nl, n) int32 limbs of values < p, lanes 0, 1, 2 = 0, 1, p - 1."""
    import numpy as np

    limbs = rng.integers(0, 1 << 16, size=(nl, n), dtype=np.int64)
    limbs[nl - 1] = rng.integers(0, int(fs.p_limbs[nl - 1]), size=n)
    limbs[:, 0] = 0
    limbs[:, 1] = 0
    limbs[0, 1] = 1
    limbs[:, 2] = fs.raw_to_host([fs.p - 1])[:, 0]
    return limbs.astype(np.int32)


def _moduli():
    from zksnake_tpu_torch import (BLS12_381_MODULUS, BLS12_381_SCALAR_FIELD, BN254_MODULUS,
                                   BN254_SCALAR_FIELD)

    return {"BN254_Fr": BN254_SCALAR_FIELD, "BN254_Fq": BN254_MODULUS,
            "BLS12_381_Fr": BLS12_381_SCALAR_FIELD, "BLS12_381_Fq": BLS12_381_MODULUS}


def _field_operands(ctx, seed):
    """[(name, fs, a, b)] at K1_SHAPES (toy widths in a rehearsal)."""
    import numpy as np

    from zksnake_tpu_torch.backend.field import FieldSpec

    mods = _moduli()
    rng = np.random.default_rng(seed)
    out = []
    for name, nl, logn in K1_SHAPES:
        if ctx.rehearse:
            logn = 10
        fs = FieldSpec.get(mods[name])
        assert fs.nl == nl
        n = 1 << logn
        a = ctx.torch.from_numpy(_random_elems(fs, nl, n, rng)).to(ctx.device)
        b = ctx.torch.from_numpy(_random_elems(fs, nl, n, rng)[:, ::-1].copy()).to(ctx.device)
        out.append((name, fs, a, b, logn))
    return out


def phase_k1(ctx):
    from zksnake_tpu_torch.backend import kernels

    rows = []
    for name, fs, a, b, logn in _field_operands(ctx, 1):
        nl, n = a.shape
        got = kernels.mont_mul(fs, a, b)
        want = kernels.mont_mul_plain(fs, a, b)
        ctx.sync()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"K1 {name}: kernel != plain (max |err| {err})")
        ms = ctx.time_ms(lambda: kernels.mont_mul(fs, a, b), 20)
        plain_ms = ctx.time_ms(lambda: kernels.mont_mul_plain(fs, a, b), 2)
        bms, bby = bound(3 * nl * 4 * n, [(cios_imads(nl // 2) * n, IMAD_OPS_S)])
        rows.append({"field": name, "shape": [nl, n], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby})
        log(f"[1] K1 mont_mul {name} ({nl}, 2^{logn}): bit-identical to plain; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({bby})")
    ctx.detail["k1"] = rows
    ctx.kernels["mont_mul"] = rows[0]


def phase_k3(ctx):
    from zksnake_tpu_torch.backend import kernels

    rows = []
    for name, fs, a, b, logn in _field_operands(ctx, 3):
        nl, n = a.shape
        got = kernels.mont_mul_mma(fs, a, b)
        want = kernels.mont_mul_mma_plain(fs, a, b)
        ctx.sync()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"K3 {name}: kernel != plain (max |err| {err})")
        if not ctx.torch.equal(got, kernels.mont_mul(fs, a, b)):
            raise AssertionError(f"K3 {name}: kernel != K1")
        # in turns, in one call: K3, K1, K1, K3
        k3a = ctx.time_ms(lambda: kernels.mont_mul_mma(fs, a, b), 20)
        k1a = ctx.time_ms(lambda: kernels.mont_mul(fs, a, b), 20)
        k1b = ctx.time_ms(lambda: kernels.mont_mul(fs, a, b), 20)
        k3b = ctx.time_ms(lambda: kernels.mont_mul_mma(fs, a, b), 20)
        plain_ms = ctx.time_ms(lambda: kernels.mont_mul_mma_plain(fs, a, b), 2)
        bms, bby = _k3_bound(nl, n)
        ms, k1_ms = (k3a + k3b) / 2, (k1a + k1b) / 2
        rows.append({"field": name, "shape": [nl, n], "max_abs_err": err, "ms": ms,
                     "k1_ms": k1_ms, "turns_ms": [k3a, k1a, k1b, k3b], "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": bby})
        log(f"[2] K3 mont_mul_mma {name} ({nl}, 2^{logn}): bit-identical to plain and K1; "
            f"K3 {ms:.4f} ms, K1 {k1_ms:.4f} ms (turns {k3a:.4f} {k1a:.4f} {k1b:.4f} "
            f"{k3b:.4f}), plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({bby})")
    ctx.detail["k3"] = rows
    ctx.kernels["mont_mul_mma"] = rows[0]
    _k3_path_widths(ctx)


def _k3_bound(nl, n):
    """K3's bound at (nl, n): its limb planes' bytes against its int8
    tensor-core MACs (two products of 3 NB^2 a lane in all) and the
    schoolbook's NW^2 32-bit multiply-adds (each counted twice)."""
    nb, nw = 2 * nl, nl // 2
    return bound(3 * nl * 4 * n, [(2 * 3 * nb * nb * n, INT8_TC_OPS_S),
                                  (2 * nw * nw * n, IMAD_OPS_S)])


def _k3_path_widths(ctx):
    """K3 against its plain version and K1, and timed in turns with K1, at
    every (field, lanes) of K3_PATH_WIDTHS (at most 256 lanes in a
    rehearsal): eager calls as a prove makes them (ms), and replayed in a
    CUDA graph, the card's time alone (device_ms). Then each path's loss by
    the rule, launches x (ms - bound) at each launch's own width, and K1's
    in the same terms."""
    import numpy as np

    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.backend.field import FieldSpec

    mods = _moduli()
    rng = np.random.default_rng(0x3A)
    timed = {}
    for key in sorted({k for hist in K3_PATH_WIDTHS.values() for k in hist}):
        name, width = key
        fs = FieldSpec.get(mods[name])
        nl, n = fs.nl, width if not ctx.rehearse else min(width, 256)
        a = ctx.torch.from_numpy(_random_elems(fs, nl, n, rng)).to(ctx.device)
        b = ctx.torch.from_numpy(_random_elems(fs, nl, n, rng)[:, ::-1].copy()).to(ctx.device)
        got = kernels.mont_mul_mma(fs, a, b)
        if not (ctx.torch.equal(got, kernels.mont_mul_mma_plain(fs, a, b))
                and ctx.torch.equal(got, kernels.mont_mul(fs, a, b))):
            raise AssertionError(f"K3 {name} at {n} lanes: kernel != plain or K1")
        k3a = ctx.time_ms(lambda: kernels.mont_mul_mma(fs, a, b), 20)
        k1a = ctx.time_ms(lambda: kernels.mont_mul(fs, a, b), 20)
        k1b = ctx.time_ms(lambda: kernels.mont_mul(fs, a, b), 20)
        k3b = ctx.time_ms(lambda: kernels.mont_mul_mma(fs, a, b), 20)
        g3a = ctx.graph_ms(lambda: kernels.mont_mul_mma(fs, a, b), 20)
        g1a = ctx.graph_ms(lambda: kernels.mont_mul(fs, a, b), 20)
        g1b = ctx.graph_ms(lambda: kernels.mont_mul(fs, a, b), 20)
        g3b = ctx.graph_ms(lambda: kernels.mont_mul_mma(fs, a, b), 20)
        timed[key] = {"field": name, "lanes": n, "ms": (k3a + k3b) / 2, "k1_ms": (k1a + k1b) / 2,
                      "turns_ms": [k3a, k1a, k1b, k3b], "device_ms": (g3a + g3b) / 2,
                      "k1_device_ms": (g1a + g1b) / 2, "device_turns_ms": [g3a, g1a, g1b, g3b],
                      "bound_ms": _k3_bound(nl, n)[0]}
    loss = {}
    for path, hist in K3_PATH_WIDTHS.items():
        rows = sorted(hist.items(), key=lambda kv: (-kv[1], kv[0]))
        p = loss[path] = {"launches": sum(hist.values()),
                          "widths": [dict(timed[k], launches=c) for k, c in rows]}
        for col in ("ms", "k1_ms", "device_ms", "k1_device_ms"):
            p[f"{col}_loss"] = sum(c * (timed[k][col] - timed[k]["bound_ms"]) for k, c in rows)
        log(f"[2] K3 on the flagged {path} warm prove: {p['launches']} launches, loss by the "
            f"rule {p['ms_loss']:.4f} ms eager, {p['device_ms_loss']:.4f} ms on the card (K1 "
            f"at the same widths {p['k1_ms_loss']:.4f} / {p['k1_device_ms_loss']:.4f} ms)")
        for k, c in rows:
            t = timed[k]
            turns = " ".join(f"{v:.4f}" for v in t["turns_ms"] + t["device_turns_ms"])
            log(f"[2]   {t['field']} {t['lanes']} lanes x {c}: K3 {t['ms']:.4f} ms eager, "
                f"{t['device_ms']:.4f} on the card; K1 {t['k1_ms']:.4f}, {t['k1_device_ms']:.4f} "
                f"(turns {turns}); bound {t['bound_ms']:.4f} ms")
    ctx.detail["k3_paths"] = loss


class k3_widths:
    """K3's launches by (field, lanes) inside the block, counted by
    wrapping kernels.mont_mul_mma (the package keeps no such count)."""

    def __enter__(self):
        from zksnake_tpu_torch.backend import kernels

        names = {p: name for name, p in _moduli().items()}
        self.kernels, self.orig, self.hist = kernels, kernels.mont_mul_mma, collections.Counter()

        def spy(fs, a, b):
            self.hist[(names[fs.p], a.shape[1])] += 1
            return self.orig(fs, a, b)

        kernels.mont_mul_mma = spy
        return self.hist

    def __exit__(self, *exc):
        self.kernels.mont_mul_mma = self.orig


def _check_k3_widths(ctx, path, hist):
    """The flagged prove's K3 widths are K3_PATH_WIDTHS[path] (on the card;
    a rehearsal's toy sizes launch K3 nowhere)."""
    got = sorted(hist.items(), key=lambda kv: (-kv[1], kv[0]))
    ctx.detail[f"k3_widths_{path}"] = got
    log(f"K3 widths of the flagged {path} warm prove (field, lanes): launches: {got}")
    if ctx.device.type == "cuda" and dict(hist) != K3_PATH_WIDTHS[path]:
        raise AssertionError(f"K3_PATH_WIDTHS[{path!r}] is stale: the prove launched {got}")


def _tiled_points(gs, curve_mod, n, device):
    """n device points (i % 64 + 1) G (the bench oracle's shape)."""
    base = [curve_mod.g1() * (i + 1) for i in range(64)] if gs.group == 1 else \
        [curve_mod.g2() * (i + 1) for i in range(64)]
    P64 = gs.points_to_device(base, device)
    return gs.map(lambda t: t.repeat(1, n // 64), P64), base


def _cuda_launches(ctx, fn):
    """CUDA kernels one call of fn runs on the card, from a torch.profiler
    trace of that call (None on the CPU or where the trace shows none)."""
    if ctx.device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        ctx.sync()
    n = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    return n or None


def _k2_shape(ctx, gs, slots, mma=False):
    """The chunks a lane of K2's (K2m's) chunk kernel sums at once for gs's
    group and its chunk length for a call of `slots` sorted slots
    (kernels.k2_members, k2_chunk); (None, None) in a rehearsal, where the
    plain version runs."""
    from zksnake_tpu_torch.backend import kernels

    if ctx.device.type != "cuda":
        return None, None
    members = kernels.k2_members(gs, mma)
    return members, kernels.k2_chunk(slots, members)


def _in_plain_form(gs, sums, members):
    """K2's or K2m's sums in their plain version's form, the affine normal
    form: as they are, or brought there where the build sums in projective
    coordinates (members 0)."""
    from zksnake_tpu_torch.backend import kernels

    return kernels.affine_normal_form(gs, sums) if members == 0 else sums


def _k2_inputs(ctx, curve_name, group, logn, c, seed=0x2B, n=None):
    """One MSM's sorted windows: n distinct points (2^logn unless given) of
    `group` with seeded random scalars, sorted for window size c."""
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import scalars_to_device, sort_by_digit
    from zksnake_tpu_torch.curves import get_curve_module
    from zksnake_tpu_torch.scripts.k2_chunk_sweep import distinct_points

    cm = get_curve_module(curve_name, ctx.device)
    curve = cm._curve
    rng = random.Random(seed)
    gs = get_group_spec(curve, group)
    n = n or 1 << logn
    for _ in range(n * (group - 1)):  # G2 takes the n draws that follow G1's
        rng.randrange(curve.r)
    P = distinct_points(gs, cm, n, ctx.device, seed + group)
    s = scalars_to_device([rng.randrange(curve.r) for _ in range(n)], curve.r, ctx.device)
    pts, starts, lens, _, _ = sort_by_digit(gs, P, s, c)
    return gs, pts, starts, lens


def _eip7594_k2_inputs(ctx):
    """The EIP-7594 request's K2 call (k2_chunk_sweep.eip7594_inputs: 57
    fixed-base MSMs over 4096 - 64 distinct bases); 3 MSMs over 64 - 8 when
    rehearsing."""
    from zksnake_tpu_torch.scripts.k2_chunk_sweep import eip7594_inputs

    if ctx.rehearse:
        return eip7594_inputs(ctx.device, N=64, cell=8, jobs=3)
    return eip7594_inputs(ctx.device)


def phase_k2(ctx):
    """K2 against its plain version (affine normal form), limb for limb, at
    the four prove shapes, at the G1 MSM's 2^20, c = 13 shape and at the
    EIP-7594 request's call (57 fixed-base MSMs of 24 x 4032 slots, c =
    11, BLS12-381 G1), over distinct points (the sums of the projective
    order, BN254's G1, brought to that form first); timed beside two bounds,
    the additions at RCB15's mixed add (11 or 13 products) and at
    batch-affine's 6 (portbench/peaks.py), and the exceptional members
    counted."""
    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.backend import kernels

    prove = (PROVE_LOGN, 11) if not ctx.rehearse else (9, 7)
    shapes = [(cv, g) + prove for cv in K2_CURVES for g in (1, 2)]
    shapes.append(("BN254", 1) + ((MSM_LOGN, 13) if not ctx.rehearse else (10, 9)))
    shapes.append(("eip7594", 1, None, None))
    rows = []
    for curve_name, group, logn, c in shapes:
        if curve_name == "eip7594":
            gs, pts, starts, lens, c, jobs = _eip7594_k2_inputs(ctx)
            curve_name, points = "BLS12_381", pts.shape[-1] * jobs
        else:
            gs, pts, starts, lens = _k2_inputs(ctx, curve_name, group, logn, c)
            jobs, points = 1, 1 << logn
        metrics.enable()
        metrics.reset()
        with metrics.phase("k2"):
            got = kernels.bucket_accumulate(gs, pts, starts, lens)
        odd = metrics.report()["k2"].get("bucket_exceptional")
        metrics.enable(False)
        metrics.reset()
        t0 = time.perf_counter()
        want = kernels.bucket_accumulate_plain(gs, pts, starts, lens, affine=True)
        ctx.sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        W_, B2 = starts.shape
        members, T = _k2_shape(ctx, gs, W_ * pts.shape[-1])
        err = int((_in_plain_form(gs, got, members).long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"K2 {curve_name} G{group} {points} points: kernel != plain "
                                 f"(max |err| {err})")
        ms = ctx.time_ms(lambda: kernels.bucket_accumulate(gs, pts, starts, lens), 3)
        adds = int(lens.sum())  # additions this data needs
        chunks = T and int(kernels.chunk_table(lens, T)[-1])
        nbytes = 4 * (pts.numel() + starts.numel() + lens.numel() + got.numel())
        bms, bby = _k2_bound(gs, adds, nbytes, False)
        ams, aby = _k2_affine_bound(gs, adds, nbytes)
        row = {"curve": curve_name, "group": group, "points": points, "c": c, "jobs": jobs,
               "windows": W_, "buckets": B2, "max_run": int(lens.max()), "mixed_adds": adds,
               "chunk": T, "members": members, "chunks": chunks, "max_abs_err": err,
               "bucket_exceptional": odd,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
               "affine_bound_ms": ams, "affine_bound_by": aby}
        if not rows:
            row["cuda_launches_per_call"] = _cuda_launches(
                ctx, lambda: kernels.bucket_accumulate(gs, pts, starts, lens))
        rows.append(row)
        log(f"[3] K2 bucket_accumulate {curve_name} G{group} {points} points c={c}"
            f"{f' ({jobs} fixed-base MSMs)' if jobs > 1 else ''} ({W_}x{B2} runs, longest "
            f"{row['max_run']}, {adds} additions; T = {T}, K = {members}, {chunks} "
            f"chunks, {odd} exceptional): "
            f"bit-identical to the affine plain version"
            f"{' once in normal form' if members == 0 else ''}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bounds {bms:.4f} ms at RCB15's products ({bby}), {ams:.4f} ms "
            f"at batch-affine's ({aby})"
            + ("" if "cuda_launches_per_call" not in row else
               f"; {row['cuda_launches_per_call'] or 'not measured:'} CUDA launches a call"))
        del pts, got, want
    ctx.detail["k2"] = rows
    ctx.kernels["bucket_accumulate"] = rows[0]


def _k2_affine_bound(gs, adds, nbytes):
    """K2's bound as portbench/peaks.py prices it: the additions at
    batch-affine's 6 products (18 for G2), each a CIOS product."""
    prods = adds * 6 * (1 if gs.group == 1 else 3)
    return bound(nbytes, [(prods * cios_imads(gs.fs.nl // 2), IMAD_OPS_S)])


def _k2_bound(gs, adds, nbytes, mma):
    """K2's and K2m's bound: the mixed adds this data needs, 13 products
    each (39 for G2's Karatsuba Fq2), 11 (33) where 3b is a small integer
    (GroupSpec.b3_small: G1 of both curves, BLS12-381's G2), whose two
    products by 3b both kernels make additions. A CIOS product is
    cios_imads words; K2m's is the 2 NW^2 schoolbook multiply-adds and
    3 NB^2 tensor-core MACs (6 NB^2 operations)."""
    nw = gs.fs.nl // 2
    per_add = 11 if gs.b3_small() else 13
    prods = adds * per_add * (1 if gs.group == 1 else 3)
    if not mma:
        return bound(nbytes, [(prods * cios_imads(nw), IMAD_OPS_S)])
    nb = 4 * nw
    return bound(nbytes, [(prods * 2 * nw * nw, IMAD_OPS_S),
                          (prods * 6 * nb * nb, INT8_TC_OPS_S)])


def phase_k2m(ctx):
    """K2m against its plain version (K3's products, affine normal form;
    the projective order's sums, BN254's G1, brought to that form) and
    against K2, limb for limb, at the four prove shapes, at the G1
    MSM's 2^20, c = 13 shape and at the flagged PlonK prove's (2^15 + 6
    points, c = 11, BN254 G1); timed in turns with K2 at each. Then K2 and
    K2m on overlapping runs (four windows of 2^8 points, c = 7) against
    their plain versions."""
    from zksnake_tpu_torch.backend import kernels

    prove = (PROVE_LOGN, 11) if not ctx.rehearse else (9, 7)
    shapes = [(cv, g) + prove + (None,) for cv in K2_CURVES for g in (1, 2)]
    shapes.append(("BN254", 1) + ((MSM_LOGN, 13) if not ctx.rehearse else (10, 9)) + (None,))
    plonk_n = (1 << PLONK_LOGN if not ctx.rehearse else 1 << 8) + 6  # the SRS's points
    shapes.append(("BN254", 1, None, 11 if not ctx.rehearse else 7, plonk_n))
    rows = []
    for curve_name, group, logn, c, n in shapes:
        gs, pts, starts, lens = _k2_inputs(ctx, curve_name, group, logn, c, n=n)
        n = pts.shape[-1]
        got = kernels.bucket_accumulate_mma(gs, pts, starts, lens)
        k2 = kernels.bucket_accumulate(gs, pts, starts, lens)
        t0 = time.perf_counter()
        want = kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode="mma", affine=True)
        ctx.sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        W_, B2 = starts.shape
        members, T = _k2_shape(ctx, gs, W_ * n, mma=True)
        err = int((_in_plain_form(gs, got, members).long() - want.long()).abs().max())
        where = f"K2m {curve_name} G{group} {n} points c={c}"
        if err != 0:
            raise AssertionError(f"{where}: kernel != plain (max |err| {err})")
        if not ctx.torch.equal(got, k2):
            raise AssertionError(f"{where}: kernel != K2")
        # in turns, in one call: K2m, K2, K2, K2m
        runs = {"k2m": lambda: kernels.bucket_accumulate_mma(gs, pts, starts, lens),
                "k2": lambda: kernels.bucket_accumulate(gs, pts, starts, lens)}
        turns = [ctx.time_ms(runs[k], 3) for k in ("k2m", "k2", "k2", "k2m")]
        ms, k2_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        adds = int(lens.sum())
        chunks = T and int(kernels.chunk_table(lens, T)[-1])
        nbytes = 4 * (pts.numel() + starts.numel() + lens.numel() + got.numel())
        bms, bby = _k2_bound(gs, adds, nbytes, True)
        row = {"curve": curve_name, "group": group, "points": n, "c": c,
               "windows": W_, "buckets": B2, "max_run": int(lens.max()), "mixed_adds": adds,
               "chunk": T, "chunks": chunks, "max_abs_err": err, "ms": ms, "k2_ms": k2_ms,
               "turns_ms": turns, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby}
        rows.append(row)
        log(f"[4] K2m bucket_accumulate_mma {curve_name} G{group} {n} points c={c} "
            f"({W_}x{B2} runs, {adds} additions, {chunks} chunks): bit-identical to the "
            f"plain version and to K2; K2m {ms:.3f} ms, K2 {k2_ms:.3f} ms (turns "
            + " ".join(f"{t:.3f}" for t in turns)
            + f"), plain {plain_ms:.1f} ms, bound {bms:.4f} ms ({bby})")
        del pts, got, want, k2
    ctx.detail["k2m"] = rows
    ctx.kernels["bucket_accumulate_mma"] = rows[0]
    # overlapping runs, as a direct call may give them: more chunks than the
    # scratch holds, which the fold sums from their points; K2 and K2m
    # against their plain versions
    import numpy as np

    torch = ctx.torch
    for curve_name, group in (("BN254", 1), ("BLS12_381", 2)):
        gs, pts, starts, _ = _k2_inputs(ctx, curve_name, group, 8, 7)
        pts = pts[:, :, :4].contiguous()  # four windows' rows of real points
        W_, B2 = 4, starts.shape[1]
        n = pts.shape[-1]
        rng = np.random.default_rng(group)
        lens = torch.from_numpy(rng.integers(0, n + 1, size=(W_, B2)).astype(np.int32))
        starts = torch.minimum(torch.from_numpy(
            rng.integers(0, n + 1, size=(W_, B2)).astype(np.int32)), n - lens)
        starts, lens = starts.to(ctx.device), lens.to(ctx.device)
        members, T = _k2_shape(ctx, gs, W_ * n)
        T = T or kernels.K2_CHUNK  # a rehearsal: the plain version has no chunks
        chunks = int(kernels.chunk_table(lens, T)[-1])
        cap = kernels.chunk_scratch(W_, B2, n, T)
        if chunks <= cap:
            raise AssertionError(f"overlapping runs: {chunks} chunks fit the scratch ({cap})")
        for name, mode in (("bucket_accumulate", True), ("bucket_accumulate_mma", "mma")):
            got = getattr(kernels, name)(gs, pts, starts, lens)
            want = kernels.bucket_accumulate_plain(gs, pts, starts, lens, mode=mode, affine=True)
            if not torch.equal(_in_plain_form(gs, got, members), want):
                raise AssertionError(f"{name} {curve_name} G{group}, overlapping runs: "
                                     f"kernel != plain")
        log(f"[4] K2 and K2m {curve_name} G{group}, overlapping runs ({W_}x{B2} runs over "
            f"{n} points, {chunks} chunks, scratch {cap}): bit-identical to their plain "
            f"versions")


def _msm_2e20(ctx, tag, group=1):
    """One warm-up and one timed device-resident BN254 MSM of 2^MSM_LOGN
    points (i % 64 + 1) G of `group`, checked against the host oracle
    G * sum(s_i (i % 64 + 1))."""
    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import msm_device_raw, scalars_to_device
    from zksnake_tpu_torch.curves import get_curve_module

    cm = get_curve_module("BN254", ctx.device)
    curve = cm._curve
    gs = get_group_spec(curve, group)
    logn = MSM_LOGN if not ctx.rehearse else 10
    n = 1 << logn
    rng = random.Random(0xBEEF)
    P, _ = _tiled_points(gs, cm, n, ctx.device)
    scalars = [rng.randrange(curve.r) for _ in range(n)]
    s = scalars_to_device(scalars, curve.r, ctx.device)
    msm_device_raw(gs, P, s)  # warm-up
    ctx.sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = msm_device_raw(gs, P, s)
    ctx.sync()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    total = sum(si * (i % 64 + 1) for i, si in enumerate(scalars))
    gen, cls = (cm.g1(), cm.PointG1) if group == 1 else (cm.g2(), cm.PointG2)
    want = gen * (total % curve.r)
    got = gs.points_from_device(gs.map(lambda t: t[:, None], res), cls)[0]
    if got != want:
        raise AssertionError(f"G{group} MSM ({tag}) result does not match the host oracle")
    return {"group": group, "points": n, "seconds": dt, "points_per_s": n / dt,
            "launches": launches}, logn


def phase_msm(ctx):
    row, logn = _msm_2e20(ctx, "CIOS")
    ctx.detail["msm"] = row
    log(f"[5] G1 MSM 2^{logn}: equals the host oracle; {row['seconds']:.4f} s, "
        f"{row['points_per_s']:.1f} points/s; launches {row['launches']}")


def phase_msm_mma(ctx):
    with flag_env("1"):
        row, logn = _msm_2e20(ctx, "ZKSNAKE_MXU_MONTMUL=1")
    if ctx.device.type == "cuda" and (row["launches"]["bucket_accumulate_mma"] == 0
                                      or row["launches"]["bucket_reduce"] == 0
                                      or row["launches"]["bucket_accumulate"] != 0):
        raise AssertionError(f"the MSM under ZKSNAKE_MXU_MONTMUL=1 did not run K2m and K4, "
                             f"without K2: {row['launches']}")
    ctx.detail["msm_mma"] = row
    log(f"[6] G1 MSM 2^{logn}, ZKSNAKE_MXU_MONTMUL=1: equals the host oracle; "
        f"{row['seconds']:.4f} s, {row['points_per_s']:.1f} points/s "
        f"(CIOS in phase 5: {ctx.detail.get('msm', {}).get('seconds', float('nan')):.4f} s); "
        f"launches {row['launches']}")


def phase_msm_g2(ctx):
    row, logn = _msm_2e20(ctx, "G2", group=2)
    ctx.detail["msm_g2"] = row
    log(f"[7] G2 MSM 2^{logn}: completes and equals the host oracle; {row['seconds']:.4f} s, "
        f"{row['points_per_s']:.1f} points/s; launches {row['launches']}")


class patched:
    """Attributes of `module` set to `values` inside the block, restored
    after: the port's dispatch thresholds, a module's get_random_int."""

    def __init__(self, module, **values):
        self.module, self.values = module, values

    def __enter__(self):
        self.saved = {k: getattr(self.module, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


def det_random(module, seed, draws=None):
    """`module`.get_random_int drawing 1 + random.Random(seed).randrange(n)
    inside the block, each draw appended to `draws` where given."""
    rng = random.Random(seed)

    def draw(n_max):
        value = 1 + rng.randrange(n_max)
        if draws is not None:
            draws.append(value)
        return value

    return patched(module, get_random_int=draw)


def lowered_thresholds():
    """The port's PlonK and MSM dispatch thresholds at 1 inside the block,
    so a small circuit takes the device paths."""
    from zksnake_tpu_torch.backend import config

    return patched(config, PLONK_DEVICE_THRESHOLD=1, MSM_DEVICE_THRESHOLD=1)


def _scalar_field(curve):
    from zksnake_tpu_torch import BLS12_381_SCALAR_FIELD, BN254_SCALAR_FIELD

    return {"BN254": BN254_SCALAR_FIELD, "BLS12_381": BLS12_381_SCALAR_FIELD}[curve]


def _mult_chain(n_power, curve, inp_value):
    """The reference benchmark circuit (bench.py::_build_mult_chain):
    out = inp^n_power, public out; n_power = 16, inp = 3 is the fixture."""
    from zksnake_tpu_torch import ConstraintSystem, R1CS, Var

    inp, out = Var("inp"), Var("out")
    v = [Var(f"v{i}") for i in range(n_power - 1)]
    cs = ConstraintSystem(["inp"], ["out"], _scalar_field(curve))
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, n_power - 1):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[n_power - 2])
    cs.set_public(out)
    r1cs = R1CS(cs, curve)
    r1cs.compile()
    pub, priv = r1cs.generate_witness(cs.solve({"inp": inp_value}))
    return r1cs, pub, priv


def _fixture_bytes(proto, curve):
    path = os.path.join(REPO, "tests", "fixtures", f"{proto}_{curve.lower()}.hex")
    with open(path) as f:
        return bytes.fromhex(f.read().strip())


def phase_fixtures(ctx):
    from zksnake_tpu_torch.groth16 import Groth16, protocol

    for curve in ("BN254", "BLS12_381"):
        with det_random(protocol, f"g16-{curve}"):
            r1cs, pub, priv = _mult_chain(16, curve, 3)
            g16 = Groth16(r1cs, curve, device=ctx.device)
            g16.setup()
            proof = g16.prove(pub, priv)
            ok = g16.verify(proof, pub)
        if proof.to_bytes() != _fixture_bytes("groth16", curve) or not ok:
            raise AssertionError(f"{curve} Groth16 fixture proof bytes differ")
        log(f"[8] fixture proof {curve}: byte-identical to "
            f"tests/fixtures/groth16_{curve.lower()}.hex, verifies")


def _plonk_chain(n_power, curve, inp_value):
    """The mult chain (bench.py::_measure_plonk) as Plonkish gates:
    out = inp^n_power, public out; Plonkish.length is n_power."""
    from zksnake_tpu_torch import ConstraintSystem, Var
    from zksnake_tpu_torch.arithmetization import Plonkish

    inp, out = Var("inp"), Var("out")
    v = [Var(f"v{i}") for i in range(n_power - 1)]
    cs = ConstraintSystem(["inp"], ["out"], _scalar_field(curve))
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, n_power - 1):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[n_power - 2])
    cs.set_public(out)
    plonkish = Plonkish(cs, curve)
    plonkish.compile()
    pub, priv = plonkish.generate_witness(plonkish.solve({"inp": inp_value}))
    return plonkish, pub, priv


def phase_plonk_fixtures(ctx):
    from zksnake_tpu_torch.plonk import Plonk, protocol

    for curve in ("BN254", "BLS12_381"):
        with det_random(protocol, f"plonk-{curve}"), lowered_thresholds():
            plonkish, pub, priv = _plonk_chain(16, curve, 3)
            plonk = Plonk(plonkish, curve, device=ctx.device)
            plonk.setup()
            proof, _, launches = _counted(ctx, lambda: plonk.prove(pub, priv))
            ok = plonk.verify(proof, pub)
        if proof.to_bytes() != _fixture_bytes("plonk", curve) or not ok:
            raise AssertionError(f"{curve} PlonK fixture proof bytes differ")
        _require_launches(ctx, f"PlonK fixture {curve}", launches, ("mont_mul", "bucket_accumulate"))
        log(f"[9] fixture proof {curve}: byte-identical to tests/fixtures/plonk_"
            f"{curve.lower()}.hex (fused prover on the device, launches {launches}), verifies")


def _counted(ctx, fn):
    """(fn(), seconds, launches) with every launch counter set to 0 just
    before the call and read just after."""
    from zksnake_tpu_torch.backend import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    ctx.sync()
    return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def _nz(launches):
    """The counters of a launch record that are not 0."""
    return {k: v for k, v in launches.items() if v}


def _prove_counted(ctx, prove, protocol, seed=None):
    """One prove() counted by _counted; `seed` fixes the protocol module's
    randomness (Groth16's r, s; PlonK's 11 blinds). Returns (proof,
    seconds, launches)."""
    with det_random(protocol, seed) if seed is not None else contextlib.nullcontext():
        return _counted(ctx, prove)


def _require_launches(ctx, path, launches, names, absent=()):
    """Every kernel of `names` was launched on the path and none of
    `absent` (on the card; the CPU counts nothing)."""
    if ctx.device.type != "cuda":
        return
    if min(launches[k] for k in names) == 0 or any(launches[k] for k in absent):
        raise AssertionError(f"{path}: expected {names} launched and {absent} not: {launches}")


def _groth16_path(ctx, curve, tag):
    """Front end, setup and a cold prove of the mult chain at 2^PROVE_LOGN."""
    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.groth16 import Groth16, protocol

    logn = PROVE_LOGN if not ctx.rehearse else 6
    t0 = time.perf_counter()
    r1cs, pub, priv = _mult_chain(1 << logn, curve, 2)
    t_front = time.perf_counter() - t0
    g16 = Groth16(r1cs, curve, device=ctx.device)
    metrics.enable()
    metrics.reset()
    t0 = time.perf_counter()
    g16.setup()
    ctx.sync()
    t_setup = time.perf_counter() - t0
    setup_phases = metrics.report()
    _, t_cold, _ = _prove_counted(ctx, lambda: g16.prove(pub, priv), protocol)
    row = {"curve": curve, "constraints": 1 << logn, "frontend_s": t_front,
           "setup_s": t_setup, "prove_cold_s": t_cold, "setup_phases": setup_phases}
    log(f"[{tag}] Groth16 {curve} 2^{logn} constraints: frontend {t_front:.3f} s, "
        f"setup {t_setup:.3f} s, prove cold {t_cold:.3f} s")
    log(f"[{tag}] setup phases " + json.dumps({k: v["seconds"] for k, v in setup_phases.items()}))
    return g16, pub, priv, row


K_DEFAULT = ("mont_mul", "bucket_accumulate", "bucket_reduce")  # launched without the flag
# under the flag (K1 only where a product is narrower than MXU_MIN_LANES)
K_FLAG = ("mont_mul_mma", "bucket_accumulate_mma", "bucket_reduce")
K_FLAG_ONLY = ("mont_mul_mma", "bucket_accumulate_mma")
K_MSM = ("bucket_accumulate", "bucket_reduce")  # an MSM's own kernels, without the flag


def phase_bn254(ctx):
    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.groth16 import protocol

    g16, pub, priv, row = _groth16_path(ctx, "BN254", 10)
    metrics.reset()
    proof, t_warm, launches = _prove_counted(ctx, lambda: g16.prove(pub, priv), protocol)
    prove_phases = metrics.report()
    metrics.enable(False)
    t0 = time.perf_counter()
    ok = g16.verify(proof, pub)
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the BN254 main-path proof does not verify")
    _require_launches(ctx, "Groth16 BN254 warm prove", launches, K_DEFAULT, K_FLAG_ONLY)
    ctx.paths["bn254_prove_warm"] = launches
    row.update(prove_warm_s=t_warm, verify_s=t_verify, launches_warm=launches,
               prove_phases=prove_phases)
    ctx.detail["prove_bn254"] = row
    log(f"[10] warm prove {t_warm:.3f} s, verify {t_verify:.3f} s: True; "
        f"warm-prove launches {launches}")
    log("[10] prove phases " + json.dumps({k: v["seconds"] for k, v in prove_phases.items()}))


def phase_bls12_381(ctx):
    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.groth16 import protocol

    g16, pub, priv, row = _groth16_path(ctx, "BLS12_381", 11)
    seed = "chip-smoke-bls12-381-r-s"
    prove = lambda: g16.prove(pub, priv)  # noqa: E731
    metrics.reset()
    proof, t_warm, launches = _prove_counted(ctx, prove, protocol, seed)
    phases_off = metrics.report()
    metrics.reset()
    with flag_env("1"), k3_widths() as widths:
        proof_mma, t_mma, launches_mma = _prove_counted(ctx, prove, protocol, seed)
    phases_on = metrics.report()
    metrics.enable(False)
    _check_k3_widths(ctx, "groth16_bls12_381", widths)
    if proof.to_bytes() != proof_mma.to_bytes():
        raise AssertionError("BLS12-381: the proof differs with ZKSNAKE_MXU_MONTMUL=1")
    t0 = time.perf_counter()
    ok = g16.verify(proof, pub)
    t_verify = time.perf_counter() - t0
    ok_mma = g16.verify(proof_mma, pub)
    if not (ok and ok_mma):
        raise AssertionError("the BLS12-381 main-path proofs do not verify")
    _require_launches(ctx, "Groth16 BLS12-381 warm prove", launches, K_DEFAULT, K_FLAG_ONLY)
    _require_launches(ctx, "Groth16 BLS12-381 warm prove, ZKSNAKE_MXU_MONTMUL=1", launches_mma,
                      K_FLAG, ("bucket_accumulate",))
    ctx.paths["bls12_381_prove_warm"] = launches
    ctx.paths["bls12_381_prove_warm_mxu"] = launches_mma
    row.update(prove_warm_s=t_warm, prove_warm_mxu_s=t_mma, verify_s=t_verify,
               launches_warm=launches, launches_warm_mxu=launches_mma,
               prove_phases=phases_off, prove_phases_mxu=phases_on)
    ctx.detail["prove_bls12_381"] = row
    log(f"[11] warm prove {t_warm:.3f} s (launches {launches}); with ZKSNAKE_MXU_MONTMUL=1 "
        f"{t_mma:.3f} s (launches {launches_mma}); proofs byte-equal; verify "
        f"{t_verify:.3f} s: True, True")
    log("[11] prove phases " + json.dumps({k: v["seconds"] for k, v in phases_off.items()}))
    log("[11] prove phases, flag " + json.dumps({k: v["seconds"] for k, v in phases_on.items()}))


def phase_plonk(ctx):
    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.plonk import Plonk, protocol

    logn = PLONK_LOGN if not ctx.rehearse else 5
    # at toy sizes the thresholds are lowered so the same device paths run
    lowered = lowered_thresholds() if ctx.rehearse else contextlib.nullcontext()
    with lowered:
        t0 = time.perf_counter()
        plonkish, pub, priv = _plonk_chain(1 << logn, "BN254", 2)
        t_front = time.perf_counter() - t0
        if plonkish.length != 1 << logn:
            raise AssertionError(f"PlonK mult chain: {plonkish.length} gates, not 2^{logn}")
        plonk = Plonk(plonkish, "BN254", device=ctx.device)
        metrics.enable()
        metrics.reset()
        t0 = time.perf_counter()
        plonk.setup()
        ctx.sync()
        t_setup = time.perf_counter() - t0
        setup_phases = metrics.report()
        prove = lambda: plonk.prove(pub, priv)  # noqa: E731
        seed = "chip-smoke-plonk-blinds"
        _, t_cold, _ = _prove_counted(ctx, prove, protocol, seed)
        metrics.reset()
        proof, t_warm, launches = _prove_counted(ctx, prove, protocol, seed)
        phases_off = metrics.report()
        metrics.reset()
        with flag_env("1"), k3_widths() as widths:
            proof_mma, t_mma, launches_mma = _prove_counted(ctx, prove, protocol, seed)
        phases_on = metrics.report()
        metrics.enable(False)
        t0 = time.perf_counter()
        ok = plonk.verify(proof, pub)
        t_verify = time.perf_counter() - t0
        ok_mma = plonk.verify(proof_mma, pub)
    _check_k3_widths(ctx, "plonk_bn254", widths)
    if proof.to_bytes() != proof_mma.to_bytes():
        raise AssertionError("PlonK: the proof differs with ZKSNAKE_MXU_MONTMUL=1")
    if not (ok and ok_mma):
        raise AssertionError("the PlonK main-path proofs do not verify")
    _require_launches(ctx, "PlonK BN254 warm prove", launches, K_DEFAULT, K_FLAG_ONLY)
    _require_launches(ctx, "PlonK BN254 warm prove, ZKSNAKE_MXU_MONTMUL=1", launches_mma,
                      K_FLAG, ("bucket_accumulate",))
    ctx.paths["plonk_prove_warm"] = launches
    ctx.paths["plonk_prove_warm_mxu"] = launches_mma
    secs = lambda ph: {k: v["seconds"] for k, v in ph.items()}  # noqa: E731
    ctx.detail["plonk_bn254"] = {
        "gates": 1 << logn, "frontend_s": t_front, "setup_s": t_setup, "prove_cold_s": t_cold,
        "prove_warm_s": t_warm, "prove_warm_mxu_s": t_mma, "verify_s": t_verify,
        "launches_warm": launches, "launches_warm_mxu": launches_mma,
        "setup_phases": setup_phases, "prove_phases": phases_off, "prove_phases_mxu": phases_on,
    }
    log(f"[12] PlonK BN254 2^{logn} gates: frontend {t_front:.3f} s, setup {t_setup:.3f} s, "
        f"prove cold {t_cold:.3f} s, warm {t_warm:.3f} s (launches {launches}); with "
        f"ZKSNAKE_MXU_MONTMUL=1 {t_mma:.3f} s (launches {launches_mma}); proofs byte-equal; "
        f"verify {t_verify:.3f} s: True, True")
    log("[12] setup phases " + json.dumps(secs(setup_phases)))
    log("[12] prove phases " + json.dumps(secs(phases_off)))
    log("[12] prove phases, flag " + json.dumps(secs(phases_on)))


def _library_calls(name, args):
    """[(expression, fn)]: single PyTorch calls that compute kernel `name`'s
    function on its inputs, the yardsticks of library_ms (timed here, used
    nowhere in the port)."""
    import torch

    if name in ("expand_rows", "expand_rows_pm"):
        src, starts, R = args
        rows = (starts.long()[:, None] + torch.arange(R, device=src.device)).reshape(-1)
        return [
            ("torch.index_select(src.unfold(0, R, 1).transpose(1, 2), 0, starts)",
             lambda: torch.index_select(src.unfold(0, R, 1).transpose(1, 2), 0, starts)),
            ("torch.index_select(src, 0, rows).view(B2, R, w), rows prebuilt",
             lambda: torch.index_select(src, 0, rows).view(-1, R, src.shape[1])),
        ]
    if name == "expand_cols":
        x, starts, R = args
        return [("torch.index_select(x.unfold(1, R, 1).transpose(0, 1), 0, starts)",
                 lambda: torch.index_select(x.unfold(1, R, 1).transpose(0, 1), 0, starts))]
    (x,) = args
    if name == "copy_tile":
        return [("x.clone()", lambda: x.clone())]
    return [("x.t().contiguous()", lambda: x.t().contiguous())]


def _relayout_bound(name, args, out):
    """Bytes this run's data needs: the source words the windows touch (an
    expansion reads each once however often windows overlap), the starts,
    and the output; S6 adds its tensor-core MACs (4 byte planes x 16 a
    word, 2 operations each)."""
    import numpy as np

    if name in ("expand_rows", "expand_rows_pm", "expand_cols"):
        src, starts, R = args
        st = np.sort(starts.cpu().numpy().astype(np.int64))
        touched = int(np.minimum(np.diff(st), R).sum()) + R if st.size else 0
        per = src.shape[1] if name != "expand_cols" else src.shape[0]  # words a row / column
        return bound(4 * (touched * per + starts.numel() + out.numel()), [])
    (x,) = args
    ops = [(128 * x.numel(), INT8_TC_OPS_S)] if name == "transpose_mma" else []
    return bound(4 * (x.numel() + out.numel()), ops)


def phase_relayout(ctx):
    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.scripts import bench_sortdma as bs

    torch = ctx.torch
    logn = RELAYOUT_LOGN if not ctx.rehearse else 10
    sizes = {"b2": 48, "r_dma": 17, "r": 19} if ctx.rehearse else None
    n = 1 << logn
    kernels.reset_launches()
    stages = bs.run_stages(bs.STAGES, n, ctx.device, sizes, echo=False)
    ctx.sync()
    launches = dict(kernels.LAUNCHES)
    names = [k for k, _ in bs.KERNELS.values()]
    _require_launches(ctx, "bench_sortdma", launches, names)
    ctx.paths["bench_sortdma"] = launches
    for r in stages:
        log(f"[13] bench_sortdma 2^{logn} " + json.dumps(r))
    rows = {}
    for stage, (name, plain) in bs.KERNELS.items():
        st = bs.make(stage, n, ctx.device, sizes)
        got = st.run(*st.args)
        want = plain(*st.args)
        ctx.sync()
        if got.shape != want.shape:
            raise AssertionError(f"{name} ({stage}): shape {tuple(got.shape)} != plain's")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        if err != 0:
            raise AssertionError(f"{name} ({stage}): kernel != plain (max |err| {err})")
        plain_ms = ctx.time_ms(lambda: plain(*st.args), 3)
        calls = _library_calls(name, st.args)
        for expr, fn in calls:
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: the library call {expr} computes another function")
        # the fastest library call, then the kernel and it in turns, in one
        # call: kernel, library, library, kernel
        libs = {expr: ctx.time_ms(fn, 20) for expr, fn in calls}
        lib = min(libs, key=libs.get)
        run = lambda: st.run(*st.args)  # noqa: E731
        turns = [ctx.time_ms(f, 20) for f in (run, dict(calls)[lib], dict(calls)[lib], run)]
        ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        bms, bby = _relayout_bound(name, st.args, got)
        rows[name] = {"stage": stage, "shape_in": [list(a.shape) for a in st.args if hasattr(a, "shape")],
                      "shape_out": list(got.shape), "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                      "library_ms": lib_ms, "library": lib, "library_all": libs,
                      "turns_ms": turns}
        log(f"[13] {name} ({stage}) {rows[name]['shape_in']} -> {list(got.shape)}: bit-identical "
            f"to plain; kernel {ms:.4f} ms, library {lib_ms:.4f} ms ({lib}) in turns ("
            + " ".join(f"{t:.4f}" for t in turns) + f"), plain {plain_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({bby})")
        del st, got, want
    ctx.detail["relayout"] = {"stages": stages, "kernels": rows}
    ctx.kernels.update(rows)


def _g2_block_bound(variant, lanes):
    """S9's bound: its CIOS products (39 a lane for the add, 13 Karatsuba
    Fq2 products; 3 an Fq2 product, k a lane for a k-stack)
    against reading its input planes and writing its output planes once."""
    from zksnake_tpu_torch.backend import kernels

    _, k, n_in, n_out = kernels.G2_BLOCK_VARIANTS[variant]
    prods = {"addaff": 39, "addaff1": 39, "fq2mul": 3, "fq2mul1": 3, "select": 0}.get(variant, k)
    return bound(4 * 16 * lanes * (n_in + n_out), [(prods * lanes * cios_imads(8), IMAD_OPS_S)])


def _same(torch, got, want):
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def phase_g2_block(ctx):
    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.scripts import debug_g2_block as dg

    torch = ctx.torch
    lanes = G2_BLOCK_LANES if not ctx.rehearse else 64
    variants = list(kernels.G2_BLOCK_VARIANTS)
    kernels.reset_launches()
    runs = [dg.run(v, ctx.device, lanes) for v in variants]  # each checks kernel == plain
    ctx.sync()
    launches = dict(kernels.LAUNCHES)
    _require_launches(ctx, "debug_g2_block", launches, ("g2_block",))
    if ctx.device.type == "cuda" and launches["g2_block"] != len(variants):
        raise AssertionError(f"debug_g2_block: {launches['g2_block']} S9 launches for "
                             f"{len(variants)} variants")
    ctx.paths["debug_g2_block"] = launches
    # the least a one-launch probe can take here: one tiny PyTorch launch
    tiny = torch.zeros(1, device=ctx.device)
    floor_ms = ctx.graph_ms(lambda: tiny.add_(1), 200)
    regs = {k: (r, sp) for k, r, sp in ctx.detail.get("ptxas", {}).get("g2_block", [])}
    log(f"[14] launch floor {floor_ms:.4f} ms (graph replay of one 1-element add_); "
        f"S9's registers, spills: {regs}")
    rows = []
    for v, r in zip(variants, runs):
        ins = dg.inputs(v, lanes, ctx.device)
        got = kernels.g2_block(v, ins)
        want = kernels.g2_block_plain(v, ins)
        ctx.sync()
        if not _same(torch, got, want):
            raise AssertionError(f"g2_block {v}: kernel != plain")
        # one launch is shorter than the wrapper's host work, so the
        # kernel's own time comes from a replayed graph of launches; the
        # eager call's time beside it
        ms = ctx.graph_ms(lambda: kernels.g2_block(v, ins), 50)
        call_ms = ctx.time_ms(lambda: kernels.g2_block(v, ins), 50)
        plain_ms = ctx.time_ms(lambda: kernels.g2_block_plain(v, ins), 3)
        bms, bby = _g2_block_bound(v, lanes)
        rows.append({"variant": v, "lanes": lanes, "max_abs_err": 0, "ms": ms,
                     "call_ms": call_ms, "script_s": r["s"], "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": bby, "floor_ms": floor_ms})
        log(f"[14] g2_block {v} ({lanes} lanes): bit-identical to plain; kernel {ms:.4f} ms "
            f"(graph replay; eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {bms:.6f} ms ({bby}), floor {floor_ms:.4f} ms")
    ctx.detail["g2_block"] = rows
    # the add at G2_ADD_WIDTHS: checked against the plain version once and
    # timed beside its bound
    widths = []
    for n in G2_ADD_WIDTHS if not ctx.rehearse else (64, 100):
        ins = dg.inputs("addaff", n, ctx.device)
        want = kernels.g2_block_plain("addaff", ins)
        if not _same(torch, kernels.g2_block("addaff", ins), want):
            raise AssertionError(f"g2_block addaff at {n} lanes: kernel != plain")
        ms = ctx.graph_ms(lambda: kernels.g2_block("addaff", ins), 20)
        call_ms = ctx.time_ms(lambda: kernels.g2_block("addaff", ins), 20)
        bms, bby = _g2_block_bound("addaff", n)
        widths.append({"lanes": n, "ms": ms, "call_ms": call_ms, "bound_ms": bms,
                       "bound_by": bby, "pct_of_bound": 100 * bms / ms})
        log(f"[14] g2_block addaff ({n} lanes): bit-identical to plain; kernel {ms:.4f} ms "
            f"(graph replay; eager call {call_ms:.4f} ms), bound {bms:.6f} ms ({bby}, "
            f"{100 * bms / ms:.2f}%)")
    ctx.detail["g2_add_widths"] = widths
    # real G2 points (the identity, P = Q, P = -Q, Z1 != 1): the kernel
    # equals the plain version and the sums are the host's
    planes, sums = dg.point_inputs(lanes, ctx.device)
    got = kernels.g2_block("addaff", planes)
    if not _same(torch, got, kernels.g2_block_plain("addaff", planes)):
        raise AssertionError("g2_block addaff on G2 points: kernel != plain")
    if [p.to_bytes() for p in dg.points_of(got)] != [p.to_bytes() for p in sums]:
        raise AssertionError("g2_block addaff on G2 points: wrong sums")
    log(f"[14] g2_block addaff on {lanes} BN254 G2 point pairs: bit-identical to plain, "
        "every sum the host's")
    # the kernels line carries the add (the probe's first variant); every
    # variant is on the details line
    ctx.kernels["g2_block"] = dict(rows[0], library_ms=None,
                                   library="none: no PyTorch call computes a G2 point add")


def phase_sumcheck(ctx):
    from zksnake_tpu_torch.backend import config, mle
    from zksnake_tpu_torch.polynomial import MultilinearPolynomial
    from zksnake_tpu_torch.subprotocol.sumcheck import Sumcheck

    host = 1 << 62
    for curve, logn in SUMCHECK_LOGN.items():
        if ctx.rehearse:
            logn = 12  # MLE_DEVICE_THRESHOLD
        p = _scalar_field(curve)
        rng = random.Random(f"sumcheck-{curve}")
        t0 = time.perf_counter()
        vals = [rng.randrange(p) for _ in range(1 << logn)]
        poly = MultilinearPolynomial(logn, enumerate(vals), p, device=ctx.device)
        t_build = time.perf_counter() - t0
        sc = Sumcheck(logn, p, device=ctx.device)
        _, t_cold, _ = _counted(ctx, lambda: sc.prove(poly))
        rounds = mle.SUMCHECK_DEVICE_ROUNDS
        (claim, proof, chal), t_warm, launches = _counted(ctx, lambda: sc.prove(poly))
        rounds = mle.SUMCHECK_DEVICE_ROUNDS - rounds
        if rounds < logn:
            raise AssertionError(f"sumcheck {curve} 2^{logn}: {rounds} device rounds, not {logn}")
        _require_launches(ctx, f"sumcheck {curve} 2^{logn}", launches, ("mont_mul",),
                          ("bucket_accumulate",))
        if claim != sum(vals) % p:
            raise AssertionError(f"sumcheck {curve} 2^{logn}: the claim is not the table's sum")
        ok, t_verify, launches_verify = _counted(
            ctx, lambda: sc.verify(claim, proof, 3, mlpoly=poly))
        if ok != chal:
            raise AssertionError(f"sumcheck {curve} 2^{logn} does not verify")
        final = proof[-1](chal[-1])
        dev_eval, t_eval, _ = _counted(ctx, lambda: poly.evaluate(chal))
        with patched(config, MLE_DEVICE_THRESHOLD=host):
            host_eval, t_host_eval, _ = _counted(ctx, lambda: poly.evaluate(chal))
        if not dev_eval == host_eval == final:
            raise AssertionError(f"sumcheck {curve}: the final evaluation is not the host walk's")
        k = SUMCHECK_PARTIAL_VARS
        dev_pe, t_pe, launches_pe = _counted(ctx, lambda: poly.partial_evaluate(chal[:k]))
        with patched(config, MLE_DEVICE_THRESHOLD=host):
            host_pe, t_host_pe, _ = _counted(ctx, lambda: poly.partial_evaluate(chal[:k]))
        if (dev_pe.num_vars, dev_pe.evals) != (host_pe.num_vars, host_pe.evals):
            raise AssertionError(f"sumcheck {curve}: partial_evaluate of {k} variables "
                                 f"differs from the host walk")
        _require_launches(ctx, f"partial_evaluate {curve}", launches_pe, ("mont_mul",))
        # the round polynomials and challenges against the host path, on a
        # table the host path can walk in the call's time
        small = SUMCHECK_HOST_LOGN if not ctx.rehearse else 12
        sp = MultilinearPolynomial(small, enumerate(vals[: 1 << small]), p, device=ctx.device)
        ssc = Sumcheck(small, p, device=ctx.device)
        dev_small = ssc.prove(sp)
        with patched(config, MLE_DEVICE_THRESHOLD=host):
            host_small, t_host_small, _ = _counted(ctx, lambda: ssc.prove(sp))
        same = (dev_small[0], dev_small[2], [u.coeffs() for u in dev_small[1]]) == \
            (host_small[0], host_small[2], [u.coeffs() for u in host_small[1]])
        if not same:
            raise AssertionError(f"sumcheck {curve} 2^{small}: the device rounds differ "
                                 f"from the host path's")
        tag = f"sumcheck_{curve.lower()}"
        ctx.paths[tag] = launches
        ctx.paths[f"mle_partial_{curve.lower()}"] = launches_pe
        ctx.detail[tag] = {
            "log2_size": logn, "build_s": t_build, "prove_cold_s": t_cold, "prove_warm_s": t_warm,
            "device_rounds": rounds, "launches": launches, "verify_s": t_verify,
            "launches_verify": launches_verify, "evaluate_s": t_eval,
            "host_evaluate_s": t_host_eval, "partial_evaluate_s": t_pe,
            "host_partial_evaluate_s": t_host_pe, "launches_partial": launches_pe,
            "host_prove_s_small": t_host_small, "log2_small": small,
        }
        log(f"[15] sumcheck {curve} 2^{logn}: claim = the table's sum, verifies, final "
            f"evaluation and {k}-variable partial evaluation = the host walk's; rounds at "
            f"2^{small} = the host path's; build {t_build:.3f} s, prove cold {t_cold:.3f} s, "
            f"warm {t_warm:.3f} s ({rounds} device rounds, launches {_nz(launches)}), verify "
            f"{t_verify:.3f} s; evaluate {t_eval:.3f} s (host {t_host_eval:.3f} s), "
            f"partial {t_pe:.3f} s (host {t_host_pe:.3f} s); host prove at 2^{small} "
            f"{t_host_small:.3f} s")


def _multi_query(scheme, polys, x, y, blinds=None):
    """tests/test_commitment.py's query: polys[0] opened at x, the others
    at x and y; commitments made here (blinded where blinds are given)."""
    from zksnake_tpu_torch.commitment.polynomial import MultiOpeningQuery

    query = MultiOpeningQuery()
    for i, poly in enumerate(polys):
        if blinds is None:
            query.add_polynomial(poly, scheme.commit(poly))
        else:
            query.add_polynomial(poly, scheme.commit(poly, blinds[i]), blinds[i])
    for i, point in ((0, x), (1, x), (1, y), (2, x), (2, y)):
        query.prover_query(polys[i], point)
    return query


def _srs_split(ctx, kzg, tau):
    """Where KZG's host-bound time goes: the setup's fixed-base batch mul on
    the card and its conversion of the 2^n points back to the host (the
    setup's work again, timed apart and checked against its SRS), then the
    SRS's conversion to device limbs, first with its batched affine
    normalization and then with the affine form cached on the points (as
    every commit and open after the first finds it)."""
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import batch_mul_fixed_base_raw, scalars_to_device

    gs = get_group_spec(kzg.E.curve._curve, 1)
    order = kzg.order
    powers = [1]
    for _ in range(len(kzg.G1_tau) - 1):
        powers.append(powers[-1] * tau % order)
    slimbs = scalars_to_device(powers, order, ctx.device)
    raw, t_batch_mul, _ = _counted(ctx, lambda: batch_mul_fixed_base_raw(gs, kzg.E.G1(), slimbs))
    t0 = time.perf_counter()
    pts = gs.points_from_device(raw, kzg.E.curve.PointG1)
    t_to_host = time.perf_counter() - t0
    if [pts[0], pts[-1]] != [kzg.G1_tau[0], kzg.G1_tau[-1]]:
        raise AssertionError("KZG: the setup's batch mul, run again, gives another SRS")
    _, t_upload_cold, _ = _counted(ctx, lambda: gs.points_to_device(pts, ctx.device))
    _, t_upload_warm, _ = _counted(ctx, lambda: gs.points_to_device(pts, ctx.device))
    return {"setup_batch_mul_s": t_batch_mul, "setup_to_host_s": t_to_host,
            "srs_to_device_cold_s": t_upload_cold, "srs_to_device_warm_s": t_upload_warm}


def phase_kzg(ctx):
    from zksnake_tpu_torch.commitment.polynomial import KZG, kzg as kzg_mod
    from zksnake_tpu_torch.polynomial import Polynomial

    for curve, logn in KZG_LOGN.items():
        if ctx.rehearse:
            logn = 8  # MSM_DEVICE_THRESHOLD
        n = 1 << logn
        kzg = KZG(n - 1, curve, device=ctx.device)
        drawn = []
        with det_random(kzg_mod, f"kzg-{curve}", drawn):
            _, t_setup, launches_setup = _counted(ctx, kzg.setup)
        tau = drawn[0]
        rng = random.Random(f"kzg-poly-{curve}")
        polys = [Polynomial([rng.randrange(kzg.order) for _ in range(n)], kzg.order)
                 for _ in range(3)]
        commitment, t_commit, launches_commit = _counted(ctx, lambda: kzg.commit(polys[0]))
        if commitment != kzg.E.G1() * polys[0](tau):
            raise AssertionError(f"KZG {curve} 2^{logn}: commit(f) != G1 * f(tau)")
        z = rng.randrange(kzg.order)
        (proof, y), t_open, launches_open = _counted(ctx, lambda: kzg.open(polys[0], z))
        if y != polys[0](z):
            raise AssertionError(f"KZG {curve}: the opening's evaluation is wrong")
        ok, t_verify, _ = _counted(ctx, lambda: kzg.verify(commitment, proof, z, y))
        if not ok or kzg.verify(commitment, proof, z, (y + 1) % kzg.order):
            raise AssertionError(f"KZG {curve} 2^{logn}: verify accepts the wrong opening "
                                 f"or rejects the right one")
        for path, lc in (("commit", launches_commit), ("open", launches_open)):
            _require_launches(ctx, f"KZG {curve} {path}", lc, K_MSM)
        x1, x2 = rng.randrange(kzg.order), rng.randrange(kzg.order)
        t0 = time.perf_counter()
        query = _multi_query(kzg, polys, x1, x2)
        t_commit3 = time.perf_counter() - t0
        (mproof, vquery), t_mopen, launches_mopen = _counted(ctx, lambda: kzg.multi_open(query))
        mok, t_mverify, _ = _counted(ctx, lambda: kzg.multi_verify(vquery, mproof))
        bad = list(mproof)
        bad[1] = (bad[1] + 1) % kzg.order
        if not mok or kzg.multi_verify(vquery, bad):
            raise AssertionError(f"KZG {curve} 2^{logn}: multi_verify accepts a tampered "
                                 f"proof or rejects the right one")
        _require_launches(ctx, f"KZG {curve} multi_open", launches_mopen, K_MSM)
        tag = f"kzg_{curve.lower()}"
        for path, lc in (("setup", launches_setup), ("commit", launches_commit),
                         ("open", launches_open), ("multi_open", launches_mopen)):
            ctx.paths[f"{tag}_{path}"] = lc
        split = _srs_split(ctx, kzg, tau)
        ctx.detail[tag] = {
            **split,
            "coefficients": n, "setup_s": t_setup, "commit_s": t_commit, "open_s": t_open,
            "verify_s": t_verify, "commit3_s": t_commit3, "multi_open_s": t_mopen,
            "multi_verify_s": t_mverify, "launches_setup": launches_setup,
            "launches_commit": launches_commit, "launches_open": launches_open,
            "launches_multi_open": launches_mopen,
        }
        log(f"[16] KZG {curve} 2^{logn} coefficients: commit = G1 * f(tau), the opening "
            f"verifies and a tampered one does not, multi-open of 3 polynomials at 2 points "
            f"verifies and a tampered one does not; setup {t_setup:.3f} s, commit "
            f"{t_commit:.3f} s (launches {_nz(launches_commit)}), open {t_open:.3f} s (launches "
            f"{_nz(launches_open)}), verify {t_verify:.3f} s, 3 commits {t_commit3:.3f} s, "
            f"multi_open {t_mopen:.3f} s (launches {_nz(launches_mopen)}), multi_verify "
            f"{t_mverify:.3f} s")
        log(f"[16] KZG {curve} 2^{logn} host conversions: the setup's batch mul "
            f"{split['setup_batch_mul_s']:.3f} s on the device, its points to the host "
            f"{split['setup_to_host_s']:.3f} s; the SRS to device limbs "
            f"{split['srs_to_device_cold_s']:.3f} s with its affine normalization, "
            f"{split['srs_to_device_warm_s']:.3f} s with it cached")


def _gkr_circuits():
    """tests/test_gkr.py's three circuits and a GKR_WIDE layered circuit
    (gate k reads wire k of the layer below and a random wire at or before
    it), as (name, inputs, layers of (gate, lhs, rhs, out))."""
    circuits = [
        ("add_mul", ["x", "y"], [[("ADD", "x", "y", "z")], [("MUL", "z", "z", "zz")]]),
        ("three_layers", ["x", "y", "u", "v"], [
            [("ADD", "x", "y", "z1"), ("MUL", "x", "y", "z2"), ("MUL", "x", "y", "z3"),
             ("MUL", "u", "v", "w"), ("ADD", "x", "x", "xx")],
            [("MUL", "z1", "z2", "zz"), ("MUL", "z1", "z3", "zzz"), ("MUL", "w", "w", "ww"),
             ("ADD", "xx", "xx", "xxx")],
            [("ADD", "zzz", "zz", "a"), ("MUL", "zzz", "ww", "b"),
             ("MUL", "xxx", "xxx", "xxxx")]]),
        ("squares", ["a1", "a2", "a3", "a4"], [
            [("MUL", "a1", "a1", "b1"), ("MUL", "a2", "a2", "b2"), ("MUL", "a2", "a3", "b3"),
             ("MUL", "a4", "a4", "b4")],
            [("MUL", "b1", "b2", "c1"), ("MUL", "b3", "b4", "c2")]]),
    ]
    width, depth = GKR_WIDE
    rng = random.Random("gkr-wide")
    inputs = [f"i{k}" for k in range(width)]
    layers, below = [], inputs
    for d in range(depth):
        outs = [f"w{d}_{k}" for k in range(width)]
        layers.append([(rng.choice(["ADD", "MUL"]), below[k], below[rng.randrange(k + 1)], o)
                       for k, o in enumerate(outs)])
        below = outs
    return circuits + [(f"wide_{width}x{depth}", inputs, layers)]


def phase_commitments(ctx):
    from zksnake_tpu_torch.arithmetization import LayeredCircuit
    from zksnake_tpu_torch.commitment.polynomial import IPA, ipa as ipa_mod
    from zksnake_tpu_torch.commitment.vector import Merkle
    from zksnake_tpu_torch.curves.point import get_g1_class
    from zksnake_tpu_torch.polynomial import Polynomial
    from zksnake_tpu_torch.subprotocol.bulletproofs import (InnerProductArgument,
                                                           InnerProductProof, RangeProof,
                                                           range_proof)
    from zksnake_tpu_torch.subprotocol.gkr import GKR

    row = {}
    # IPA-PCS over BN254
    logn = IPA_LOGN if not ctx.rehearse else 8
    n = 1 << logn
    ipa = IPA(n, "BN254", device=ctx.device)
    _, t_basis, _ = _counted(ctx, ipa.setup)
    rng = random.Random("ipa-pcs")
    polys = [Polynomial([rng.randrange(ipa.order) for _ in range(n)], ipa.order)
             for _ in range(3)]
    blinds = [rng.randrange(1, ipa.order) for _ in polys]
    commitment, t_commit, launches_commit = _counted(ctx, lambda: ipa.commit(polys[0], blinds[0]))
    z = rng.randrange(ipa.order)
    with det_random(ipa_mod, "ipa-open"):
        (proof, y), t_open, launches_open = _counted(
            ctx, lambda: ipa.open(polys[0], z, commitment, blinds[0]))
    ok, t_verify, launches_verify = _counted(ctx, lambda: ipa.verify(commitment, proof, z, y))
    if not ok or y != polys[0](z) or ipa.verify(commitment, proof, z, (y + 1) % ipa.order):
        raise AssertionError(f"IPA-PCS 2^{logn}: verify accepts the wrong opening or "
                             f"rejects the right one")
    for path, lc in (("commit", launches_commit), ("open", launches_open)):
        _require_launches(ctx, f"IPA-PCS {path}", lc, K_MSM)
    # the basis fold of open's first round: 2^(logn-1) host scalar muls
    u = rng.randrange(ipa.order)
    half = n // 2
    t0 = time.perf_counter()
    folded = [lo + u * hi for lo, hi in zip(ipa.G[:half], ipa.G[half:])]
    t_fold1 = time.perf_counter() - t0
    if folded[0] != ipa.G[0] + ipa.G[half] * u:
        raise AssertionError("IPA basis fold")
    with det_random(ipa_mod, "ipa-multi"):
        x1, x2 = rng.randrange(ipa.order), rng.randrange(ipa.order)
        query = _multi_query(ipa, polys, x1, x2, blinds)
        (mproof, vquery), t_mopen, launches_mopen = _counted(ctx, lambda: ipa.multi_open(query))
    mok, t_mverify, _ = _counted(ctx, lambda: ipa.multi_verify(vquery, mproof))
    bad = list(mproof)
    bad[1] = (bad[1] + 1) % ipa.order
    if not mok or ipa.multi_verify(vquery, bad):
        raise AssertionError("IPA-PCS multi_verify accepts a tampered proof or rejects the "
                             "right one")
    ctx.paths["ipa_pcs_commit"] = launches_commit
    ctx.paths["ipa_pcs_open"] = launches_open
    ctx.paths["ipa_pcs_multi_open"] = launches_mopen
    row["ipa_pcs"] = {"n": n, "basis_s": t_basis, "commit_s": t_commit, "open_s": t_open,
                      "verify_s": t_verify, "fold_round1_s": t_fold1, "multi_open_s": t_mopen,
                      "multi_verify_s": t_mverify, "launches_commit": launches_commit,
                      "launches_open": launches_open, "launches_verify": launches_verify,
                      "launches_multi_open": launches_mopen}
    log(f"[17] IPA-PCS BN254 n = 2^{logn}: the opening and the multi-opening verify, tampered "
        f"ones do not; hash-to-curve basis {t_basis:.3f} s, commit {t_commit:.3f} s (launches "
        f"{_nz(launches_commit)}), open {t_open:.3f} s (launches {_nz(launches_open)}; its "
        f"first basis fold round {t_fold1:.3f} s on the host), verify {t_verify:.3f} s, multi_open "
        f"{t_mopen:.3f} s, multi_verify {t_mverify:.3f} s")
    # Bulletproofs: 64-bit range proofs and the 64-element inner-product argument
    for curve in K2_CURVES:
        bits = RANGE_BITS if not ctx.rehearse else 8
        rp, t_gen, _ = _counted(ctx, lambda: RangeProof(bits, curve, device=ctx.device))
        v = random.Random(curve).randrange(1 << bits)
        with det_random(range_proof, f"rp-{curve}"):
            proof, t_prove, launches_rp = _counted(ctx, lambda: rp.prove(v))
            raw = proof.to_bytes()
            back = range_proof.RangeProofObject.from_bytes(raw, curve)
            ok, t_rverify, _ = _counted(ctx, lambda: rp.verify(back))
            over = rp.prove(v + (1 << bits))  # out of range
            rejects = not rp.verify(over)
        if not ok or back.to_bytes() != raw or not rejects:
            raise AssertionError(f"range proof {curve} {bits} bits")
        a = [random.Random(i).randrange(rp.E.order) for i in range(bits)]
        b = [random.Random(-i).randrange(rp.E.order) for i in range(bits)]
        arg = InnerProductArgument(bits, curve, device=ctx.device)
        (iproof, comm, ab), t_iprove, _ = _counted(ctx, lambda: arg.prove(a, b))
        iback = InnerProductProof.from_bytes(iproof.to_bytes(), curve)
        if not arg.verify(iback, comm, ab) or arg.verify(iback, comm, ab + 1) or \
                iback.to_bytes() != iproof.to_bytes():
            raise AssertionError(f"inner-product argument {curve} {bits}")
        row[f"bulletproofs_{curve.lower()}"] = {
            "bits": bits, "generators_s": t_gen, "range_prove_s": t_prove,
            "range_verify_s": t_rverify, "proof_bytes": len(raw), "ipa_prove_s": t_iprove,
            "launches_range_prove": launches_rp}
        log(f"[17] Bulletproofs {curve}: {bits}-bit range proof ({len(raw)} bytes) verifies "
            f"after a bytes round trip, an out-of-range one does not; the {bits}-element "
            f"inner-product argument verifies; generators {t_gen:.3f} s, range prove "
            f"{t_prove:.3f} s, verify {t_rverify:.3f} s, inner-product prove {t_iprove:.3f} s")
    # GKR on both curves
    for curve in K2_CURVES:
        p = _scalar_field(curve)
        for name, inputs, layers in _gkr_circuits():
            circuit = LayeredCircuit(list(inputs))
            for i, layer in enumerate(layers):
                if i:
                    circuit.add_layer()
                for gate in layer:
                    circuit.add_gate(*gate)
            gkr = GKR(circuit, p, device=ctx.device)
            grng = random.Random(f"gkr-{curve}-{name}")
            inp = {k: grng.randrange(1, p - 1) for k in inputs}
            (out, gproof), t_gprove, _ = _counted(ctx, lambda: gkr.prove(dict(inp)))
            wrong = dict(out)
            key = next(iter(wrong))
            wrong[key] = (wrong[key] + 1) % p
            if not gkr.verify(inp, out, gproof) or gkr.verify(inp, wrong, gproof):
                raise AssertionError(f"GKR {curve} {name}")
            row[f"gkr_{curve.lower()}_{name}"] = {"prove_s": t_gprove}
        log(f"[17] GKR {curve}: the circuits of tests/test_gkr.py and a {GKR_WIDE[0]}-gate, "
            f"{GKR_WIDE[1]}-layer circuit prove and verify, a wrong output is rejected; the "
            f"wide one proves in {row[f'gkr_{curve.lower()}_{name}']['prove_s']:.3f} s")
    # Merkle
    leaves = [i.to_bytes(32, "little") for i in range(MERKLE_LEAVES)]
    m = Merkle()
    root, t_merkle, _ = _counted(ctx, lambda: m.commit(leaves))
    for idx in (0, 1, MERKLE_LEAVES // 2, MERKLE_LEAVES - 1):
        path = m.open(leaves, idx)
        if not m.verify(root, path, idx, leaves[idx]) or m.verify(root, path, idx, b"x"):
            raise AssertionError("Merkle")
    row["merkle"] = {"leaves": MERKLE_LEAVES, "commit_s": t_merkle}
    # the RFC 9380 BLS12381G1_XMD:SHA-256_SSWU_RO_ vectors (tests/test_curves.py)
    cls = get_g1_class("BLS12_381")
    dst = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
    vectors = {
        b"": (0x052926ADD2207B76CA4FA57A8734416C8DC95E24501772C814278700EED6D1E4E8CF62D9C09DB0FAC349612B759E79A1,  # noqa: E501
              0x08BA738453BFED09CB546DBB0783DBB3A5F1F566ED67BB6BE0E8C67E2E81A4CC68EE29813BB7994998F3EAE0C9C6A265),  # noqa: E501
        b"abc": (0x03567BC5EF9C690C2AB2ECDF6A96EF1C139CC0B2F284DCA0A9A7943388A49A3AEE664BA5379A7655D3C68900BE2F6903,  # noqa: E501
                 0x0B9C15F3FE6E5CF4211F346271D7B01C8F3B28BE689C8429C85B67AF215533311F0B8DFAAA154FA6B88176C229F2885D),  # noqa: E501
    }
    for msg, xy in vectors.items():
        pt = cls.hash_to_curve(dst, msg)
        if (pt.x, pt.y) != xy or not pt.in_subgroup():
            raise AssertionError(f"RFC 9380 vector {msg!r}")
    ctx.detail["commitments"] = row
    log(f"[17] Merkle over {MERKLE_LEAVES} leaves: commit {t_merkle:.3f} s, paths verify; "
        f"RFC 9380 BLS12-381 G1 vectors: equal")


# phase 18: (a)'s four-step NTT; (b)'s ranks of one gloo group on the one
# card and its depths
SHARD_NTT_LOGN = 20
SHARD_RANKS = 4
SHARD_LOGN = {"msm": 16, "ntt": 16, "prove": 12}
SHARD_SMALL_CHAIN = 5  # n = 8: (b)'s prove on the replicated QAP
SHARD_REHEARSE_LOGN = {"msm": 8, "ntt": 8, "prove": 6}
SHARD_TIMEOUT_S = 600


def _shard_msm_check(ctx, group, group_id, logn, seed):
    """A sharded BN254 MSM of 2^logn points (i % 64 + 1) G of `group_id`
    from this rank's lanes, seeded scalars, against the host oracle
    G * sum(s_i (i % 64 + 1)). Returns (seconds and launches of a warm
    call)."""
    from zksnake_tpu_torch.backend import sharding
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import scalars_to_device
    from zksnake_tpu_torch.curves import get_curve_module

    cm = get_curve_module("BN254", ctx.device)
    curve = cm._curve
    gs = get_group_spec(curve, group_id)
    n = 1 << logn
    rng = random.Random(seed + group_id)
    P, _ = _tiled_points(gs, cm, n, ctx.device)
    scalars = [rng.randrange(curve.r) for _ in range(n)]
    s = scalars_to_device(scalars, curve.r, ctx.device)
    Pl, sl = sharding.shard_lanes(gs, P, s, group)
    sharding.sharded_msm(gs, Pl, sl, group)  # warm-up
    res, dt, launches = _counted(ctx, lambda: sharding.sharded_msm(gs, Pl, sl, group))
    total = sum(si * (i % 64 + 1) for i, si in enumerate(scalars)) % curve.r
    gen, cls = (cm.g1(), cm.PointG1) if group_id == 1 else (cm.g2(), cm.PointG2)
    if gs.points_from_device(gs.map(lambda t: t[:, None], res), cls)[0] != gen * total:
        raise AssertionError(f"sharded G{group_id} MSM 2^{logn} differs from the host oracle")
    return dt, _nz(launches)


def _shard_ntt_check(ctx, group, logn, seed):
    """The four-step NTT of 2^logn seeded BN254 Fr elements from this rank's
    rows, limb for limb against its part of the one-device ntt_device.
    Returns (ms of the four-step's plan.local, ms of ntt_device): CUDA
    events over 5 calls after a warm-up (host clock on the CPU)."""
    import numpy as np
    import torch.distributed as dist

    from zksnake_tpu_torch.backend import sharding
    from zksnake_tpu_torch.backend.ntt import Domain, ntt_device
    from zksnake_tpu_torch.curves.params import CURVES

    torch = ctx.torch
    dom = Domain.get(CURVES["BN254"], 1 << logn)
    fs = dom.fs
    n1 = 1 << (logn // 2)
    n2 = dom.n // n1
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    rows, c = n1 // D, n2 // D
    x = torch.from_numpy(_random_elems(fs, fs.nl, dom.n, np.random.default_rng(seed)))
    x = x.to(ctx.device)
    # j = i1 + n1 i2 at [i1, i2], this rank's rows i1
    xl = x.reshape(fs.nl, n2, n1).transpose(1, 2)[:, rank * rows:(rank + 1) * rows].contiguous()
    got = sharding.sharded_ntt(dom, xl, n1, group)  # (nl, n2/D, n1)
    # output k = k2 + n2 k1 at [k2, k1], this rank's k2
    want = ntt_device(dom, x).reshape(fs.nl, n1, n2)[:, :, rank * c:(rank + 1) * c]
    if not torch.equal(got, want.transpose(1, 2)):
        raise AssertionError(f"rank {rank}: the four-step NTT 2^{logn} differs from ntt_device")
    plan = sharding.FourStepPlan(fs, dom.r, n1, n2, dom.omega)
    tw = plan.tw_local(group, ctx.device)
    return (ctx.time_ms(lambda: plan.local(xl, tw, group), 5),
            ctx.time_ms(lambda: ntt_device(dom, x), 5))


def _shard_prove(ctx, r1cs, pub, priv, mesh, seed, sharded_qap=True):
    """Groth16(mesh=) setup (seeded waste, broadcast from rank 0) and a
    warm prove (seeded r, s) counted by _counted, on the sharded QAP (the
    replicated one where `sharded_qap` is false). Returns (g16, proof,
    seconds, launches, cold prove seconds)."""
    from zksnake_tpu_torch.groth16 import Groth16, protocol

    g16 = Groth16(r1cs, "BN254", device=ctx.device, mesh=mesh)
    with det_random(protocol, seed + "-setup"):
        g16.setup()
    _, t_cold, _ = _prove_counted(ctx, lambda: g16.prove(pub, priv), protocol, seed)
    proof, t_warm, launches = _prove_counted(ctx, lambda: g16.prove(pub, priv), protocol, seed)
    if (g16._device_prover._sqap[1] is not None) != sharded_qap:
        raise AssertionError(f"the prove at n = {g16._device_prover.n} did not take the "
                             f"{'sharded' if sharded_qap else 'replicated'} QAP")
    return g16, proof, t_warm, launches, t_cold


def _reprove(ctx, g16, r1cs, pub, priv, seed, mesh=None):
    """The proof of a new Groth16 (on `mesh`, or one device) under g16's
    keys and the seeded r, s."""
    from zksnake_tpu_torch.groth16 import Groth16, protocol

    other = Groth16(r1cs, "BN254", device=ctx.device, mesh=mesh)
    other.proving_key, other.verifying_key = g16.proving_key, g16.verifying_key
    return _prove_counted(ctx, lambda: other.prove(pub, priv), protocol, seed)


def _shard_rank(rank, tmp, rehearse):
    """One rank of phase 18(b): a gloo group of SHARD_RANKS ranks, every
    rank on cuda:0 (the CPU in a rehearsal); its checks' results go to
    rank<i>.json."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if rehearse:
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        torch.cuda.set_device(0)
    ctx = Ctx("cpu" if rehearse else "cuda", rehearse)
    logn = SHARD_REHEARSE_LOGN if rehearse else SHARD_LOGN
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=rank,
                            world_size=SHARD_RANKS)
    try:
        mesh = init_device_mesh(ctx.device.type, (SHARD_RANKS,), mesh_dim_names=("shards",))
        group = mesh.get_group("shards")
        out = {"msm": {}}
        for gid in (1, 2):
            out["msm"][f"G{gid}"] = _shard_msm_check(ctx, group, gid, logn["msm"], 0x5A4D)
        out["ntt_ms"] = _shard_ntt_check(ctx, group, logn["ntt"], 18)
        r1cs, pub, priv = _mult_chain(1 << logn["prove"], "BN254", 2)
        seed = "phase18b"
        g16, proof, t_warm, launches, _ = _shard_prove(ctx, r1cs, pub, priv, mesh, seed)
        out.update(prove_s=t_warm, launches=launches, proof=proof.to_bytes().hex())
        # n = 8 = 2 x 4: the mesh does not divide the split, so the QAP runs
        # replicated and the MSMs sharded
        small = _mult_chain(SHARD_SMALL_CHAIN, "BN254", 2)
        g16_small, proof_small = _shard_prove(ctx, *small, mesh, seed + "-small", False)[:2]
        out["proof_replicated_qap"] = proof_small.to_bytes().hex()
        if rank == 0:
            out["verified"] = g16.verify(proof, pub)
        elif rank == 1:
            out["proof_one_device"] = _reprove(ctx, g16, r1cs, pub, priv, seed)[0].to_bytes().hex()
        elif rank == 2:
            out["verified_small"] = g16_small.verify(proof_small, small[1])
            out["proof_one_device_small"] = _reprove(
                ctx, g16_small, *small, seed + "-small")[0].to_bytes().hex()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _sharded_one_rank(ctx):
    """Phase 18(a): a one-rank NCCL mesh (gloo in a rehearsal) at full
    width. Returns the phase's row."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from zksnake_tpu_torch import metrics

    rehearse = ctx.rehearse
    logn = PROVE_LOGN if not rehearse else 6
    msm_logn = MSM_LOGN if not rehearse else 10
    ntt_logn = SHARD_NTT_LOGN if not rehearse else 10
    row = {"constraints": 1 << logn}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo" if rehearse else "nccl", init_method=f"file://{tmp}/rdzv",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh(ctx.device.type, (1,), mesh_dim_names=("shards",))
            group = mesh.get_group("shards")
            r1cs, pub, priv = _mult_chain(1 << logn, "BN254", 2)
            seed = "phase18a"
            metrics.enable()
            metrics.reset()
            t0 = time.perf_counter()
            g16, proof, t_warm, launches, t_cold = _shard_prove(ctx, r1cs, pub, priv, mesh, seed)
            row["setup_and_proves_s"] = time.perf_counter() - t0
            row["phases"] = {k: v["seconds"] for k, v in metrics.report().items()}
            metrics.enable(False)
            t0 = time.perf_counter()
            ok = g16.verify(proof, pub)
            row["verify_s"] = time.perf_counter() - t0
            one, t_one, launches_one = _reprove(ctx, g16, r1cs, pub, priv, seed)
            if not ok or proof.to_bytes() != one.to_bytes():
                raise AssertionError("the one-rank sharded proof does not verify or differs "
                                     "from the one-device proof")
            _require_launches(ctx, "sharded Groth16 BN254 warm prove", launches, K_DEFAULT,
                              K_FLAG_ONLY)
            ctx.paths["bn254_prove_warm_sharded1"] = launches
            row.update(prove_cold_s=t_cold, prove_warm_s=t_warm, launches_warm=_nz(launches),
                       one_device_prove_s=t_one, one_device_launches=_nz(launches_one))
            for gid in (1, 2):
                row[f"msm_g{gid}"] = _shard_msm_check(ctx, group, gid, msm_logn, 0xBEEF)
            row["ntt_ms"] = _shard_ntt_check(ctx, group, ntt_logn, 20)
        finally:
            dist.destroy_process_group()
    log(f"[18a] one-rank mesh: Groth16 BN254 2^{logn} setup and two proves "
        f"{row['setup_and_proves_s']:.3f} s, prove cold {t_cold:.3f} s, warm {t_warm:.3f} s "
        f"(launches {row['launches_warm']}); one-device prove under the same keys and r, s "
        f"(its first: the key moves to the card) {t_one:.3f} s (launches "
        f"{row['one_device_launches']}); byte-equal, verifies")
    log("[18a] phases " + json.dumps(row["phases"]))
    for gid in (1, 2):
        log(f"[18a] sharded G{gid} MSM 2^{msm_logn}: equals the host oracle; "
            f"{row[f'msm_g{gid}'][0]:.4f} s, launches {row[f'msm_g{gid}'][1]}")
    log(f"[18a] four-step NTT 2^{ntt_logn}: equals ntt_device limb for limb; "
        f"{row['ntt_ms'][0]:.3f} ms (ntt_device {row['ntt_ms'][1]:.3f} ms)")
    return row


def _sharded_four_ranks(ctx):
    """Phase 18(b): SHARD_RANKS spawned ranks of one gloo group on the card.
    Returns their rows; raises on any rank's failure or the timeout."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        spawned = mp.spawn(_shard_rank, args=(tmp, ctx.rehearse), nprocs=SHARD_RANKS,
                           join=False)
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        try:
            while not spawned.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"phase 18(b)'s ranks ran past {SHARD_TIMEOUT_S} s")
        finally:
            for proc in spawned.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(10)
        rows = []
        for rank in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                rows.append(json.load(f))
    want, want_small = rows[1]["proof_one_device"], rows[2]["proof_one_device_small"]
    if not rows[0]["verified"] or not rows[2]["verified_small"] or any(
            r["proof"] != want or r["proof_replicated_qap"] != want_small for r in rows):
        raise AssertionError("phase 18(b): the ranks' proofs differ from the one-device proof "
                             "or do not verify")
    for r in rows:
        _require_launches(ctx, "sharded Groth16 on 4 ranks", r["launches"], K_DEFAULT, K_FLAG_ONLY)
    return rows


def phase_sharded(ctx):
    row = _sharded_one_rank(ctx)
    t0 = time.perf_counter()
    rows = _sharded_four_ranks(ctx)
    row["four_ranks"] = {"seconds": time.perf_counter() - t0, "ranks": rows}
    ctx.detail["sharded"] = row
    lg = SHARD_REHEARSE_LOGN if ctx.rehearse else SHARD_LOGN
    for rank, r in enumerate(rows):
        log(f"[18b] rank {rank}/{SHARD_RANKS}: G1 / G2 MSM 2^{lg['msm']} "
            f"{r['msm']['G1'][0]:.4f} / {r['msm']['G2'][0]:.4f} s, four-step NTT 2^{lg['ntt']} "
            f"{r['ntt_ms'][0]:.3f} ms (one device {r['ntt_ms'][1]:.3f} ms), Groth16 "
            f"2^{lg['prove']} warm prove {r['prove_s']:.3f} s, launches {_nz(r['launches'])}")
    log(f"[18b] {SHARD_RANKS} gloo ranks on one device in {row['four_ranks']['seconds']:.3f} s: "
        f"MSMs equal the host oracle, NTTs equal ntt_device, every rank's proofs (sharded QAP "
        f"at 2^{lg['prove']}, replicated QAP at n = 8) equal the one-device proofs and verify")


def phase_k4(ctx):
    """K4 against its plain version, limb for limb, at the Groth16 prove's
    two reduction passes (c = 11, W = 24: G1 with M = 4, G2 with M = 1) on
    both curves, and at the fixed-base pass of an EIP-7594 request of 6
    blobs (BLS12-381 G1, c = fixed_base_window(4096, 256), W = 1, M = 774
    MSMs, S_top = 1, V_cap = B2: no top-window fold, and the one-block
    branch of the window kernel), on random canonical coordinates (the
    formulas are the same arithmetic whether or not they are points); timed
    beside two bounds: every product of the pass at K1's rate, and Horner's
    chain: its levels of independent products (a doubling or an add is two,
    three where 3b is no small integer), one after another, each one CIOS
    product's cios_imads multiply-adds at one warp's rate (2 clocks a warp
    instruction: 16 lanes a clock on one scheduler). The windows' and
    Horner's launches apart are the port's spans msm.reduce.window and
    .horner (each syncs at its edges)."""
    import numpy as np

    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import _next_pow2, fixed_base_window
    from zksnake_tpu_torch.curves import get_curve_module

    torch = ctx.torch
    nbits = 256
    rng = np.random.default_rng(0x4B4)
    # (pass, curve, group, c, M, W, fixed-base): W None is the scalar's
    # windows at c, with the top window spread as sort_by_digit spreads it
    passes = [("groth16", curve_name, group, 11 if not ctx.rehearse else 5,
               4 if group == 1 else 1, None if not ctx.rehearse else 3, False)
              for curve_name in K2_CURVES for group in (1, 2)]
    passes.append(("eip7594", "BLS12_381", 1,
                   fixed_base_window(4096, nbits) if not ctx.rehearse else 5,
                   6 * 129 if not ctx.rehearse else 6, 1, True))
    rows = []
    for pass_name, curve_name, group, c, M, W_, fixed in passes:
        gs = get_group_spec(get_curve_module(curve_name, ctx.device)._curve, group)
        fs, r = gs.fs, gs.curve.r
        L, B2 = 3 * group, 1 << (c - 1)
        if fixed:
            S_top, V_cap = 1, B2  # as msm_pippenger_many's fixed-base pass
        else:
            V_cap = _next_pow2(max((r >> (c * (-(-nbits // c) - 1))) + 2, 2))
            S_top = B2 // V_cap if V_cap < B2 else 1
            W_ = W_ or -(-nbits // c)
        limbs = _random_elems(fs, fs.nl, L * M * W_ * B2, rng).reshape(fs.nl, L, M, W_, B2)
        buckets = torch.from_numpy(limbs).permute(1, 0, 2, 3, 4).contiguous().to(ctx.device)
        run = lambda: kernels.bucket_reduce(gs, buckets, c, S_top, V_cap)  # noqa: E731
        got = run()
        t0 = time.perf_counter()
        want = kernels.bucket_reduce_plain(gs, buckets, c, S_top, V_cap)
        ctx.sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"K4 {pass_name} {curve_name} G{group} M={M}: kernel != "
                                 f"plain (max |err| {err})")
        ms = ctx.time_ms(run, 5)
        metrics.enable()
        metrics.reset()
        for _ in range(5):
            run()
        spans = metrics.report()
        metrics.enable(False)
        metrics.reset()
        split = {name: spans[f"msm.reduce.{name}"]["seconds"] / 5 * 1e3
                 if f"msm.reduce.{name}" in spans else float("nan")
                 for name in ("window", "horner")}
        # a level of n lanes is n adds: (c - 1) B2 a window, B2 - V_cap
        # in the top fold; Horner c W doublings and W adds an MSM
        small = gs.b3_small() != 0
        p_add, p_dbl, k = (12 if small else 14), (8 if small else 9), group * 2 - 1
        adds = M * (W_ * (c - 1) * B2 + (B2 - V_cap if S_top > 1 else 0))
        nw = fs.nl // 2
        prods = adds * p_add * k + M * W_ * (c * p_dbl + p_add) * k
        bms, bby = bound(4 * (buckets.numel() + got.numel()),
                         [(prods * cios_imads(nw), IMAD_OPS_S)])
        levels = W_ * (c + 1) * (2 if small else 3)
        chain_ms = levels * cios_imads(nw) * 2 / CLOCK_HZ * 1e3
        row = {"pass": pass_name, "curve": curve_name, "group": group, "msms": M, "c": c,
               "windows": W_, "buckets": B2, "S_top": S_top, "V_cap": V_cap, "adds": adds,
               "products": prods, "max_abs_err": err, "ms": ms,
               "window_ms": split["window"], "horner_ms": split["horner"],
               "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
               "horner_levels": levels, "horner_bound_ms": chain_ms}
        rows.append(row)
        log(f"[19] K4 bucket_reduce {pass_name} {curve_name} G{group} M={M} c={c} W={W_} "
            f"(S_top {S_top}): bit-identical to the plain version; kernel {ms:.3f} ms "
            f"(windows {row['window_ms']:.3f}, Horner {row['horner_ms']:.3f}), plain "
            f"{plain_ms:.1f} ms; bounds: products {bms:.4f} ms ({bby}), Horner's chain "
            f"of {levels} product levels {chain_ms:.4f} ms")
        del buckets, got, want
    ctx.detail["k4"] = rows
    ctx.kernels["bucket_reduce"] = rows[0]


PHASES = [phase_build, phase_k1, phase_k3, phase_k2, phase_k2m, phase_msm, phase_msm_mma,
          phase_msm_g2, phase_fixtures, phase_plonk_fixtures, phase_bn254, phase_bls12_381,
          phase_plonk, phase_relayout, phase_g2_block, phase_sumcheck, phase_kzg,
          phase_commitments, phase_sharded, phase_k4]

# the kernel libraries each phase launches: phase 0 builds those of the
# chosen phases, and K1's always (every wrapper reports a launch error with
# its error strings)
_K2_LIBS = ("bucket16", "bucket24")
_K2M_LIBS = ("bucket_mma16", "bucket_mma24")
_K4_LIBS = ("bucket_reduce16", "bucket_reduce24")
_PROVE_LIBS = ("montmul_mma",) + _K2_LIBS + _K2M_LIBS + _K4_LIBS
PHASE_LIBS = [(), (), ("montmul_mma",), _K2_LIBS, ("montmul_mma",) + _K2_LIBS + _K2M_LIBS,
              *[_PROVE_LIBS] * 8, ("relayout",), ("g2_block",), (), _K2_LIBS + _K4_LIBS,
              ("bucket16", "bucket_reduce16"), ("bucket16", "bucket_reduce16"), _K4_LIBS]

# kernel -> (source, the TPU kernel it replaces, the main-path run its
# launch count is read from)
RELAYOUT_CU = "zksnake_tpu_torch/csrc/relayout.cu"
SOURCES = {
    "mont_mul": ("zksnake_tpu_torch/csrc/montmul.cu", "zksnake_tpu/backend/pallas_field.py:43",
                 "bls12_381_prove_warm"),
    "bucket_accumulate": ("zksnake_tpu_torch/csrc/bucket.cu",
                          "zksnake_tpu/backend/pallas_field.py:244", "bls12_381_prove_warm"),
    "mont_mul_mma": ("zksnake_tpu_torch/csrc/montmul_mma.cu",
                     "zksnake_tpu/backend/pallas_field.py:24", "bls12_381_prove_warm_mxu"),
    "bucket_accumulate_mma": ("zksnake_tpu_torch/csrc/bucket_mma.cu",
                              "zksnake_tpu/backend/pallas_field.py:274", "plonk_prove_warm_mxu"),
    "expand_rows": (RELAYOUT_CU, "scripts/bench_sortdma.py:86", "bench_sortdma"),
    "transpose_tile": (RELAYOUT_CU, "scripts/bench_sortdma.py:139", "bench_sortdma"),
    "expand_cols": (RELAYOUT_CU, "scripts/bench_sortdma.py:177", "bench_sortdma"),
    "copy_tile": (RELAYOUT_CU, "scripts/bench_sortdma.py:279", "bench_sortdma"),
    "transpose_fat": (RELAYOUT_CU, "scripts/bench_sortdma.py:309", "bench_sortdma"),
    "transpose_mma": (RELAYOUT_CU, "scripts/bench_sortdma.py:345", "bench_sortdma"),
    "expand_rows_pm": (RELAYOUT_CU, "scripts/bench_sortdma.py:398", "bench_sortdma"),
    "transpose_flat": (RELAYOUT_CU, "scripts/bench_sortdma.py:455", "bench_sortdma"),
    "g2_block": ("zksnake_tpu_torch/csrc/g2_block.cu", "scripts/debug_g2_mosaic.py:21",
                 "debug_g2_block"),
    "bucket_reduce": ("zksnake_tpu_torch/csrc/bucket_reduce.cu",
                      "none: the JAX package reduces its buckets in plain jnp",
                      "bls12_381_prove_warm"),
}


def _no_jax_modules():
    bad = [m for m in sys.modules
           if m in ("jax", "zksnake_tpu") or m.startswith(("jax.", "zksnake_tpu."))]
    if bad:
        raise AssertionError(f"modules of jax or zksnake_tpu were imported: {bad[:5]}")


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(str(i) for i in range(len(PHASES))))
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU; prints no result and exits 1")
    args = ap.parse_args()
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ctx = Ctx("cpu" if args.rehearse else "cuda", args.rehearse)
    phases = [int(p) for p in args.phases.split(",")]
    ctx.libs = ["montmul"] + sorted({lib for i in phases for lib in PHASE_LIBS[i]})
    phase_s = {}
    for i in phases:
        t0 = time.perf_counter()
        PHASES[i](ctx)
        phase_s[f"{i}.{PHASES[i].__name__}"] = time.perf_counter() - t0
    ctx.detail["phase_s"] = phase_s
    _no_jax_modules()
    log("details " + json.dumps({**ctx.detail, "paths": ctx.paths}, default=str))
    if args.rehearse:
        log("[rehearsal] done; no result on the CPU")
        return 1
    record = []
    for name, (src, rep, path) in SOURCES.items():
        k = ctx.kernels.get(name, {})
        record.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": ctx.paths.get(path, {}).get(name),
            "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
            "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
            "bound_by": k.get("bound_by"),
            # no single PyTorch call computes a Montgomery product, a bucket
            # sum or a point add; S1-S8 carry the fastest one that relayouts
            "library_ms": k.get("library_ms"), "library": k.get("library"),
            "launches_by_path": {p: c.get(name) for p, c in ctx.paths.items()},
        })
    log(f"total {time.perf_counter() - t_start:.3f} s")
    if phases != list(range(len(PHASES))):
        log(json.dumps({"kernels": record}))
        log("partial run: no result line")
        return 1
    log(json.dumps({"kernels": record}))
    log(f"card: {smi_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        import traceback

        traceback.print_exc()
        sys.exit(1)
