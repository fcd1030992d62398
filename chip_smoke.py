#!/usr/bin/env python3
"""Drive the PyTorch port's Groth16 prover (BN254 and BLS12-381) once on one
CUDA card.

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --phases 0,1,2  # a subset (kernel checks only)
    python3 chip_smoke.py --rehearse      # the same phases at toy sizes on
                                          # the CPU; prints no result, exits 1

Phases, one line each or more:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions, the
     kernels' build from zksnake_tpu_torch/csrc (registers and spills);
  1. K1 (mont_mul) against its plain version, bit for bit, at (16, 2^20) for
     BN254 Fr and Fq and (24, 2^18) for BLS12-381 Fq, with 0, 1, p-1 lanes;
  2. K3 (mont_mul_mma) against its plain version, bit for bit, at the same
     shapes, timed beside K1;
  3. K2 (bucket_accumulate) against its plain version, bit for bit, on one
     MSM's windows at the prove shape (2^17 points, c = 11), G1 and G2 of
     BN254 (16-limb build) and of BLS12-381 (24-limb build);
  4. a device-resident BN254 G1 MSM at 2^20 against the host oracle
     G * sum(s_i (i % 64 + 1)) for points (i % 64 + 1) G;
  5. the same MSM with ZKSNAKE_MXU_MONTMUL=1 (K3 for the large products);
  6. the pinned proof fixtures tests/fixtures/groth16_{bn254,bls12_381}.hex
     reproduced on the card under the deterministic randomness streams;
  7. a main path: the mult-chain circuit at 2^17 constraints through
     Groth16(r1cs, "BN254", device="cuda"): setup, a cold and a warm prove,
     verify, with every kernel's launch count during the warm prove;
  8. a main path: the same at 2^17 over BLS12-381, a cold and a warm prove by
     default, then a warm prove with ZKSNAKE_MXU_MONTMUL=1 under the same
     r, s: the two proofs are byte-equal and verify, and K3 launches only
     under the flag.

It exits non-zero on any failure, when no CUDA device is present, and when
jax or any module of zksnake_tpu was imported. The last four lines are the
total seconds, the kernels' JSON record, the card's name and power limit,
and {"ok": true, "device": {...}}. A "details" line before them holds every
measurement as JSON.
"""

import argparse
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

# Peak rates of one NVIDIA H100 SXM (dense): HBM3 3.35 TB/s and int8 tensor
# cores 1,979 TOP/s (NVIDIA's data sheet); 32-bit integer multiply-adds at 64
# per SM per clock (NVIDIA's throughput table, compute capability 9.0) x 132 SMs
# x 1.98 GHz, the clock behind the sheet's 67 TFLOP/s float32.
HBM_BYTES_S = 3.35e12
INT8_TC_OPS_S = 1979e12
IMAD_OPS_S = 132 * 64 * 1.98e9


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
        kernels.build()
        build_s = time.perf_counter() - t0
        ptxas = {}
        for name in ("montmul", "montmul_mma", "bucket16", "bucket24"):
            path = os.path.join(kernels.BUILD_DIR, f"{name}.ptxas.txt")
            if os.path.exists(path):
                with open(path) as f:
                    ptxas[name] = [l.strip() for l in f if "registers" in l or "spill" in l]
        ctx.detail["ptxas"] = ptxas
        ctx.detail["build_s"] = build_s
        log(f"[0] card: {ctx.detail['smi']}")
        log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"[0] kernels built in {build_s:.3f} s from zksnake_tpu_torch/csrc")
        for name, lines in ptxas.items():
            for l in lines:
                log(f"[0] ptxas {name}: {l}")
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


def _field_operands(ctx, seed):
    """[(name, fs, a, b)] at K1_SHAPES (toy widths in a rehearsal)."""
    import numpy as np

    from zksnake_tpu_torch import BLS12_381_MODULUS, BN254_MODULUS, BN254_SCALAR_FIELD
    from zksnake_tpu_torch.backend.field import FieldSpec

    mods = {"BN254_Fr": BN254_SCALAR_FIELD, "BN254_Fq": BN254_MODULUS,
            "BLS12_381_Fq": BLS12_381_MODULUS}
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
        nb = 2 * nl
        nw = nl // 2
        bms, bby = bound(3 * nl * 4 * n, [(2 * 3 * nb * nb * n, INT8_TC_OPS_S),
                                          (2 * nw * nw * n, IMAD_OPS_S)])
        ms, k1_ms = (k3a + k3b) / 2, (k1a + k1b) / 2
        rows.append({"field": name, "shape": [nl, n], "max_abs_err": err, "ms": ms,
                     "k1_ms": k1_ms, "turns_ms": [k3a, k1a, k1b, k3b], "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": bby})
        log(f"[2] K3 mont_mul_mma {name} ({nl}, 2^{logn}): bit-identical to plain and K1; "
            f"K3 {ms:.4f} ms, K1 {k1_ms:.4f} ms (turns {k3a:.4f} {k1a:.4f} {k1b:.4f} "
            f"{k3b:.4f}), plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({bby})")
    ctx.detail["k3"] = rows
    ctx.kernels["mont_mul_mma"] = rows[0]


def _tiled_points(gs, curve_mod, n, device):
    """n device points (i % 64 + 1) G (the bench oracle's shape)."""
    base = [curve_mod.g1() * (i + 1) for i in range(64)] if gs.group == 1 else \
        [curve_mod.g2() * (i + 1) for i in range(64)]
    P64 = gs.points_to_device(base, device)
    return gs.map(lambda t: t.repeat(1, n // 64), P64), base


def phase_k2(ctx):
    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import scalars_to_device, sort_by_digit
    from zksnake_tpu_torch.curves import get_curve_module

    logn, c = (PROVE_LOGN, 11) if not ctx.rehearse else (9, 7)
    n = 1 << logn
    rows = []
    for curve_name in K2_CURVES:
        cm = get_curve_module(curve_name, ctx.device)
        curve = cm._curve
        rng = random.Random(0x2B)
        for group in (1, 2):
            gs = get_group_spec(curve, group)
            P, _ = _tiled_points(gs, cm, n, ctx.device)
            s = scalars_to_device([rng.randrange(curve.r) for _ in range(n)], curve.r, ctx.device)
            pts, starts, lens, _, _ = sort_by_digit(gs, P, s, c)
            got = kernels.bucket_accumulate(gs, pts, starts, lens)
            t0 = time.perf_counter()
            want = kernels.bucket_accumulate_plain(gs, pts, starts, lens)
            ctx.sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = int((got.long() - want.long()).abs().max())
            if err != 0:
                raise AssertionError(f"K2 {curve_name} G{group}: kernel != plain (max |err| {err})")
            ms = ctx.time_ms(lambda: kernels.bucket_accumulate(gs, pts, starts, lens), 3)
            W_, B2 = starts.shape
            adds = int(lens.sum())  # mixed adds this data needs
            nw = gs.fs.nl // 2
            fmuls = 13 * (1 if group == 1 else 3)  # field.cuh::add_affine; Fq2 Karatsuba
            nbytes = 4 * (pts.numel() + starts.numel() + lens.numel() + got.numel())
            bms, bby = bound(nbytes, [(adds * fmuls * cios_imads(nw), IMAD_OPS_S)])
            row = {"curve": curve_name, "group": group, "points": n, "c": c, "windows": W_,
                   "buckets": B2, "max_run": int(lens.max()), "mixed_adds": adds,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": bby}
            rows.append(row)
            log(f"[3] K2 bucket_accumulate {curve_name} G{group} 2^{logn} points c={c} "
                f"({W_}x{B2} runs, longest {row['max_run']}, {adds} mixed adds): "
                f"bit-identical projective buckets; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                f"bound {bms:.4f} ms ({bby})")
            del pts, got, want
    ctx.detail["k2"] = rows
    ctx.kernels["bucket_accumulate"] = rows[0]


def _msm_2e20(ctx, tag):
    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import msm_device_raw, scalars_to_device
    from zksnake_tpu_torch.curves import get_curve_module

    cm = get_curve_module("BN254", ctx.device)
    curve = cm._curve
    gs = get_group_spec(curve, 1)
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
    want = cm.g1() * (total % curve.r)
    got = gs.points_from_device(gs.map(lambda t: t[:, None], res), cm.PointG1)[0]
    if got != want:
        raise AssertionError(f"G1 MSM ({tag}) result does not match the host oracle")
    return {"points": n, "seconds": dt, "points_per_s": n / dt, "launches": launches}, logn


def phase_msm(ctx):
    row, logn = _msm_2e20(ctx, "CIOS")
    ctx.detail["msm"] = row
    log(f"[4] G1 MSM 2^{logn}: equals the host oracle; {row['seconds']:.4f} s, "
        f"{row['points_per_s']:.1f} points/s; launches {row['launches']}")


def phase_msm_mma(ctx):
    with flag_env("1"):
        row, logn = _msm_2e20(ctx, "ZKSNAKE_MXU_MONTMUL=1")
    if ctx.device.type == "cuda" and row["launches"]["mont_mul_mma"] == 0:
        raise AssertionError("the MSM under ZKSNAKE_MXU_MONTMUL=1 launched no K3")
    ctx.detail["msm_mma"] = row
    log(f"[5] G1 MSM 2^{logn}, ZKSNAKE_MXU_MONTMUL=1: equals the host oracle; "
        f"{row['seconds']:.4f} s, {row['points_per_s']:.1f} points/s "
        f"(CIOS in phase 4: {ctx.detail.get('msm', {}).get('seconds', float('nan')):.4f} s); "
        f"launches {row['launches']}")


def _det_random_int(seed):
    rng = random.Random(seed)
    return lambda n_max: 1 + rng.randrange(n_max)


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


def phase_fixtures(ctx):
    from zksnake_tpu_torch.groth16 import Groth16, protocol

    for curve in ("BN254", "BLS12_381"):
        saved = protocol.get_random_int
        protocol.get_random_int = _det_random_int(f"g16-{curve}")
        try:
            r1cs, pub, priv = _mult_chain(16, curve, 3)
            g16 = Groth16(r1cs, curve, device=ctx.device)
            g16.setup()
            proof = g16.prove(pub, priv)
            ok = g16.verify(proof, pub)
        finally:
            protocol.get_random_int = saved
        path = os.path.join(REPO, "tests", "fixtures", f"groth16_{curve.lower()}.hex")
        with open(path) as f:
            want = bytes.fromhex(f.read().strip())
        if proof.to_bytes() != want or not ok:
            raise AssertionError(f"{curve} fixture proof bytes differ from {path}")
        log(f"[6] fixture proof {curve}: byte-identical to "
            f"tests/fixtures/groth16_{curve.lower()}.hex, verifies")


def _prove_counted(ctx, g16, pub, priv, seed=None):
    """One prove with every launch counter set to 0 just before it and read
    just after; `seed` fixes r, s. Returns (proof, seconds, launches)."""
    from zksnake_tpu_torch.backend import kernels
    from zksnake_tpu_torch.groth16 import protocol

    saved = protocol.get_random_int
    if seed is not None:
        protocol.get_random_int = _det_random_int(seed)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        proof = g16.prove(pub, priv)
        ctx.sync()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        protocol.get_random_int = saved
    return proof, dt, launches


def _require_launches(ctx, path, launches, names):
    if ctx.device.type == "cuda" and min(launches[k] for k in names) == 0:
        raise AssertionError(f"{path}: a kernel of the path was not launched: {launches}")


def _groth16_path(ctx, curve, tag):
    """Front end, setup and a cold prove of the mult chain at 2^PROVE_LOGN."""
    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.groth16 import Groth16

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
    _, t_cold, _ = _prove_counted(ctx, g16, pub, priv)
    row = {"curve": curve, "constraints": 1 << logn, "frontend_s": t_front,
           "setup_s": t_setup, "prove_cold_s": t_cold, "setup_phases": setup_phases}
    log(f"[{tag}] Groth16 {curve} 2^{logn} constraints: frontend {t_front:.3f} s, "
        f"setup {t_setup:.3f} s, prove cold {t_cold:.3f} s")
    log(f"[{tag}] setup phases " + json.dumps({k: v["seconds"] for k, v in setup_phases.items()}))
    return g16, pub, priv, row


def phase_bn254(ctx):
    from zksnake_tpu_torch import metrics

    g16, pub, priv, row = _groth16_path(ctx, "BN254", 7)
    metrics.reset()
    proof, t_warm, launches = _prove_counted(ctx, g16, pub, priv)
    prove_phases = metrics.report()
    metrics.enable(False)
    t0 = time.perf_counter()
    ok = g16.verify(proof, pub)
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the BN254 main-path proof does not verify")
    _require_launches(ctx, "BN254 warm prove", launches, ("mont_mul", "bucket_accumulate"))
    if launches["mont_mul_mma"] != 0:
        raise AssertionError(f"K3 launched without ZKSNAKE_MXU_MONTMUL: {launches}")
    ctx.paths["bn254_prove_warm"] = launches
    row.update(prove_warm_s=t_warm, verify_s=t_verify, launches_warm=launches,
               prove_phases=prove_phases)
    ctx.detail["prove_bn254"] = row
    log(f"[7] warm prove {t_warm:.3f} s, verify {t_verify:.3f} s: True; "
        f"warm-prove launches {launches}")
    log("[7] prove phases " + json.dumps({k: v["seconds"] for k, v in prove_phases.items()}))


def phase_bls12_381(ctx):
    from zksnake_tpu_torch import metrics

    g16, pub, priv, row = _groth16_path(ctx, "BLS12_381", 8)
    seed = "chip-smoke-bls12-381-r-s"
    metrics.reset()
    proof, t_warm, launches = _prove_counted(ctx, g16, pub, priv, seed)
    phases_off = metrics.report()
    metrics.reset()
    with flag_env("1"):
        proof_mma, t_mma, launches_mma = _prove_counted(ctx, g16, pub, priv, seed)
    phases_on = metrics.report()
    metrics.enable(False)
    if proof.to_bytes() != proof_mma.to_bytes():
        raise AssertionError("BLS12-381: the proof differs with ZKSNAKE_MXU_MONTMUL=1")
    t0 = time.perf_counter()
    ok = g16.verify(proof, pub)
    t_verify = time.perf_counter() - t0
    ok_mma = g16.verify(proof_mma, pub)
    if not (ok and ok_mma):
        raise AssertionError("the BLS12-381 main-path proofs do not verify")
    _require_launches(ctx, "BLS12-381 warm prove", launches, ("mont_mul", "bucket_accumulate"))
    _require_launches(ctx, "BLS12-381 warm prove, ZKSNAKE_MXU_MONTMUL=1", launches_mma,
                      ("mont_mul", "bucket_accumulate", "mont_mul_mma"))
    if launches["mont_mul_mma"] != 0:
        raise AssertionError(f"K3 launched without ZKSNAKE_MXU_MONTMUL: {launches}")
    ctx.paths["bls12_381_prove_warm"] = launches
    ctx.paths["bls12_381_prove_warm_mxu"] = launches_mma
    row.update(prove_warm_s=t_warm, prove_warm_mxu_s=t_mma, verify_s=t_verify,
               launches_warm=launches, launches_warm_mxu=launches_mma,
               prove_phases=phases_off, prove_phases_mxu=phases_on)
    ctx.detail["prove_bls12_381"] = row
    log(f"[8] warm prove {t_warm:.3f} s (launches {launches}); with ZKSNAKE_MXU_MONTMUL=1 "
        f"{t_mma:.3f} s (launches {launches_mma}); proofs byte-equal; verify "
        f"{t_verify:.3f} s: True, True")
    log("[8] prove phases " + json.dumps({k: v["seconds"] for k, v in phases_off.items()}))
    log("[8] prove phases, flag " + json.dumps({k: v["seconds"] for k, v in phases_on.items()}))


PHASES = [phase_build, phase_k1, phase_k3, phase_k2, phase_msm, phase_msm_mma,
          phase_fixtures, phase_bn254, phase_bls12_381]

# kernel -> (source, the TPU kernel it replaces, the main-path run its
# launch count is read from)
SOURCES = {
    "mont_mul": ("zksnake_tpu_torch/csrc/montmul.cu", "zksnake_tpu/backend/pallas_field.py:43",
                 "bls12_381_prove_warm"),
    "bucket_accumulate": ("zksnake_tpu_torch/csrc/bucket.cu",
                          "zksnake_tpu/backend/pallas_field.py:244", "bls12_381_prove_warm"),
    "mont_mul_mma": ("zksnake_tpu_torch/csrc/montmul_mma.cu",
                     "zksnake_tpu/backend/pallas_field.py:24", "bls12_381_prove_warm_mxu"),
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
    for i in phases:
        PHASES[i](ctx)
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
            # no single PyTorch call computes a Montgomery product or a bucket sum
            "library_ms": None,
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
