"""Sharded proving of the PyTorch port (backend/sharding.py, Groth16(mesh=))
on a gloo group of 4 ranks on the CPU, against the JAX package's host
oracles: twins of tests/test_sharding.py's four tests, and the port's
host layout helpers against the JAX package's.

The ranks are spawned once for the module (one mp.spawn, rendezvous through
a file under tmp_path, a timeout of its own); each runs every check and
writes its results as JSON, and each test asserts its part. The ranks
import only torch and the port: this module imports jax and zksnake_tpu
inside the tests, since every spawned rank imports it again. The JAX
package's shard_map graphs are not run here; tests/test_sharding.py holds
them to the same oracles.
"""

import json
import os
import random
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_support  # noqa: F401  (torch on one thread)

NDEV = 4
SPAWN_TIMEOUT_S = 300
# (group, points): 4 lanes a rank take double-and-add, 64 the Pippenger
MSM_CASES = [(1, 4 * NDEV), (2, 4 * NDEV), (1, 64 * NDEV)]
NTT_SPLITS = [(2 * NDEV, 2 * NDEV), (2 * NDEV, 4 * NDEV)]  # (n1, n2)
PAD_N = 3 * NDEV + 5  # not a multiple of the mesh
CHAIN = 48  # mult-chain constraints: n = 64 = 8 x 8, so the QAP's split divides by 4
SMALL_CHAIN = 5  # n = 8 = 2 x 4: the split does not divide, so the QAP runs replicated


def _msm_inputs(group, n, seed):
    """Multiples k_i of the generator and 31-bit scalars s_i."""
    rng = random.Random(seed + group)
    ks = [rng.randrange(1, 1 << 16) for _ in range(n)]
    ss = [rng.randrange(1 << 31) for _ in range(n)]
    return ks, ss


def _ntt_coeffs(n):
    from zksnake_tpu_torch.curves.params import CURVES

    rng = random.Random(31)
    return [rng.randrange(CURVES["BN254"].r) for _ in range(n)]


def _seeded(protocol, seed):
    """protocol.get_random_int drawing from random.Random(seed)."""
    rng = random.Random(seed)
    protocol.get_random_int = lambda n_max: 1 + rng.randrange(n_max)


def _mult_chain(front, field, chain=CHAIN):
    """out = inp^chain (tests/test_sharding.py's circuit), through one
    package's front end."""
    inp, out = front.Var("inp"), front.Var("out")
    v = [front.Var(f"v{i}") for i in range(chain - 1)]
    cs = front.ConstraintSystem(["inp"], ["out"], field)
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, chain - 1):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[chain - 2])
    cs.set_public(out)
    r1cs = front.R1CS(cs, "BN254")
    r1cs.compile()
    pub, priv = r1cs.generate_witness(cs.solve({"inp": 2}))
    return r1cs, pub, priv


def _rank_checks(group, mesh):
    """Every check of the module on this rank; JSON-ready results."""
    import zksnake_tpu_torch as front
    from zksnake_tpu_torch import BN254_SCALAR_FIELD
    from zksnake_tpu_torch.backend import sharding
    from zksnake_tpu_torch.backend.curve_ops import get_group_spec
    from zksnake_tpu_torch.backend.msm import scalars_to_device
    from zksnake_tpu_torch.backend.ntt import Domain
    from zksnake_tpu_torch.curves import get_curve_module
    from zksnake_tpu_torch.groth16 import Groth16, protocol

    cm = get_curve_module("BN254", "cpu")
    curve = cm._curve
    rank = dist.get_rank(group)
    out = {}

    def msm(group_id, n, seed, pad=False):
        gs = get_group_spec(curve, group_id)
        G = cm.g1() if group_id == 1 else cm.g2()
        ks, ss = _msm_inputs(group_id, n, seed)
        P = gs.points_to_device([G * k for k in ks], "cpu")
        s = scalars_to_device(ss, curve.r, "cpu")[:2]  # 31-bit scalars: two limbs
        if pad:
            P, s = sharding.pad_msm_operands(gs, P, s, NDEV)
            out["pad_lanes"] = s.shape[1]
        P, s = sharding.shard_lanes(gs, P, s, group)
        res = sharding.sharded_msm(gs, P, s, group)
        cls = type(G)
        return gs.points_from_device(gs.map(lambda t: t[:, None], res), cls)[0].to_hex()

    out["msm"] = [msm(g, n, 77) for g, n in MSM_CASES]
    out["pad"] = msm(1, PAD_N, 99, pad=True)

    out["ntt"] = []
    for n1, n2 in NTT_SPLITS:
        dom = Domain.get(curve, n1 * n2)
        x = sharding.fourstep_input_layout(dom.fs, _ntt_coeffs(n1 * n2), n1, n2)
        rows = n1 // NDEV
        x_local = dom.fs.to_device(x[:, rank * rows:(rank + 1) * rows], "cpu")
        y = sharding.sharded_ntt(dom, x_local, n1, group)
        out["ntt"].append(y.tolist())

    out["mesh"] = [mesh.device_type, mesh.size(), list(mesh.mesh_dim_names)]

    def mesh_prove(chain, seed):
        """Groth16(mesh=) on the mult chain: seeded setup and prove."""
        r1cs, pub, priv = _mult_chain(front, BN254_SCALAR_FIELD, chain)
        g16 = Groth16(r1cs, "BN254", device="cpu", mesh=mesh)
        _seeded(protocol, seed + "-setup")
        g16.setup()
        _seeded(protocol, seed + "-r-s")
        return r1cs, pub, priv, g16, g16.prove(pub, priv)

    def one_device_proof(r1cs, pub, priv, g16, seed):
        """The one-device prove under g16's keys and the seeded r, s."""
        one = Groth16(r1cs, "BN254", device="cpu")
        one.proving_key, one.verifying_key = g16.proving_key, g16.verifying_key
        _seeded(protocol, seed + "-r-s")
        return one.prove(pub, priv).to_bytes().hex()

    # n = 64: the sharded QAP; n = 8: the replicated QAP, the MSMs sharded
    big = mesh_prove(CHAIN, "sharded")
    small = mesh_prove(SMALL_CHAIN, "replicated")
    sq = big[3]._device_prover._sqap[1]
    res = out["groth16"] = {
        "proof": big[4].to_bytes().hex(), "pk": big[3].proving_key.to_bytes().hex(),
        "split": [sq.n1, sq.n2] if sq is not None else None,
    }
    res_small = out["replicated"] = {
        "proof": small[4].to_bytes().hex(),
        "sharded_qap": small[3]._device_prover._sqap[1] is not None,
    }
    # the references, spread over the ranks so they run side by side
    if rank == 0:
        res["verified"] = big[3].verify(big[4], big[1])
    elif rank == 1:
        res["one_device_proof"] = one_device_proof(*big[:4], "sharded")
    elif rank == 2:  # the one-device key from rank 0's waste
        rng = random.Random("sharded-setup")
        one = Groth16(big[0], "BN254", device="cpu")
        one._setup_from_waste(*[1 + rng.randrange(curve.r - 1) for _ in range(5)])
        res["one_device_pk"] = one.proving_key.to_bytes().hex()
    else:
        res_small["one_device_proof"] = one_device_proof(*small[:4], "replicated")
        res_small["verified"] = small[3].verify(small[4], small[1])
    return out


def _rank_main(rank, path):
    """Entry of a spawned rank: init the gloo group and the 1-D mesh, run
    the checks, write rank<i>.json."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv", rank=rank,
                            world_size=NDEV)
    try:
        from zksnake_tpu_torch.backend.sharding import make_mesh

        mesh = make_mesh("cpu")
        t0 = time.perf_counter()
        out = _rank_checks(mesh.get_group("shards"), mesh)
        out["seconds"] = time.perf_counter() - t0
        with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The results of the NDEV ranks (one spawn for the module)."""
    path = str(tmp_path_factory.mktemp("ranks"))
    ctx = mp.spawn(_rank_main, args=(path,), nprocs=NDEV, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {NDEV} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    out = []
    for rank in range(NDEV):
        with open(os.path.join(path, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _host_msm(points, scalars):
    total = None
    for pt, s in zip(points, scalars):
        term = pt * s
        total = term if total is None else total + term
    return total


@pytest.mark.parametrize("case", range(len(MSM_CASES)),
                         ids=[f"G{g}-{n}" for g, n in MSM_CASES])
def test_sharded_msm_matches_host(ranks, case):
    from zksnake_tpu.curves import ec_bn254

    group, n = MSM_CASES[case]
    G = ec_bn254.g1() if group == 1 else ec_bn254.g2()
    ks, ss = _msm_inputs(group, n, 77)
    want = _host_msm([G * k for k in ks], ss).to_hex()
    assert [r["msm"][case] for r in ranks] == [want] * NDEV


def test_sharded_msm_identity_padding(ranks):
    from zksnake_tpu.curves import ec_bn254

    ks, ss = _msm_inputs(1, PAD_N, 99)
    want = _host_msm([ec_bn254.g1() * k for k in ks], ss).to_hex()
    assert ranks[0]["pad_lanes"] % NDEV == 0
    assert [r["pad"] for r in ranks] == [want] * NDEV


@pytest.mark.parametrize("split", range(len(NTT_SPLITS)),
                         ids=[f"{a}x{b}" for a, b in NTT_SPLITS])
def test_sharded_fourstep_ntt_matches_host(ranks, split):
    from zksnake_tpu.polynomial import _HostDomain
    from zksnake_tpu_torch.backend.field import FieldSpec
    from zksnake_tpu_torch.backend.sharding import fourstep_output_to_natural
    from zksnake_tpu_torch.curves.params import CURVES

    n1, n2 = NTT_SPLITS[split]
    r = CURVES["BN254"].r
    parts = [np.asarray(rk["ntt"][split], dtype=np.int64) for rk in ranks]
    got = fourstep_output_to_natural(FieldSpec.get(r), np.concatenate(parts, axis=1), n1, n2)
    assert got == _HostDomain.get(r, n1 * n2).fft(_ntt_coeffs(n1 * n2))


def test_sharded_groth16_prove_verifies(ranks):
    """Groth16(mesh=) on 4 ranks takes the sharded QAP (n = 64 = 8 x 8),
    verifies, gives every rank the same bytes, and equals the one-device
    prove under the same keys and r, s."""
    g = [r["groth16"] for r in ranks]
    assert g[0]["split"] == [8, 8]
    assert g[0]["verified"]
    want = g[1]["one_device_proof"]
    assert [x["proof"] for x in g] == [want] * NDEV


def test_sharded_groth16_replicated_qap(ranks):
    """At n = 8 = 2 x 4 the mesh of 4 does not divide the QAP's split: the
    QAP runs replicated and the MSMs sharded, and every rank's proof
    verifies and equals the one-device prove under the same keys and r, s."""
    g = [r["replicated"] for r in ranks]
    assert not any(x["sharded_qap"] for x in g)
    assert g[3]["verified"]
    assert [x["proof"] for x in g] == [g[3]["one_device_proof"]] * NDEV


def test_make_mesh_builds_the_mesh(ranks):
    """make_mesh makes a 1-D mesh of the whole default group, dim
    "shards", on the device type asked for."""
    assert [r["mesh"] for r in ranks] == [["cpu", NDEV, ["shards"]]] * NDEV


def test_sharded_setup_keys_equal_one_device(ranks):
    """Every rank builds the key of rank 0's broadcast toxic waste: the
    one-device setup's from the same waste."""
    g = [r["groth16"] for r in ranks]
    assert [x["pk"] for x in g] == [g[2]["one_device_pk"]] * NDEV


def test_layout_helpers_equal_jax():
    """fourstep_input_layout, fourstep_output_to_natural and
    FourStepPlan.tw_host equal the JAX package's, limb for limb (host
    numpy: nothing compiles)."""
    from zksnake_tpu.backend import sharding as jax_sharding
    from zksnake_tpu.backend.field import FieldSpec as JaxFieldSpec
    from zksnake_tpu_torch.backend import sharding
    from zksnake_tpu_torch.backend.field import FieldSpec
    from zksnake_tpu_torch.curves.params import CURVES

    for name in ("BN254", "BLS12_381"):
        r = CURVES[name].r
        fs, jfs = FieldSpec.get(r), JaxFieldSpec.get(r)
        rng = random.Random(name)
        for n1, n2 in NTT_SPLITS:
            n = n1 * n2
            coeffs = [rng.randrange(r) for _ in range(n - 3)]  # short: zero padded
            x = sharding.fourstep_input_layout(fs, coeffs, n1, n2)
            np.testing.assert_array_equal(
                x.astype(np.uint32), jax_sharding.fourstep_input_layout(jfs, coeffs, n1, n2))
            out = np.ascontiguousarray(x.reshape(fs.nl, n2, n1))
            assert (sharding.fourstep_output_to_natural(fs, out, n1, n2)
                    == jax_sharding.fourstep_output_to_natural(jfs, out, n1, n2))
            omega = pow(CURVES[name].fr_generator, (r - 1) // n, r)
            plan = sharding.FourStepPlan(fs, r, n1, n2, omega, scale=pow(n, -1, r))
            jplan = jax_sharding.FourStepPlan(jfs, r, n1, n2, omega, scale=pow(n, -1, r))
            np.testing.assert_array_equal(plan.tw_host.astype(np.uint32), jplan.tw_host)
