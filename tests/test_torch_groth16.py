"""Groth16 on the PyTorch port against the JAX package and its fixtures,
over BN254 and BLS12-381.

The port proves on device="cpu" here (the kernels' plain versions) through
the same entry points a user calls. Each package builds its circuit through
its own front end, and the two are compared through bytes and integers
(to_bytes(), coefficients), never by handing one package's objects to the
other. Under the fixtures' deterministic randomness stream the port's keys
and proof bytes equal the JAX package's host path and the pinned fixtures
tests/fixtures/groth16_{bn254,bls12_381}.hex; its QAP equals
zksnake_tpu.groth16.qap.QAP.evaluate_witness; a prover built from the JAX
package's device arrays (backend/state.py) gives the same proof; the proof
is the same with ZKSNAKE_MXU_MONTMUL set (K3's plain version); and every
module of the port imports, and both fixture proofs come out (and the two
PlonK fixture proofs), in a process where jax and zksnake_tpu cannot be
imported.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

import zksnake_tpu.arithmetization as jax_front
import zksnake_tpu_torch as torch_front
from zksnake_tpu.curves.params import CURVES as JAX_CURVES
from zksnake_tpu.groth16 import Groth16 as JaxGroth16
from zksnake_tpu.groth16 import protocol as jax_protocol
from zksnake_tpu.groth16.serialization import ProvingKey as JaxProvingKey
from zksnake_tpu_torch.backend import field as torch_field
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend.state import prover_state_from_jax
from zksnake_tpu_torch.groth16 import Groth16, Proof, ProvingKey, VerifyingKey
from zksnake_tpu_torch.groth16 import protocol as torch_protocol

from torch_support import CURVES, FIELDS, REPO


def det_random_int(curve, skip=0):
    """tests/test_proof_fixtures.py's deterministic stream, `skip` draws
    (of the protocol's bound r - 1) on."""
    rng = random.Random(f"g16-{curve}")
    for _ in range(skip):
        rng.randrange(FIELDS[curve] - 1)
    draw = lambda n_max: 1 + rng.randrange(n_max)  # noqa: E731
    return draw


def power_circuit(front, curve):
    """The fixture circuit, out = inp^16 (16 constraints, n = 16), through
    one package's front end (`front` exports ConstraintSystem, R1CS, Var)."""
    inp, out = front.Var("inp"), front.Var("out")
    v = [front.Var(f"v{i}") for i in range(15)]
    cs = front.ConstraintSystem(["inp"], ["out"], FIELDS[curve])
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, 15):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[14])
    cs.set_public(out)
    r1cs = front.R1CS(cs, curve)
    r1cs.compile()
    pub, priv = r1cs.generate_witness(cs.solve({"inp": 3}))
    return r1cs, pub, priv


ISOLATED = r"""
import importlib
import json
import pkgutil
import random
import sys
sys.modules["jax"] = None  # any import of jax now raises
sys.modules["zksnake_tpu"] = None  # and so does any import of the JAX package
import torch
torch.set_num_threads(1)
import zksnake_tpu_torch
modules = [m.name for m in pkgutil.walk_packages(zksnake_tpu_torch.__path__, "zksnake_tpu_torch.")]
for name in modules:
    importlib.import_module(name)
from zksnake_tpu_torch import ConstraintSystem, R1CS, Var
from zksnake_tpu_torch.arithmetization import Plonkish
from zksnake_tpu_torch.groth16 import Groth16, protocol
from zksnake_tpu_torch.plonk import Plonk, protocol as plonk_protocol
out = {"jax": sys.modules["jax"], "zksnake_tpu": sys.modules["zksnake_tpu"], "modules": modules}


def power_cs(field):
    inp, o = Var("inp"), Var("out")
    v = [Var(f"v{i}") for i in range(15)]
    cs = ConstraintSystem(["inp"], ["out"], field)
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, 15):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(o == v[14])
    cs.set_public(o)
    return cs


for curve, field in FIELDS.items():
    rng = random.Random(f"g16-{curve}")
    protocol.get_random_int = lambda n_max: 1 + rng.randrange(n_max)
    cs = power_cs(field)
    r1cs = R1CS(cs, curve)
    r1cs.compile()
    pub, priv = r1cs.generate_witness(cs.solve({"inp": 3}))
    g16 = Groth16(r1cs, curve, device="cpu")
    g16.setup()
    proof = g16.prove(pub, priv)
    out[curve] = {
        "proof": proof.to_bytes().hex(), "pk": g16.proving_key.to_bytes().hex(),
        "vk": g16.verifying_key.to_bytes().hex(), "verified": g16.verify(proof, pub),
    }
    rng = random.Random(f"plonk-{curve}")
    plonk_protocol.get_random_int = lambda n_max: 1 + rng.randrange(n_max)
    cs = power_cs(field)
    plonkish = Plonkish(cs, curve)
    plonkish.compile()
    pub, priv = plonkish.generate_witness(plonkish.solve({"inp": 3}))
    plonk = Plonk(plonkish, curve, device="cpu")
    plonk.setup()
    proof = plonk.prove(pub, priv)
    out["plonk_" + curve] = {"proof": proof.to_bytes().hex(), "verified": plonk.verify(proof, pub)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def child():
    """One port setup, prove and verify per curve under the fixtures'
    randomness streams, in a fresh process where any import of jax or of
    zksnake_tpu raises, after importing every module of the port. Keys and
    proofs come back as bytes."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = f"FIELDS = {FIELDS!r}\n" + ISOLATED
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module", params=CURVES)
def run(request, child):
    """The child's keys and proof for one curve, as the port's objects."""
    curve = request.param
    out = child[curve]
    r1cs, pub, priv = power_circuit(torch_front, curve)
    g16 = Groth16(r1cs, curve, device="cpu")
    g16.proving_key = ProvingKey.from_bytes(bytes.fromhex(out["pk"]), curve)
    g16.verifying_key = VerifyingKey.from_bytes(bytes.fromhex(out["vk"]), curve)
    proof = Proof.from_bytes(bytes.fromhex(out["proof"]), curve)
    return {"curve": curve, "g16": g16, "proof": proof, "r1cs": r1cs, "pub": pub,
            "priv": priv, "child": out}


def fixture_bytes(curve, proto="groth16"):
    return bytes.fromhex((REPO / "tests" / "fixtures" / f"{proto}_{curve.lower()}.hex")
                         .read_text().strip())


def test_proof_bytes_equal_fixture(run):
    assert run["proof"].to_bytes() == fixture_bytes(run["curve"])
    assert run["g16"].verify(run["proof"], run["pub"])


def test_keys_and_proof_equal_jax_host_path(run, monkeypatch):
    curve = run["curve"]
    monkeypatch.setattr(jax_protocol, "get_random_int", det_random_int(curve))
    r1cs, pub, priv = power_circuit(jax_front, curve)
    ref = JaxGroth16(r1cs, curve)
    ref._setup_from_waste(*[jax_protocol.get_random_int(ref.order - 1) for _ in range(5)],
                          force_host=True)
    assert bytes.fromhex(run["child"]["pk"]) == ref.proving_key.to_bytes()
    assert bytes.fromhex(run["child"]["vk"]) == ref.verifying_key.to_bytes()
    assert ref.prove(pub, priv).to_bytes() == run["proof"].to_bytes()


def test_verify_rejects_wrong_public_input(run):
    pub = list(run["pub"])
    pub[-1] = (pub[-1] + 1) % FIELDS[run["curve"]]
    assert not run["g16"].verify(run["proof"], pub)


@pytest.mark.parametrize("tau", [0xA11CE, 1], ids=["device", "domain_tau"])
@pytest.mark.parametrize("curve", CURVES)
def test_setup_keys_match_jax_host_under_fixed_waste(curve, tau):
    """Device setup (tau powers, Lagrange batch inversion, L/R/O transpose
    SpMVs, fixed-base batch muls) gives the JAX host setup's key bytes; a
    tau in the domain (tau^n = 1) takes the port's host setup, which gives
    them too."""
    def circuit(front):
        x, y, v1 = front.Var("x"), front.Var("y"), front.Var("v1")
        cs = front.ConstraintSystem(["x"], ["y"], FIELDS[curve])
        cs.add_constraint(v1 == x * x)
        cs.add_constraint(y - 5 - x == v1 * x)
        cs.set_public(y)
        r1cs = front.R1CS(cs, curve)
        r1cs.compile()
        return r1cs

    waste = (tau, 0xB0B, 0xCAFE, 0xD00D, 0xE66)
    host = JaxGroth16(circuit(jax_front), curve)
    host._setup_from_waste(*waste, force_host=True)
    dev = Groth16(circuit(torch_front), curve, device="cpu")
    dev._setup_from_waste(*waste)
    # the device setup ran, or (tau = 1) the host setup did
    assert (dev._device_prover is not None) == (tau != 1)
    assert dev.proving_key.to_bytes() == host.proving_key.to_bytes()
    assert dev.verifying_key.to_bytes() == host.verifying_key.to_bytes()


def test_qap_matches_jax(run):
    from zksnake_tpu.groth16.qap import QAP

    r1cs, pub, priv = power_circuit(jax_front, run["curve"])
    qap = QAP(FIELDS[run["curve"]])
    qap.from_r1cs(r1cs)
    U, V, _, H = qap.evaluate_witness(pub + priv)
    prover = run["g16"]._get_device_prover()
    u, v, h = prover.evaluate_witness_device(run["pub"] + run["priv"])
    fr = prover.fr
    for got, want in ((u, U), (v, V), (h, H)):
        coeffs = fr.raw_from_host(got)
        c = want.coeffs()
        assert coeffs == list(c) + [0] * (len(coeffs) - len(c))
    # the port's own host QAP (polynomial.py on device="cpu") agrees too
    port = run["g16"].qap.evaluate_witness(run["pub"] + run["priv"])
    assert [p.coeffs() for p in port] == [p.coeffs() for p in qap.evaluate_witness(pub + priv)]


def prove_with_stream(g16, run):
    """A proof under the stream's 6th and 7th draws (setup took five): the
    r and s of the child's proof."""
    old = torch_protocol.get_random_int
    torch_protocol.get_random_int = det_random_int(run["curve"], skip=5)
    try:
        return g16.prove(run["pub"], run["priv"])
    finally:
        torch_protocol.get_random_int = old


def test_prover_state_from_jax_gives_same_proof(run):
    """A prover fed the JAX Groth16DeviceProver's arrays (proving key point
    leaves, sparse matrices) proves byte-identically."""
    from zksnake_tpu.backend.groth16_device import Groth16DeviceProver as JaxProver
    from zksnake_tpu.groth16.qap import QAP

    curve = run["curve"]
    r1cs, _, _ = power_circuit(jax_front, curve)
    qap = QAP(FIELDS[curve])
    qap.from_r1cs(r1cs)
    jp = JaxProver(qap, JAX_CURVES[curve])
    pkd = jp.pk_device(JaxProvingKey.from_bytes(bytes.fromhex(run["child"]["pk"]), curve))
    arrays = {
        "pk": {k: jax.tree_util.tree_map(np.asarray, v) for k, v in pkd.items()},
        **{
            name: {"rows": np.asarray(m.rows), "cols": np.asarray(m.cols),
                   "vals": np.asarray(m.vals), "n_row": m.n_row, "n_col": m.n_col}
            for name, m in (("A", jp.A), ("B", jp.B), ("C", jp.C))
        },
    }
    other = Groth16(run["r1cs"], curve, device="cpu")
    other.proving_key, other.verifying_key = run["g16"].proving_key, run["g16"].verifying_key
    other._get_device_prover().load_state(prover_state_from_jax(arrays, "cpu", curve))
    assert prove_with_stream(other, run).to_bytes() == run["proof"].to_bytes()


def test_mxu_flag_gives_same_proof(run, monkeypatch):
    """ZKSNAKE_MXU_MONTMUL=1 (with the lane threshold lowered to this
    circuit's size) sends the prove's products to K3's path: same proof."""
    monkeypatch.setenv("ZKSNAKE_MXU_MONTMUL", "1")
    monkeypatch.setattr(torch_field, "MXU_MIN_LANES", 16)
    calls = []
    orig = kernels.mont_mul_mma

    def spy(fs, a, b):
        calls.append(a.shape[1])
        return orig(fs, a, b)

    monkeypatch.setattr(kernels, "mont_mul_mma", spy)
    g16 = Groth16(run["r1cs"], run["curve"], device="cpu")
    g16.proving_key, g16.verifying_key = run["g16"].proving_key, run["g16"].verifying_key
    assert prove_with_stream(g16, run).to_bytes() == run["proof"].to_bytes()
    assert calls


def test_circom_import_equals_jax_and_proves():
    """R1CS.from_file, the Circom importer (parser.py), on
    tests/stub/test_poseidon.r1cs and .sym: the constraint matrices and the
    solved witness equal the JAX package's as integers
    (tests/test_groth16.py:93), and a port prove on them verifies."""
    def load(front):
        r1cs = front.R1CS.from_file(str(REPO / "tests" / "stub" / "test_poseidon.r1cs"),
                                    str(REPO / "tests" / "stub" / "test_poseidon.sym"))
        solved = r1cs.solve({"main.a": 1, "main.b": 2, "main.c": 3})
        r1cs.compile()
        return r1cs, r1cs.generate_witness(solved)

    mine, (pub, priv) = load(torch_front)
    ref, witness = load(jax_front)
    for name in "ABC":
        got, want = getattr(mine, name), getattr(ref, name)
        assert (got.n_row, got.n_col, got.p) == (want.n_row, want.n_col, want.p)
        assert got.triplets == want.triplets
    assert (pub, priv) == witness
    assert mine.is_sat(pub, priv)
    g16 = Groth16(mine, device="cpu")
    g16.setup()
    assert g16.verify(g16.prove(pub, priv), pub)


def test_cuda_device_is_never_swapped_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r1cs, _, _ = power_circuit(torch_front, "BN254")
    with pytest.raises(RuntimeError, match="CUDA"):
        Groth16(r1cs, "BN254", device="cuda")


def test_port_runs_with_jax_unimportable(child):
    """The child process (above) blocked jax and zksnake_tpu, imported every
    module of the port and proved on both curves."""
    assert child["jax"] is None and child["zksnake_tpu"] is None
    port = REPO / "zksnake_tpu_torch"
    files = {str(p.relative_to(REPO).with_suffix("")).replace(os.sep, ".")
             for p in port.rglob("*.py")}
    files = {f[: -len(".__init__")] if f.endswith(".__init__") else f for f in files}
    assert files - {"zksnake_tpu_torch"} <= set(child["modules"])
    assert {"zksnake_tpu_torch.plonk.protocol", "zksnake_tpu_torch.transcript",
            "zksnake_tpu_torch.arithmetization.plonkish_compiler",
            "zksnake_tpu_torch.backend.plonk_device"} <= set(child["modules"])
    assert all(child[c]["verified"] for c in CURVES)


@pytest.mark.parametrize("curve", CURVES)
def test_plonk_fixtures_with_jax_unimportable(child, curve):
    """The same child proved tests/fixtures/plonk_*.hex with the port's
    PlonK, jax and zksnake_tpu blocked."""
    out = child["plonk_" + curve]
    assert bytes.fromhex(out["proof"]) == fixture_bytes(curve, "plonk")
    assert out["verified"]
