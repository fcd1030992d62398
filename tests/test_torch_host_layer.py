"""The JAX package's host-layer tests, run on the PyTorch port on the CPU:
tests/test_algebra.py, test_symbolic.py and test_r1cs_qap.py whole, and
test_curves.py's group laws, serialization round trip, pairing
bilinearity, BN254 coordinates and from_x, test_groth16.py's forged public
input and proof and key serialization, and test_plonk.py's key
serialization.

Each test is its reference's, with two kinds of edit: device="cpu" (the
port defaults to CUDA and raises without a card), and curve modules from
get_curve_module(name, "cpu") in place of the JAX package's module-level
ec_bn254 / ec_bls12_381. Where the reference asserts only a round trip or
that a call runs, the values are also compared with the JAX package's,
through integers and bytes.
"""

import random

import pytest

import zksnake_tpu.arithmetization as jax_front
import zksnake_tpu_torch.arithmetization as torch_front
from zksnake_tpu import polynomial as jax_poly
from zksnake_tpu.curves import ec_bls12_381, ec_bn254
from zksnake_tpu.ecc import EllipticCurve as JaxEllipticCurve
from zksnake_tpu.groth16 import Groth16 as JaxGroth16
from zksnake_tpu.groth16 import Proof as JaxProof
from zksnake_tpu.groth16.qap import QAP as JaxQAP
from zksnake_tpu.plonk import Plonk as JaxPlonk
from zksnake_tpu.plonk import protocol as jax_plonk_protocol
from zksnake_tpu_torch import BLS12_381_SCALAR_FIELD, BN254_SCALAR_FIELD
from zksnake_tpu_torch.arithmetization import R1CS, ConstraintSystem, Var
from zksnake_tpu_torch.curves import get_curve_module
from zksnake_tpu_torch.ecc import EllipticCurve
from zksnake_tpu_torch.groth16 import Groth16, Proof, ProvingKey, VerifyingKey
from zksnake_tpu_torch.groth16.qap import QAP
from zksnake_tpu_torch.plonk import Plonk
from zksnake_tpu_torch.plonk import ProvingKey as PlonkProvingKey
from zksnake_tpu_torch.plonk import VerifyingKey as PlonkVerifyingKey
from zksnake_tpu_torch.plonk import protocol as plonk_protocol
from zksnake_tpu_torch.polynomial import (
    Polynomial,
    coset_fft,
    coset_ifft,
    evaluate_lagrange_coefficients,
    evaluate_vanishing_polynomial,
    fft,
    get_all_evaluation_points,
    ifft,
)

from torch_support import CURVES, FIELDS

JAX_MODULES = {"BN254": ec_bn254, "BLS12_381": ec_bls12_381}


def curve_module(name):
    return get_curve_module(name, "cpu")


# ------------------------------------------------- tests/test_algebra.py --


def test_univariate_polynomial():
    for p in (BN254_SCALAR_FIELD, BLS12_381_SCALAR_FIELD):
        a = Polynomial([1, 2, 3], p)
        b = Polynomial([2, 3, 4], p)

        assert a + b == Polynomial([x + y for x, y in zip(a.coeffs(), b.coeffs())], p)
        assert b - a == Polynomial([x - y % p for x, y in zip(b.coeffs(), a.coeffs())], p)
        assert a * b == Polynomial([2, 7, 16, 17, 12], p)
        assert (a * b / a)[0] == b
        assert (a * b / b)[0] == a

        assert a + 5 == Polynomial([6, 2, 3], p)
        assert a - 1 == Polynomial([0, 2, 3], p)
        assert a * 2 == Polynomial([2, 4, 6], p)

        assert a(2) == (1 + 2 * 2 + 2**2 * 3) % p
        assert b(2) == (2 + 2 * 3 + 2**2 * 4) % p


def test_multivariate_polynomial():
    for p in (BN254_SCALAR_FIELD, BLS12_381_SCALAR_FIELD):
        a = Polynomial({(1, 0): 3, (0, 1): 2}, p)  # 3x + 2y
        b = Polynomial({(1, 0): 5, (0, 1): 7}, p)  # 5x + 7y

        assert a + b == Polynomial({(0, 1): 9, (1, 0): 8}, p)
        assert b - a == Polynomial({(0, 1): 5, (1, 0): 2}, p)
        assert a * b == Polynomial({(0, 2): 14, (1, 1): 31, (2, 0): 15}, p)

        assert a + 5 == Polynomial({(1, 0): 3, (0, 1): 2, (0, 0): 5}, p)
        assert a - 1 == Polynomial({(1, 0): 3, (0, 1): 2, (0, 0): p - 1}, p)
        assert a * 2 == Polynomial({(1, 0): 6, (0, 1): 4}, p)

        assert a([5, 10]) == (3 * 5 + 2 * 10) % p
        assert b([5, 10]) == (5 * 5 + 7 * 10) % p


def test_ntt_matches_direct_evaluation():
    """fft gives f(omega^i) in natural order, the JAX package's values."""
    for p in (BN254_SCALAR_FIELD, BLS12_381_SCALAR_FIELD):
        coeffs = [3, 1, 4, 1, 5, 9, 2, 6]
        evals = fft(coeffs, p, device="cpu")
        roots = get_all_evaluation_points(8, p)
        poly = Polynomial(coeffs, p)
        assert evals == [poly(w) for w in roots]
        assert ifft(evals, p, device="cpu") == coeffs
        assert evals == jax_poly.fft(coeffs, p)
        assert roots == jax_poly.get_all_evaluation_points(8, p)


def test_coset_fft_is_omega_offset():
    """The reference quirk: the coset offset is omega itself."""
    p = BN254_SCALAR_FIELD
    coeffs = [7, 0, 2, 5]
    roots = get_all_evaluation_points(4, p)
    omega = roots[1]
    poly = Polynomial(coeffs, p)
    evals = coset_fft(coeffs, p, device="cpu")
    assert evals == [poly(omega * w % p) for w in roots]
    assert coset_ifft(evals, p, device="cpu") == coeffs
    assert evals == jax_poly.coset_fft(coeffs, p)


def test_lagrange_and_vanishing():
    p = BN254_SCALAR_FIELD
    n = 8
    tau = 123456789
    coeffs = evaluate_lagrange_coefficients(n, tau, p)
    assert sum(coeffs) % p == 1
    roots = get_all_evaluation_points(n, p)
    poly = Polynomial([5, 4, 3, 2, 1], p)
    lhs = sum(c * poly(w) for c, w in zip(coeffs, roots)) % p
    assert lhs == poly(tau)
    assert evaluate_vanishing_polynomial(n, tau, p) == (pow(tau, n, p) - 1) % p
    assert coeffs == jax_poly.evaluate_lagrange_coefficients(n, tau, p)


def test_vanishing_poly_mul_div_roundtrip():
    p = BN254_SCALAR_FIELD
    f = Polynomial([1, 2, 3, 4], p)
    fz = f.multiply_by_vanishing_poly()
    q, r = fz.divide_by_vanishing_poly()
    assert r.is_zero()
    assert q == f
    assert fz.coeffs() == jax_poly.Polynomial([1, 2, 3, 4], p).multiply_by_vanishing_poly().coeffs()


# ------------------------------------------------ tests/test_symbolic.py --


@pytest.fixture
def x():
    return Var("x")


@pytest.fixture
def y():
    return Var("y")


@pytest.fixture
def z():
    return Var("z")


def test_eval(x, y, z):
    v1 = Var("v1")
    v2 = Var("v2")
    p = 71
    expr = x * v1 + 5 + (-y / v2) - z
    actual_result = (3 * 2 + 5 + (-5 * pow(4, -1, p)) - 3) % p
    assert expr.evaluate({"x": 3, "v1": 2, "y": 5, "v2": 4, "z": 3}, p) == actual_result


def test_complex_equation(x, y, z):
    expr1 = 2 * x + 3 * y + (-z)
    expr2 = 8 * x * (z + 4) * y / z - 12
    assert str(expr1) == "((x * 2 + y * 3) + -(z))"
    assert str(expr2) == "(x * 8 * (z + 4) * y / z - 12)"


def test_equation(x, y, z):
    p = 71
    eq1 = 7 == (1 * x) + (2 * y) + (4 * z)
    eq2 = z == 1337
    eq3 = x * y / z == y * x / z

    result1 = eq1.evaluate({"x": 1, "y": 1, "z": 1}, p)
    result2 = eq2.evaluate({"z": 1337}, p)
    result3 = eq3.evaluate({"x": 4, "y": 2, "z": 6}, p)

    assert result1[0] == result1[1]
    assert result2[0] == result2[1]
    assert result3[0] == result3[1]


# ----------------------------------------------- tests/test_r1cs_qap.py --


def _qap_values(front, qap_cls, build, curve, inputs, **qap_kw):
    """Build one package's circuit (build(front) -> cs), compile, solve;
    is_sat and the QAP's U, V, H coefficients."""
    cs = build(front)
    r1cs = front.R1CS(cs, curve)
    r1cs.compile()
    pub, priv = r1cs.generate_witness(cs.solve(inputs))
    qap = qap_cls(FIELDS[curve], **qap_kw)
    qap.from_r1cs(r1cs)
    U, V, _, H = qap.evaluate_witness(pub + priv)
    return r1cs.is_sat(pub, priv), [U.coeffs(), V.coeffs(), H.coeffs()]


def _check_qap(build, curve, inputs):
    """The port's R1CS is satisfied and its QAP equals the JAX package's."""
    sat, got = _qap_values(torch_front, QAP, build, curve, inputs, device="cpu")
    _, want = _qap_values(jax_front, JaxQAP, build, curve, inputs)
    assert sat
    assert got == want


def _basic_cs(front, field):
    x, y, v1 = front.Var("x"), front.Var("y"), front.Var("v1")
    cs = front.ConstraintSystem(["x"], ["y"], field)
    cs.add_constraint(v1 == x * x)
    cs.add_constraint(y - 5 - x == v1 * x)
    cs.set_public(y)
    return cs


def test_basic_r1cs_bn254():
    _check_qap(lambda f: _basic_cs(f, BN254_SCALAR_FIELD), "BN254", {"x": 3})


def test_basic_r1cs_bls12_381():
    _check_qap(lambda f: _basic_cs(f, BLS12_381_SCALAR_FIELD), "BLS12_381", {"x": 3})


def test_constraint_structure():
    def build(front):
        x, y = front.Var("x"), front.Var("y")
        v1, v2, v3, v4 = (front.Var(f"v{i}") for i in range(1, 5))
        cs = front.ConstraintSystem(["x"], ["y"], BN254_SCALAR_FIELD)
        cs.add_constraint(v1 == x * x)
        cs.add_constraint(v2 == v1 + x)
        cs.add_constraint(v1 + v2 == v3)
        cs.add_constraint(v4 == (v1 + v2) / (168696 * v3 + 1))
        cs.add_constraint(v1 + v2 + v3 + v4 == y)
        cs.set_public(y)
        return cs

    _check_qap(build, "BN254", {"x": 3})


def test_r1cs_loop_constraint():
    def build(front):
        n_power = 64
        inp, out = front.Var("inp"), front.Var("out")
        v = [front.Var(f"v{i}") for i in range(n_power - 1)]
        cs = front.ConstraintSystem(["inp"], ["out"], BN254_SCALAR_FIELD)
        cs.add_constraint(v[0] == inp * inp)
        for i in range(1, n_power - 1):
            cs.add_constraint(v[i] == v[i - 1] * inp)
        cs.add_constraint(out == v[n_power - 2])
        cs.set_public(out)
        return cs

    _check_qap(build, "BN254", {"inp": 2})


# --------------------------------------------------- tests/test_curves.py --


@pytest.mark.parametrize("name", CURVES)
def test_group_laws(name):
    mod = curve_module(name)
    G1, G2 = mod.g1(), mod.g2()
    assert (G1 * 2) + G1 == G1 * 3
    assert (G2 * 5) - (G2 * 3) == G2 * 2
    assert (G1 * 0).is_zero()
    assert (G1 + type(G1).identity()) == G1
    assert (G1 - G1).is_zero()
    assert G1 * (mod._curve.r + 7) == G1 * 7


@pytest.mark.parametrize("name", CURVES)
def test_serialization_roundtrip(name):
    mod, jmod = curve_module(name), JAX_MODULES[name]
    G1, G2 = mod.g1(), mod.g2()
    J1, J2 = jmod.g1(), jmod.g2()
    pairs = ((G1 * 1337, J1 * 1337), (type(G1).identity(), type(J1).identity()),
             (G2 * 133337, J2 * 133337), (type(G2).identity(), type(J2).identity()))
    for P, J in pairs:
        b = bytes(P.to_bytes())
        assert type(P).from_bytes(b) == P
        assert b == bytes(J.to_bytes())
    assert bytes(type(G1).identity().to_bytes())[-1] & 0x40


@pytest.mark.parametrize("name", CURVES)
def test_pairing_bilinearity(name):
    mod = curve_module(name)
    G1, G2 = mod.g1(), mod.g2()
    e = mod.pairing
    lhs = e(G1 * 6, G2 * 7)
    assert lhs == e(G1 * 42, G2)
    assert lhs == e(G1, G2 * 42)
    assert lhs != e(G1 * 41, G2)
    assert mod.multi_pairing([G1 * 2, G1 * 3], [G2 * 5, G2 * 10]) == e(G1 * 40, G2)
    assert mod.multi_pairing([G1 * 40, type(G1).identity()], [G2, G2 * 9]) == e(G1 * 40, G2)


def test_bn254_known_coordinates():
    G1 = curve_module("BN254").g1()
    assert (G1.x, G1.y) == (1, 2)
    P = G1 * 2
    assert P.x == 1368015179489954701390400359078579693043519447331113978918064868415326638035
    assert P.y == 9918110051302171585080402603319702774565515993150576347155970296011118125764


def test_from_x():
    mod = curve_module("BN254")
    P = mod.g1() * 12345
    Q = mod.PointG1.from_x(P.x)
    assert Q.x == P.x
    assert Q in (P, -P)
    assert bytes(Q.to_bytes()) == bytes(ec_bn254.PointG1.from_x(P.x).to_bytes())


# -------------------------------------------------- tests/test_groth16.py --


def _basic_r1cs(curve):
    r1cs = R1CS(_basic_cs(torch_front, FIELDS[curve]), curve)
    r1cs.compile()
    return r1cs


def test_unused_public_input():
    x, y, v1, unused = Var("x"), Var("y"), Var("v1"), Var("unused")
    cs = ConstraintSystem(["x", "unused"], ["y"], BN254_SCALAR_FIELD)
    cs.add_constraint(v1 == x * x)
    cs.add_constraint(y - 5 - x == v1 * x)
    cs.add_constraint(unused * 0 == 0)
    cs.set_public(unused)
    cs.set_public(y)
    r1cs = R1CS(cs)
    r1cs.compile()
    pub, priv = r1cs.generate_witness(r1cs.solve({"x": 3, "unused": 1337}))

    groth16 = Groth16(r1cs, device="cpu")
    groth16.setup()
    proof = groth16.prove(pub, priv)

    # the same proof against a forged public witness
    assert groth16.verify(proof, pub)
    pub[2] = 1330000000
    assert groth16.verify(proof, pub) is False


@pytest.mark.parametrize("curve", CURVES)
def test_proof_serialization(curve):
    E, J = EllipticCurve(curve, "cpu"), JaxEllipticCurve(curve)
    proof1 = Proof(E.G1() * 1337, E.G2() * 133337, E.G1() * 1333337)
    data = proof1.to_bytes()
    proof2 = Proof.from_bytes(data, curve)
    assert str(proof1) == str(proof2)
    assert data == JaxProof(J.G1() * 1337, J.G2() * 133337, J.G1() * 1333337).to_bytes()


@pytest.mark.parametrize("curve", CURVES)
def test_key_serialization(curve):
    """Round trips of the port's keys, whose bytes equal the JAX package's
    host setup under the same toxic waste."""
    waste = (0xA11CE, 0xB0B, 0xCAFE, 0xD00D, 0xE66)
    g16 = Groth16(_basic_r1cs(curve), curve, device="cpu")
    g16._setup_from_waste(*waste)
    pk, vk = g16.proving_key, g16.verifying_key

    pk_bytes = pk.to_bytes()
    assert ProvingKey.from_bytes(pk_bytes, crv=curve).to_bytes() == pk_bytes
    vk_bytes = vk.to_bytes()
    assert VerifyingKey.from_bytes(vk_bytes, crv=curve).to_bytes() == vk_bytes

    jr1cs = jax_front.R1CS(_basic_cs(jax_front, FIELDS[curve]), curve)
    jr1cs.compile()
    ref = JaxGroth16(jr1cs, curve)
    ref._setup_from_waste(*waste, force_host=True)
    assert pk_bytes == ref.proving_key.to_bytes()
    assert vk_bytes == ref.verifying_key.to_bytes()


# ---------------------------------------------------- tests/test_plonk.py --


def _plonk_cs(front, field):
    Var_ = front.Var
    x, y, z = Var_("x"), Var_("y"), Var_("z")
    v = [Var_(f"v{i}") for i in range(7)]
    cs = front.ConstraintSystem(["x"], ["y"], field)
    cs.add_constraint(z == x)
    cs.add_constraint(v[0] == z * z)
    cs.add_constraint(v[1] == z * z)
    cs.add_constraint(v[2] == v[1] * x)
    cs.add_constraint(v[3] == v[0] * 2 * 3)
    cs.add_constraint(v[4] == 2 * v[1] * v[2] * 3)
    cs.add_constraint(v[5] == 2 * v[3] - v[4])
    cs.add_constraint(v[6] == 2 + v[5] + 3)
    cs.add_constraint(y == v[6] + v[4] + 1337)
    cs.set_public(y)
    cs.set_public(z)
    return cs


@pytest.mark.parametrize("curve", CURVES)
def test_plonk_key_serialization(curve, monkeypatch):
    """Round trips of the port's PlonK keys, whose bytes equal the JAX
    package's under one seeded randomness stream."""
    def keys(front, plonk_cls, protocol, **kw):
        rng = random.Random(f"host-layer-{curve}")
        monkeypatch.setattr(protocol, "get_random_int", lambda n_max: 1 + rng.randrange(n_max))
        plonkish = front.Plonkish(_plonk_cs(front, FIELDS[curve]), curve)
        plonkish.compile()
        plonk = plonk_cls(plonkish, curve, **kw)
        plonk.setup()
        return plonk.proving_key, plonk.verifying_key

    pk, vk = keys(torch_front, Plonk, plonk_protocol, device="cpu")
    assert PlonkProvingKey.from_bytes(pk.to_bytes(), curve).to_bytes() == pk.to_bytes()
    assert PlonkVerifyingKey.from_bytes(vk.to_bytes(), curve).to_bytes() == vk.to_bytes()

    jpk, jvk = keys(jax_front, JaxPlonk, jax_plonk_protocol)
    assert pk.to_bytes() == jpk.to_bytes()
    assert vk.to_bytes() == jvk.to_bytes()
