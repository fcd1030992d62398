"""The benchmark circuit through the port's front end: the multiplication
chain out = inp^n_power as R1CS (Groth16) and as Plonkish gates (PlonK).

Frozen copies of chip_smoke.py::_mult_chain and ::_plonk_chain, which also
solve for one witness; the benchmark makes its witnesses itself
(reference/chain.py), so these stop at the compiled circuit.
"""


def _scalar_field(curve):
    from zksnake_tpu_torch import BLS12_381_SCALAR_FIELD, BN254_SCALAR_FIELD

    return {"BN254": BN254_SCALAR_FIELD, "BLS12_381": BLS12_381_SCALAR_FIELD}[curve]


def _chain_system(n_power, curve):
    from zksnake_tpu_torch import ConstraintSystem, Var

    inp, out = Var("inp"), Var("out")
    v = [Var(f"v{i}") for i in range(n_power - 1)]
    cs = ConstraintSystem(["inp"], ["out"], _scalar_field(curve))
    cs.add_constraint(v[0] == inp * inp)
    for i in range(1, n_power - 1):
        cs.add_constraint(v[i] == v[i - 1] * inp)
    cs.add_constraint(out == v[n_power - 2])
    cs.set_public(out)
    return cs


def mult_chain(n_power, curve):
    """(constraint system, compiled R1CS) of out = inp^n_power, out public
    (chip_smoke.py::_mult_chain)."""
    from zksnake_tpu_torch import R1CS

    cs = _chain_system(n_power, curve)
    r1cs = R1CS(cs, curve)
    r1cs.compile()
    return cs, r1cs


def plonk_chain(n_power, curve):
    """(constraint system, compiled Plonkish) of the same chain as gates;
    Plonkish.length is n_power (chip_smoke.py::_plonk_chain)."""
    from zksnake_tpu_torch.arithmetization import Plonkish

    cs = _chain_system(n_power, curve)
    plonkish = Plonkish(cs, curve)
    plonkish.compile()
    return cs, plonkish
