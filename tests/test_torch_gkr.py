"""GKR on the PyTorch port against the JAX package, over BN254 and
BLS12-381.

The three circuits of tests/test_gkr.py and one wider layered circuit are
built through each package's own LayeredCircuit from the same gate list,
proved with the same seeded inputs, and compared as ints (exact): the
outputs, every layer's round polynomials and its (q, z1, z2). The port runs
on device="cpu"; GKR's selectors are sparse, so both packages walk them on
the host.
"""

import random

import pytest
import torch

from zksnake_tpu.arithmetization import LayeredCircuit as JaxLayeredCircuit
from zksnake_tpu.constant import BN254_SCALAR_FIELD
from zksnake_tpu.subprotocol.gkr import GKR as JaxGKR
from zksnake_tpu_torch.arithmetization import LayeredCircuit
from zksnake_tpu_torch.polynomial import Polynomial
from zksnake_tpu_torch.subprotocol.gkr import GKR

from torch_support import CURVES, FIELDS

# tests/test_gkr.py's circuits as (inputs, layers of (gate, lhs, rhs, out))
CIRCUITS = {
    "add_mul": (["x", "y"], [[("ADD", "x", "y", "z")], [("MUL", "z", "z", "zz")]]),
    "three_layers": (["x", "y", "u", "v"], [
        [("ADD", "x", "y", "z1"), ("MUL", "x", "y", "z2"), ("MUL", "x", "y", "z3"),
         ("MUL", "u", "v", "w"), ("ADD", "x", "x", "xx")],
        [("MUL", "z1", "z2", "zz"), ("MUL", "z1", "z3", "zzz"), ("MUL", "w", "w", "ww"),
         ("ADD", "xx", "xx", "xxx")],
        [("ADD", "zzz", "zz", "a"), ("MUL", "zzz", "ww", "b"), ("MUL", "xxx", "xxx", "xxxx")],
    ]),
    "squares": (["a1", "a2", "a3", "a4"], [
        [("MUL", "a1", "a1", "b1"), ("MUL", "a2", "a2", "b2"), ("MUL", "a2", "a3", "b3"),
         ("MUL", "a4", "a4", "b4")],
        [("MUL", "b1", "b2", "c1"), ("MUL", "b3", "b4", "c2")],
    ]),
}


def wide_circuit(width, depth, seed):
    """`width` gates a layer, `depth` layers; gate k reads wire k of the
    layer below and a random wire at or before it, so every wire is used and
    the wires feed in gate order (the order GKR's layer values take)."""
    rng = random.Random(seed)
    inputs = [f"i{k}" for k in range(width)]
    layers, below = [], inputs
    for d in range(depth):
        outs = [f"w{d}_{k}" for k in range(width)]
        layers.append([(rng.choice(["ADD", "MUL"]), below[k], below[rng.randrange(k + 1)], o)
                       for k, o in enumerate(outs)])
        below = outs
    return inputs, layers


def build(cls, inputs, layers):
    circuit = cls(list(inputs))
    for i, layer in enumerate(layers):
        if i:
            circuit.add_layer()
        for gate in layer:
            circuit.add_gate(*gate)
    return circuit


def proof_ints(proof):
    """Every layer's round coefficients, then q's coefficients, z1, z2."""
    return [[u.coeffs() for u in layer[:-1]]
            + [layer[-1][0].coeffs(), layer[-1][1], layer[-1][2]] for layer in proof]


@pytest.mark.parametrize("name", [*CIRCUITS, "wide_8x3"])
@pytest.mark.parametrize("curve", CURVES)
def test_gkr_matches_jax(curve, name):
    p = FIELDS[curve]
    inputs, layers = CIRCUITS[name] if name in CIRCUITS else wide_circuit(8, 3, name)
    rng = random.Random(f"gkr-{curve}-{name}")
    inp = {k: rng.randrange(1, p - 1) for k in inputs}

    ref = JaxGKR(build(JaxLayeredCircuit, inputs, layers), p)
    want_out, want_proof = ref.prove(dict(inp))
    gkr = GKR(build(LayeredCircuit, inputs, layers), p, device="cpu")
    out, proof = gkr.prove(dict(inp))

    assert out == want_out
    assert proof_ints(proof) == proof_ints(want_proof)
    assert gkr.verify(inp, out, proof)
    # a tampered claim on the last layer's line is rejected
    q, z1, z2 = proof[-1][-1]
    bad = [list(layer) for layer in proof]
    bad[-1][-1] = (q + Polynomial([1], p), (z1 + 1) % p, (z2 + 1) % p)
    assert not gkr.verify(inp, out, bad)
    # and so is a wrong output
    wrong = dict(out)
    first = next(iter(wrong))
    wrong[first] = (wrong[first] + 1) % p
    assert not gkr.verify(inp, wrong, proof)


def test_layered_circuit_rules_match_jax():
    for cls in (LayeredCircuit, JaxLayeredCircuit):
        c = cls(["x", "y"])
        with pytest.raises(ValueError):
            c.add_gate("SUB", "x", "y", "z")
        with pytest.raises(ValueError):
            c.add_gate("ADD", "x", "q", "z")
        c.add_gate("ADD", "x", "y", "z")
        c.add_layer()
        with pytest.raises(ValueError):
            c.add_gate("MUL", "x", "z", "zz")  # x is not in the layer below
        with pytest.raises(ValueError):
            c.evaluate({"x": 1}, BN254_SCALAR_FIELD)
    inputs, layers = CIRCUITS["three_layers"]
    mine, ref = build(LayeredCircuit, inputs, layers), build(JaxLayeredCircuit, inputs, layers)
    assert mine.get_wire_label() == ref.get_wire_label()
    vals = {k: i + 2 for i, k in enumerate(inputs)}
    assert mine.evaluate(vals, BN254_SCALAR_FIELD) == ref.evaluate(vals, BN254_SCALAR_FIELD)


def test_cuda_device_is_never_swapped_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inputs, layers = CIRCUITS["add_mul"]
    with pytest.raises(RuntimeError, match="CUDA"):
        GKR(build(LayeredCircuit, inputs, layers), BN254_SCALAR_FIELD)
