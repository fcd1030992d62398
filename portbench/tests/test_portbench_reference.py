"""The plain reference: it imports nothing of the port, lays the circuit out
as the port does, encodes points as the port does, and its control (the
reference without the blinding in the program's place) fails the
comparison."""

import ast
import glob
import os

import pytest

from portbench import control, harness, seeds
from portbench.reference import bn254

REF_DIR = os.path.join(harness.HERE, "reference")
STDLIB = {"hashlib"}


def test_reference_imports_nothing_but_itself_and_the_standard_library():
    for path in glob.glob(os.path.join(REF_DIR, "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in STDLIB, f"{path} imports {name}"


def _config(bench, workload, log2):
    _, cfg, _ = harness.find_cell(bench, workload)
    return dict(cfg, log2_size=log2)


@pytest.mark.parametrize("workload", ["g16-bn254-2e16.stream", "plonk-bn254-2e14.stream"])
@pytest.mark.parametrize("log2", [4, 6])
def test_reference_circuit_is_laid_out_as_the_port_lays_it_out(bench, workload, log2):
    assert control.layout(_config(bench, workload, log2), seed=2**31 + 7)


def test_point_encoding_matches_the_port():
    from zksnake_tpu_torch.ecc import EllipticCurve

    E = EllipticCurve("BN254", "cpu")
    for k in (1, 2, 3, bn254.R - 1, 0, 2**200 + 12345):
        assert bn254.g1_bytes(k) == bytes((E.G1() * k).to_bytes())
        assert bn254.g2_bytes(k) == bytes((E.G2() * k).to_bytes())


@pytest.mark.parametrize("workload", ["g16-bn254-2e16.stream", "plonk-bn254-2e14.stream"])
def test_control_fails_the_comparison_and_the_reference_passes_it(bench, workload):
    cfg = _config(bench, workload, 4)
    proto_mod = harness.module("protocols", cfg["protocol"])
    for seed in (1, 2**31 + 3, 2**33 + 5):
        protocol = proto_mod.Protocol(cfg, seed, "cpu")
        records = [(k, 0.0, None) for k in range(1, 4)]
        ctrl = harness.check(protocol, None, records, seed, control=True)
        assert ctrl["checked"] == 3 and len(ctrl["wrong"]) == 3
        assert ctrl["mismatched"] >= 3
        sound = [(k, 0.0, protocol.expected(k)) for k in range(1, 4)]
        protocol.elements = lambda proof: proof
        assert harness.check(protocol, None, sound, seed)["mismatched"] == 0


def test_seed_streams_are_fixed_by_the_seed():
    big = 2**31 + 12345
    assert seeds.protocol_draws(big, 1000, 5) == seeds.protocol_draws(big, 1000, 5)
    assert seeds.protocol_draws(big, 1000, 5) != seeds.protocol_draws(big + 1, 1000, 5)
    assert seeds.sample(big, range(10), 3) == seeds.sample(big, range(10), 3)
    assert seeds.sample(big, range(2), 3) == [0, 1]
