"""Plonkish wrapper: symbolic constraint system -> selector vectors + wires.

Behavioral parity with
upstream zksnake: python/zksnake/arithmetization/plonkish.py (selector padding
to the next power of two, public-input extraction as negated gate constants,
gate + copy-constraint satisfiability). Original implementation on top of the
rebuilt compiler (plonkish_compiler.py). Copy of
zksnake_tpu/arithmetization/plonkish.py; the field order comes from the
curve registry instead of a curve handle.
"""

from __future__ import annotations

from ..ecc import curve_spec
from ..utils import next_power_of_two

SELECTORS = ("qL", "qR", "qO", "qM", "qC")


class Plonkish:
    def __init__(self, cs, curve: str = "BN254"):
        self.constraint_system = cs
        self.p = curve_spec(curve).scalar_order
        self.unpadded_length = cs.num_constraints()
        self.length = next_power_of_two(self.unpadded_length)
        for name in SELECTORS:
            setattr(self, name, None)
        self.witness_map = []
        self.permutation = []

    def compile(self):
        """Compile into per-gate selectors (padded to a power of two), the
        3-per-gate wire-name map, and the copy-constraint permutation."""
        gates, permutation = self.constraint_system.compile_to_plonkish()

        columns = [[] for _ in SELECTORS]
        witness_map = []
        for gate in gates:
            for col, value in zip(columns, gate[:5]):
                col.append(value)
            witness_map.extend(gate[5])

        pad = self.length - len(gates)
        for name, col in zip(SELECTORS, columns):
            setattr(self, name, col + [0] * pad)
        self.witness_map = witness_map
        self.permutation = permutation

    def solve(self, inputs: dict) -> dict:
        return self.constraint_system.solve(inputs)

    def generate_witness(self, solve_result: dict):
        """Flatten the solved values into the [a, b, c] * n wire vector.
        Output wires bound to public variables become public inputs
        (recorded as -value mod p at their gate index) and zero out the
        private slot."""
        public_vars = self.constraint_system.public_vars
        pi = {}
        flat = []
        for gate_idx in range(0, len(self.witness_map), 3):
            name_a, name_b, name_c = self.witness_map[gate_idx : gate_idx + 3]
            flat.append(solve_result[name_a] if name_a else 0)
            flat.append(solve_result[name_b] if name_b else 0)
            if name_c in public_vars:
                pi[gate_idx // 3] = -solve_result[name_c] % self.p
                flat.append(0)
            else:
                flat.append(solve_result[name_c] if name_c else 0)
        return pi, flat

    def is_sat(self, public_witness: dict, private_witness: list) -> bool:
        a = private_witness[0::3]
        b = private_witness[1::3]
        c = private_witness[2::3]

        # gate equations
        for i in range(self.unpadded_length):
            pi = public_witness.get(i) or 0
            gate = (
                self.qL[i] * a[i]
                + self.qR[i] * b[i]
                + self.qM[i] * a[i] * b[i]
                + self.qO[i] * c[i]
                + self.qC[i]
                + pi
            )
            if gate % self.p:
                return False

        # copy constraints over the flattened (a | b | c) slots
        pad = [0] * (self.length - len(a))
        flat = a + pad + b + pad + c + pad
        return all(flat[src] == flat[dst] for src, dst in enumerate(self.permutation))

    def to_bytes(self):
        raise NotImplementedError

    @classmethod
    def from_bytes(cls, data):
        raise NotImplementedError
