"""R1CS wrapper: symbolic constraint system -> sparse A/B/C matrices.

Behavioral parity with upstream zksnake: python/zksnake/arithmetization/r1cs.py
(canonical witness ordering [1, outputs, public, private, intermediates],
Circom import path, Az o Bz == Cz satisfiability). Original implementation on
top of the rebuilt compiler (r1cs_compiler.py) and SparseArray.
"""

from __future__ import annotations

from ..array import SparseArray
from ..ecc import curve_spec


class R1CS:
    def __init__(self, cs, curve: str = "BN254"):
        self.constraint_system = cs
        self.p = curve_spec(curve).scalar_order
        self.n_public = len(cs.public_vars) + 1
        self.A = None
        self.B = None
        self.C = None

    def compile(self):
        """Compile the constraint system into the three sparse matrices."""
        rows = self.constraint_system.compile_to_r1cs()
        shape = (
            self.constraint_system.num_constraints(),
            self.constraint_system.num_witness() + 1,
        )
        matrices = [SparseArray([[]], *shape, self.p) for _ in range(3)]
        for row in rows:
            for matrix, triplets in zip(matrices, row):
                matrix.append(triplets)
        self.A, self.B, self.C = matrices

    def solve(self, inputs: dict) -> dict:
        """Run the witness solver over the given inputs."""
        return self.constraint_system.solve(inputs)

    def generate_witness(self, solve_result: dict):
        """Assemble the full witness in canonical order and split it at the
        public boundary. The constant wire "0" maps to 1."""
        witness = []
        for entry in self.constraint_system.get_witness_vector():
            if entry == "0":
                witness.append(1)
            elif isinstance(entry, str):
                witness.append(solve_result[entry] % self.p)
            else:
                witness.append(entry % self.p)
        return witness[: self.n_public], witness[self.n_public :]

    def is_sat(self, public_witness: list, private_witness: list) -> bool:
        """Hadamard check: (A w) o (B w) == C w element-wise mod p."""
        if self.A is None:
            raise RuntimeError("R1CS is not compiled")
        w = public_witness + private_witness
        lhs = [
            az * bz % self.p for az, bz in zip(self.A.dot(w), self.B.dot(w))
        ]
        return lhs == self.C.dot(w)

    def to_bytes(self):
        raise NotImplementedError

    @classmethod
    def from_bytes(cls, data):
        raise NotImplementedError

    @classmethod
    def from_file(cls, r1csfile: str, symfile: str = None, curve: str = "BN254"):
        """Import a Circom circuit (.r1cs binary + optional .sym map)."""
        from ..parser import R1CSReader
        from .symbolic import ConstraintSystem

        parsed = R1CSReader(r1csfile, symfile).read()
        header = parsed["header"]
        wires = parsed["wires"]

        # circom wire layout: [1, outputs, public inputs, private inputs, ...]
        out_end = 1 + header["n_pub_out"]
        pub_end = out_end + header["n_pub_in"]
        priv_end = pub_end + header["n_priv_in"]
        outputs = wires[1:out_end]
        pub_inputs = wires[out_end:pub_end]
        priv_inputs = wires[pub_end:priv_end]

        cs = ConstraintSystem(
            [str(v) for v in pub_inputs + priv_inputs],
            [str(v) for v in outputs],
            curve_spec(curve).scalar_order,
        )
        for wire in wires[1:]:
            cs.add_variable(wire)
        cs.set_public(outputs)
        cs.set_public(pub_inputs)
        for equation in parsed["constraints"]:
            cs.add_constraint(equation)

        return cls(cs, curve)
