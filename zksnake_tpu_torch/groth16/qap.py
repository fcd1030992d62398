"""R1CS -> QAP transformation.

Behavioral parity with upstream zksnake: python/zksnake/groth16/qap.py: the
evaluation domain is padded to next_pow2(n_constraints) by widening the
sparse matrices' row counts (:32-40), and witness evaluation interpolates
Az/Bz/Cz by iNTT, multiplies U*V over an FFT domain, and divides by the
vanishing polynomial (:53-69). Original implementation; on large domains
every step here dispatches to the device NTT on the QAP's torch `device`,
and the fused device prover (backend.groth16_device) bypasses this class's
witness evaluation entirely.
"""

from ..arithmetization.r1cs import R1CS
from ..constant import BN254_SCALAR_FIELD
from ..polynomial import Polynomial, ifft, mul_over_fft
from ..utils import next_power_of_two


class QAP:
    def __init__(self, p=None, device="cuda"):
        self.p = p or BN254_SCALAR_FIELD
        self.device = device
        self.a = []
        self.b = []
        self.c = []
        self.n_public = 0

    def from_r1cs(self, r1cs: R1CS):
        """Adopt the R1CS matrices, widening rows to a power-of-two domain."""
        if r1cs.A is None:
            raise RuntimeError("R1CS is not compiled")
        self.n_public = r1cs.n_public
        domain = next_power_of_two(r1cs.A.n_row)
        self.a, self.b, self.c = r1cs.A, r1cs.B, r1cs.C
        for matrix in (self.a, self.b, self.c):
            matrix.n_row = domain

    def evaluate_witness(self, witness: list):
        """U, V, W, H with U*V - W = H*Z over the padded domain."""
        dev = self.device
        u = Polynomial(ifft(self.a.dot(witness), self.p, device=dev), self.p)
        v = Polynomial(ifft(self.b.dot(witness), self.p, device=dev), self.p)
        w = Polynomial(ifft(self.c.dot(witness), self.p, device=dev), self.p)

        uv = mul_over_fft(self.a.n_row, u, v, self.p, device=dev)
        h, remainder = (uv - w).divide_by_vanishing_poly()
        if not remainder.is_zero():
            raise ValueError("(U * V - W) did not divided by Z to zero")
        return u, v, w, h
