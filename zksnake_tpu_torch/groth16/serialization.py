"""Groth16 wire formats (Proof / ProvingKey / VerifyingKey).

Byte-format parity with
upstream zksnake: python/zksnake/groth16/serialization.py: compressed arkworks
points; Proof = A|B|C (4n bytes); PK = fixed header (alpha, beta2, delta2,
beta1, delta1) + length-prefixed tau1/tau2/target1/kdelta1 vectors;
VK = alpha, beta2, gamma2, delta2 + IC vector. Implemented on the shared
ByteReader/ByteWriter codec.
"""

from ..ecc import curve_spec
from ..wireformat import ByteReader, ByteWriter


class Proof:
    def __init__(self, A, B, C):
        self.A = A
        self.B = B
        self.C = C

    def __str__(self):
        return f"A = {self.A}\nB = {self.B}\nC = {self.C}"

    __repr__ = __str__

    def to_bytes(self) -> bytes:
        return ByteWriter().point(self.A).point(self.B).point(self.C).getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        expect = 4 * curve_spec(crv).point_bytes
        if len(raw) != expect:
            raise ValueError(f"Length of the Proof must equal {expect} bytes")
        r = ByteReader(raw, crv)
        return cls(r.g1(), r.g2(), r.g1())


class ProvingKey:
    def __init__(self, alpha_G1, beta_G1, beta_G2, delta_G1, delta_G2,
                 tau_G1, tau_G2, target_G1, k_delta_G1):
        self.alpha_1 = alpha_G1
        self.beta_1 = beta_G1
        self.beta_2 = beta_G2
        self.delta_1 = delta_G1
        self.delta_2 = delta_G2
        self.tau_1 = tau_G1
        self.tau_2 = tau_G2
        self.target_1 = target_G1
        self.kdelta_1 = k_delta_G1

    def to_bytes(self) -> bytes:
        w = ByteWriter()
        for p in (self.alpha_1, self.beta_2, self.delta_2, self.beta_1, self.delta_1):
            w.point(p)
        for vec in (self.tau_1, self.tau_2, self.target_1, self.kdelta_1):
            w.point_vec(vec)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        r = ByteReader(raw, crv)
        if len(raw) < 7 * r.g1_len:
            raise ValueError("Invalid proving key length")
        alpha_1 = r.g1()
        beta_2 = r.g2()
        delta_2 = r.g2()
        beta_1 = r.g1()
        delta_1 = r.g1()
        tau_1 = r.g1_vec()
        tau_2 = r.g2_vec()
        target_1 = r.g1_vec()
        kdelta_1 = r.g1_vec()
        return cls(
            alpha_1, beta_1, beta_2, delta_1, delta_2,
            tau_1, tau_2, target_1, kdelta_1,
        )


class VerifyingKey:
    def __init__(self, alpha_G1, beta_G2, gamma_G2, delta_G2, IC):
        self.alpha_1 = alpha_G1
        self.beta_2 = beta_G2
        self.gamma_2 = gamma_G2
        self.delta_2 = delta_G2
        self.ic = IC

    def to_bytes(self) -> bytes:
        w = ByteWriter()
        w.point(self.alpha_1).point(self.beta_2).point(self.gamma_2).point(self.delta_2)
        w.point_vec(self.ic)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        r = ByteReader(raw, crv)
        if len(raw) < 7 * r.g1_len:
            raise ValueError("Invalid verifying key length")
        return cls(r.g1(), r.g2(), r.g2(), r.g2(), r.g1_vec())
