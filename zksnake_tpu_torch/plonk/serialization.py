"""PlonK wire formats (Proof / ProvingKey / VerifyingKey).

Byte-format parity with upstream zksnake: python/zksnake/plonk/serialization.py:
Proof = 9 compressed points + 6 32-byte LE scalars; PK = length-prefixed
tau_g1 vector + 8 commitment points + 17 LE length-prefixed scalar vectors
(5 selector polys, 3 permutation polys, 3 identity polys, 5 selector eval
tables, L1 evals); VK = n (u64) + [tau]_2 + the 8 commitment points.
Implemented on the shared ByteReader/ByteWriter codec. Copy of
zksnake_tpu/plonk/serialization.py; the keys read their field order from
the curve registry instead of holding a curve handle.
"""

from ..ecc import curve_spec
from ..polynomial import Polynomial
from ..wireformat import ByteReader, ByteWriter

SELECTOR_KEYS = ("L", "R", "O", "M", "C")

_PROOF_POINTS = (
    "tau_a", "tau_b", "tau_c", "tau_z",
    "tau_t_lo", "tau_t_mid", "tau_t_hi",
    "tau_W_zeta", "tau_W_zeta_omega",
)
_PROOF_SCALARS = (
    "zeta_a", "zeta_b", "zeta_c", "zeta_sigma1", "zeta_sigma2", "zeta_omega"
)


class Proof:
    def __init__(self, *values):
        names = _PROOF_POINTS + _PROOF_SCALARS
        if len(values) != len(names):
            raise TypeError(f"Proof takes {len(names)} arguments")
        for name, value in zip(names, values):
            setattr(self, name, value)

    def to_bytes(self) -> bytes:
        w = ByteWriter()
        for name in _PROOF_POINTS:
            w.point(getattr(self, name))
        for name in _PROOF_SCALARS:
            w.scalar(getattr(self, name))
        return w.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        r = ByteReader(raw, crv)
        expect = 9 * r.g1_len + 6 * 32
        if len(raw) != expect:
            raise ValueError(f"Length of the Proof must equal {expect} bytes")
        points = [r.g1() for _ in _PROOF_POINTS]
        scalars = [r.scalar() for _ in _PROOF_SCALARS]
        return cls(*points, *scalars)


class ProvingKey:
    def __init__(self, n, tau_G1, selector_poly, selector_eval,
                 permutation_poly, identity_poly, tau_selector,
                 tau_permutation, lagrange_evals, curve: str = "BN254"):
        self.order = curve_spec(curve).scalar_order
        self.n = n
        self.tau_g1 = tau_G1
        self.selector_poly = selector_poly
        self.selector_eval = selector_eval
        self.permutation_poly = permutation_poly
        self.identity_poly = identity_poly
        self.tau_selector_poly = tau_selector
        self.tau_permutation_poly = tau_permutation
        self.lagrange_evals = lagrange_evals

    def to_bytes(self) -> bytes:
        w = ByteWriter()
        w.point_vec(self.tau_g1)
        for key in SELECTOR_KEYS:
            w.point(self.tau_selector_poly[key])
        for point in self.tau_permutation_poly:
            w.point(point)
        coeff_vectors = (
            [self.selector_poly[k].coeffs() for k in SELECTOR_KEYS]
            + [poly.coeffs() for poly in self.permutation_poly]
            + [poly.coeffs() for poly in self.identity_poly]
            + [self.selector_eval[k] for k in SELECTOR_KEYS]
            + [self.lagrange_evals]
        )
        for vec in coeff_vectors:
            w.scalar_vec(vec)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        r = ByteReader(raw, crv)
        tau_g1 = r.g1_vec()
        tau_selector = {k: r.g1() for k in SELECTOR_KEYS}
        tau_permutation = [r.g1() for _ in range(3)]

        vectors = []
        while r.remaining():
            vectors.append(r.scalar_vec())
        if len(vectors) != 17:
            raise ValueError("Malformed ProvingKey structure")

        order = curve_spec(crv).scalar_order
        selector_poly = {
            k: Polynomial(vectors[i], order) for i, k in enumerate(SELECTOR_KEYS)
        }
        permutation_poly = [Polynomial(v, order) for v in vectors[5:8]]
        identity_poly = [Polynomial(v, order) for v in vectors[8:11]]
        selector_eval = {k: vectors[11 + i] for i, k in enumerate(SELECTOR_KEYS)}
        lagrange_evals = vectors[16]

        return cls(
            len(vectors[0]), tau_g1, selector_poly, selector_eval,
            permutation_poly, identity_poly, tau_selector, tau_permutation,
            lagrange_evals, crv,
        )


class VerifyingKey:
    def __init__(self, n, tau_G2, tau_selector_poly, tau_permutation_poly,
                 curve: str = "BN254"):
        self.order = curve_spec(curve).scalar_order
        self.n = n
        self.tau_g2 = tau_G2
        self.tau_selector_poly = tau_selector_poly
        self.tau_permutation_poly = tau_permutation_poly

    def to_bytes(self) -> bytes:
        w = ByteWriter()
        w.u64(self.n)
        w.point(self.tau_g2)
        for key in SELECTOR_KEYS:
            w.point(self.tau_selector_poly[key])
        for point in self.tau_permutation_poly:
            w.point(point)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        r = ByteReader(raw, crv)
        n = r.u64()
        tau_g2 = r.g2()
        tau_selector = {k: r.g1() for k in SELECTOR_KEYS}
        tau_permutation = [r.g1() for _ in range(3)]
        return cls(n, tau_g2, tau_selector, tau_permutation, crv)
