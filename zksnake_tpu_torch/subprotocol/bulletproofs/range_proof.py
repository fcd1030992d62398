"""Bulletproofs range proof: v in [0, 2^n) over a Pedersen commitment.

Role parity with
upstream zksnake: python/zksnake/subprotocol/bulletproofs/range_proof.py:
identical transcript schedule and wire format (5 compressed points, 3
little-endian 32-byte scalars, then the IPA proof). Original implementation;
l(x)/r(x) are evaluated directly from their degree-1 coefficient vectors
instead of materializing n Polynomial objects, and the verifier's single
aggregated MSM rides the torch dispatch.

Copy of zksnake_tpu/subprotocol/bulletproofs/range_proof.py with the port's
imports and a `device` ("cuda" unless the caller asks for the CPU) for its
MSMs. A 64-bit proof's MSMs (about 130 points) are under
MSM_DEVICE_THRESHOLD and run on the host, as in the JAX package. A proof's
bytes read back with the curve's point class, on no device.
"""

from ...curves.point import get_g1_class
from ...ecc import EllipticCurve, curve_spec
from ...transcript import FiatShamirTranscript, hash_to_curve
from ...utils import get_random_int, inner_product, split_list
from .ipa import (
    InnerProductArgument,
    InnerProductProof,
    expand_s_vector,
    fold_round_challenges,
)

_POINT_FIELDS = ("V", "A", "S", "T1", "T2")
_SCALAR_FIELDS = ("t", "t_blinding", "e_blinding")


class RangeProofObject:
    def __init__(self, V, A, S, T1, T2, t, t_blinding, e_blinding,
                 ipa_proof: InnerProductProof):
        self.V = V
        self.A = A
        self.S = S
        self.T1 = T1
        self.T2 = T2
        self.t = t
        self.t_blinding = t_blinding
        self.e_blinding = e_blinding
        self.ipa_proof = ipa_proof

    def to_bytes(self) -> bytes:
        out = bytearray()
        for name in _POINT_FIELDS:
            out += bytes(getattr(self, name).to_bytes())
        for name in _SCALAR_FIELDS:
            out += getattr(self, name).to_bytes(32, "little")
        out += self.ipa_proof.to_bytes()
        return bytes(out)

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        G1 = get_g1_class(crv)
        point_len = curve_spec(crv).point_bytes
        if (len(raw) - 160) % point_len != 0:
            raise ValueError("Invalid proof length")

        head = 5 * point_len
        points = split_list(raw[:head], point_len)
        scalars = split_list(raw[head : head + 96], 32)
        if len(points) != 5 or len(scalars) != 3:
            raise ValueError("Malformed proof structure")

        return cls(
            *[G1.from_bytes(chunk) for chunk in points],
            *[int.from_bytes(chunk, "little") for chunk in scalars],
            InnerProductProof.from_bytes(raw[head + 96 :], crv),
        )


class RangeProof:
    def __init__(self, bitsize: int, curve, seed=b"RangeProof", device="cuda"):
        if bitsize >= 2**32:
            raise ValueError("bitsize too large")
        self.n = bitsize
        self.E = EllipticCurve(curve, device)
        self.G = hash_to_curve(seed, b"G", curve, self.n)
        self.H = hash_to_curve(seed, b"H", curve, self.n)
        self.B = hash_to_curve(seed, b"B", curve, 1)
        self.B_blinding = hash_to_curve(seed, b"Blinding", curve, 1)

    def _fresh_transcript(self):
        return FiatShamirTranscript(self.n.to_bytes(32, "big"), field=self.E.order)

    def _delta(self, y, z):
        """delta(y,z) = (z - z^2)<1, y^n> - z^3 <1, 2^n>."""
        p = self.E.order
        sum_y = 0
        sum_2 = 0
        y_pow = 1
        two_pow = 1
        for _ in range(self.n):
            sum_y = (sum_y + y_pow) % p
            sum_2 = (sum_2 + two_pow) % p
            y_pow = y_pow * y % p
            two_pow = two_pow * 2 % p
        return ((z - z * z) * sum_y - pow(z, 3, p) * sum_2) % p

    def prove(self, v: int, transcript=None):
        p = self.E.order
        transcript = transcript or self._fresh_transcript()

        # a_L = bits of v, a_R = a_L - 1 (so a_L o a_R = 0 iff bits are 0/1)
        a_L = [(v >> i) & 1 for i in range(self.n)]
        a_R = [(bit - 1) % p for bit in a_L]

        s_L = [get_random_int(p) for _ in range(self.n)]
        s_R = [get_random_int(p) for _ in range(self.n)]
        a_blinding = get_random_int(p)
        v_blinding = get_random_int(p)
        s_blinding = get_random_int(p)

        V = v * self.B + v_blinding * self.B_blinding
        A = (
            self.E.multiexp(self.G, a_L)
            + self.E.multiexp(self.H, a_R)
            + a_blinding * self.B_blinding
        )
        S = (
            self.E.multiexp(self.G, s_L)
            + self.E.multiexp(self.H, s_R)
            + s_blinding * self.B_blinding
        )
        for point in (V, A, S):
            transcript.append(point)

        y = transcript.get_challenge_scalar()
        z = transcript.get_challenge_scalar()

        # Degree-1 vector polynomials l(X) = l0 + l1 X, r(X) = r0 + r1 X.
        l_0, l_1, r_0, r_1 = [], [], [], []
        y_pow = 1
        two_pow = 1
        for i in range(self.n):
            l_0.append((a_L[i] - z) % p)
            l_1.append(s_L[i])
            r_0.append((y_pow * (a_R[i] + z) + z * z * two_pow) % p)
            r_1.append(y_pow * s_R[i] % p)
            y_pow = y_pow * y % p
            two_pow = two_pow * 2 % p

        # t(X) = <l(X), r(X)>: t1 via the Karatsuba-style cross term.
        t0 = inner_product(l_0, r_0, p)
        t2 = inner_product(l_1, r_1, p)
        cross = inner_product(
            [(a + b) % p for a, b in zip(l_0, l_1)],
            [(a + b) % p for a, b in zip(r_0, r_1)],
            p,
        )
        t1 = (cross - t0 - t2) % p

        t1_blinding = get_random_int(p)
        t2_blinding = get_random_int(p)
        T1 = t1 * self.B + t1_blinding * self.B_blinding
        T2 = t2 * self.B + t2_blinding * self.B_blinding
        transcript.append(T1)
        transcript.append(T2)

        x = transcript.get_challenge_scalar()

        l_at_x = [(c0 + x * c1) % p for c0, c1 in zip(l_0, l_1)]
        r_at_x = [(c0 + x * c1) % p for c0, c1 in zip(r_0, r_1)]
        t = (t0 + x * (t1 + x * t2)) % p
        t_blinding = (z * z * v_blinding + x * (t1_blinding + x * t2_blinding)) % p
        e_blinding = (a_blinding + x * s_blinding) % p

        for scalar in (t, t_blinding, e_blinding):
            transcript.append(scalar)
        w = transcript.get_challenge_scalar()

        # Hand off to the IPA over basis (G, y^-i * H) with Q = w*B.
        ipa_prover = InnerProductArgument(self.n, self.E.name, device=self.E.device)
        ipa_prover.G = self.G
        ipa_prover.H = [pow(y, -i, p) * h for i, h in enumerate(self.H)]
        ipa_prover.Q = w * self.B
        ipa_proof, _, _ = ipa_prover.prove(l_at_x, r_at_x, transcript)

        return RangeProofObject(V, A, S, T1, T2, t, t_blinding, e_blinding, ipa_proof)

    def verify(self, proof: RangeProofObject, transcript=None):
        p = self.E.order
        transcript = transcript or self._fresh_transcript()
        transcript.reset()

        for point in (proof.V, proof.A, proof.S):
            transcript.append(point)
        y = transcript.get_challenge_scalar()
        z = transcript.get_challenge_scalar()

        transcript.append(proof.T1)
        transcript.append(proof.T2)
        x = transcript.get_challenge_scalar()

        for scalar in (proof.t, proof.t_blinding, proof.e_blinding):
            transcript.append(scalar)
        w = transcript.get_challenge_scalar()

        # Replay the IPA's basis absorption (it sees H' = y^-i * H).
        for g in self.G:
            transcript.append(g)
        for i, h in enumerate(self.H):
            transcript.append(pow(y, -i, p) * h)

        # Random batching scalar folds the t-check into the IPA check.
        c = get_random_int(p)

        sq, inv_sq, all_inv = fold_round_challenges(
            transcript, proof.ipa_proof.L, proof.ipa_proof.R, p
        )
        s = expand_s_vector(sq, all_inv, self.n, p)

        a, b = proof.ipa_proof.a, proof.ipa_proof.b
        g_scalars = [(-z - a * si) % p for si in s]
        h_scalars = []
        y_inv_pow = 1
        two_pow = 1
        y_inv = pow(y, -1, p)
        for si in s:
            rhs = z * z * two_pow - b * pow(si, -1, p)
            h_scalars.append((z + y_inv_pow * rhs) % p)
            y_inv_pow = y_inv_pow * y_inv % p
            two_pow = two_pow * 2 % p

        basis = (
            [proof.A, proof.S, proof.V, proof.T1, proof.T2, self.B, self.B_blinding]
            + self.G
            + self.H
            + proof.ipa_proof.L
            + proof.ipa_proof.R
        )
        scalars = (
            [
                1,
                x,
                c * z * z % p,
                c * x % p,
                c * x * x % p,
                (w * (proof.t - a * b) + c * (self._delta(y, z) - proof.t)) % p,
                (-proof.e_blinding - c * proof.t_blinding) % p,
            ]
            + g_scalars
            + h_scalars
            + sq
            + inv_sq
        )
        return self.E.multiexp(basis, scalars).is_zero()
