"""Bulletproofs inner-product argument.

Role parity with upstream zksnake: python/zksnake/subprotocol/bulletproofs/ipa.py:
identical transcript schedule and wire format (L/R pairs followed by two
32-byte little-endian scalars). Original implementation; the verifier expands
the s-vector from the binary decomposition of each index, and all MSMs ride
the torch dispatch in ecc.multiexp.

Copy of zksnake_tpu/subprotocol/bulletproofs/ipa.py with the port's imports
and a `device` ("cuda" unless the caller asks for the CPU) for its MSMs; a
proof's bytes read back with the curve's point class, on no device.
"""

from ...curves.point import get_g1_class
from ...ecc import EllipticCurve, curve_spec
from ...transcript import FiatShamirTranscript, hash_to_curve
from ...utils import inner_product, next_power_of_two, split_list


class InnerProductProof:
    def __init__(self, a: int, b: int, L: list, R: list):
        self.a = a
        self.b = b
        self.L = L
        self.R = R

    def to_bytes(self) -> bytes:
        out = bytearray()
        for L, R in zip(self.L, self.R):
            out += bytes(L.to_bytes())
            out += bytes(R.to_bytes())
        out += self.a.to_bytes(32, "little")
        out += self.b.to_bytes(32, "little")
        return bytes(out)

    @classmethod
    def from_bytes(cls, raw: bytes, crv="BN254"):
        G1 = get_g1_class(crv)
        point_len = curve_spec(crv).point_bytes
        if (len(raw) - 64) % point_len != 0:
            raise ValueError("Invalid proof length")

        a_raw, b_raw = split_list(raw[-64:], 32)
        rounds = split_list(raw[:-64], point_len)
        Ls = [G1.from_bytes(chunk) for chunk in rounds[0::2]]
        Rs = [G1.from_bytes(chunk) for chunk in rounds[1::2]]
        return cls(
            int.from_bytes(a_raw, "little"), int.from_bytes(b_raw, "little"), Ls, Rs
        )


def fold_round_challenges(transcript, L_list, R_list, order):
    """Absorb each L/R pair, draw its challenge, and return
    (squared challenges, squared inverses, product of plain inverses) —
    the quantities every bulletproofs verifier needs."""
    sq, inv_sq = [], []
    all_inv = 1
    for L, R in zip(L_list, R_list):
        transcript.append(L)
        transcript.append(R)
        u = transcript.get_challenge_scalar()
        sq.append(u * u % order)
        inv = pow(u, -1, order)
        inv_sq.append(inv * inv % order)
        all_inv = all_inv * inv % order
    return sq, inv_sq, all_inv


def expand_s_vector(challenges_sq, all_inv, n, order):
    """s[i] = prod_j u_j^(+/-1) with the sign given by bit j of i.
    Built incrementally: s[i] extends s[i - 2^msb(i)] by one squared
    challenge, so the whole vector costs n multiplications."""
    s = [all_inv]
    k = len(challenges_sq)
    for i in range(1, n):
        msb = i.bit_length() - 1
        s.append(s[i - (1 << msb)] * challenges_sq[k - 1 - msb] % order)
    return s


class InnerProductArgument:
    """Log-round argument that <a, b> equals a committed value."""

    def __init__(self, size, curve, seed=b"InnerProductProof", Q=None, device="cuda"):
        self.n = next_power_of_two(size)
        self.E = EllipticCurve(curve, device)
        self.G = hash_to_curve(seed, b"G", curve, self.n)
        self.H = hash_to_curve(seed, b"H", curve, self.n)
        self.Q = Q

    def _fresh_transcript(self):
        return FiatShamirTranscript(self.n.to_bytes(32, "big"), field=self.E.order)

    def _absorb_basis(self, transcript):
        for g in self.G:
            transcript.append(g)
        for h in self.H:
            transcript.append(h)

    def prove(self, a: list, b: list, transcript=None):
        order = self.E.order
        transcript = transcript or self._fresh_transcript()
        a = list(a) + [0] * (self.n - len(a))
        b = list(b) + [0] * (self.n - len(b))

        self._absorb_basis(transcript)
        ab = inner_product(a, b, order)
        commitment = self.E.multiexp(self.G + self.H, a + b)

        if self.Q:
            Q = self.Q
        else:
            transcript.append(commitment)
            Q = hash_to_curve(transcript.get_challenge(), b"Q", self.E.name)

        G, H = list(self.G), list(self.H)
        L_list, R_list = [], []

        while len(a) > 1:
            half = len(a) // 2
            a_lo, a_hi = a[:half], a[half:]
            b_lo, b_hi = b[:half], b[half:]
            G_lo, G_hi = G[:half], G[half:]
            H_lo, H_hi = H[:half], H[half:]

            L = (
                self.E.multiexp(G_hi, a_lo)
                + self.E.multiexp(H_lo, b_hi)
                + inner_product(a_lo, b_hi, order) * Q
            )
            R = (
                self.E.multiexp(G_lo, a_hi)
                + self.E.multiexp(H_hi, b_lo)
                + inner_product(a_hi, b_lo, order) * Q
            )
            L_list.append(L)
            R_list.append(R)
            transcript.append(L)
            transcript.append(R)

            u = transcript.get_challenge_scalar()
            u_inv = pow(u, -1, order)

            a = [(lo * u + hi * u_inv) % order for lo, hi in zip(a_lo, a_hi)]
            b = [(lo * u_inv + hi * u) % order for lo, hi in zip(b_lo, b_hi)]
            G = [
                self.E.multiexp([lo, hi], [u_inv, u]) for lo, hi in zip(G_lo, G_hi)
            ]
            H = [
                self.E.multiexp([lo, hi], [u, u_inv]) for lo, hi in zip(H_lo, H_hi)
            ]

        return InnerProductProof(a[0], b[0], L_list, R_list), commitment, ab

    def verify(self, proof: InnerProductProof, commitment, inner_product_result,
               transcript=None):
        if len(proof.L) >= 32:
            raise ValueError("Argument size is too big")
        order = self.E.order

        transcript = transcript or self._fresh_transcript()
        self._absorb_basis(transcript)
        transcript.append(commitment)
        Q = hash_to_curve(transcript.get_challenge(), b"Q", self.E.name)

        sq, inv_sq, all_inv = fold_round_challenges(
            transcript, proof.L, proof.R, order
        )
        s = expand_s_vector(sq, all_inv, self.n, order)

        a_s = [proof.a * x % order for x in s]
        b_s_inv = [proof.b * pow(x, -1, order) % order for x in s]

        folded_LR = self.E.curve.PointG1.identity()
        for L, R, u2, u2_inv in zip(proof.L, proof.R, sq, inv_sq):
            folded_LR += L * u2 + R * u2_inv

        lhs = commitment + inner_product_result * Q
        rhs = (
            self.E.multiexp(self.G, a_s)
            + self.E.multiexp(self.H, b_s_inv)
            + proof.a * proof.b * Q
            - folded_LR
        )
        return lhs == rhs
