"""Blinded inner-product-argument PCS (BCMS20 appendix A shape).

Role parity with upstream zksnake: python/zksnake/commitment/polynomial/ipa.py:
same transcript schedule, same proof tuple [L*, R*, C_bar, c, t'], same
multipoint batching as KZG. Original implementation; the verifier expands the
challenge polynomial g(X) = prod_j (1 + u_j X^(2^j)) by iterative doubling of
its coefficient vector instead of polynomial products, and the MSMs in
commit/open/verify ride the torch dispatch in ecc.multiexp.

Copy of zksnake_tpu/commitment/polynomial/ipa.py with the port's imports
and a `device` ("cuda" unless the caller asks for the CPU) for its MSMs.
The basis is hashed to the curve and folded round by round on the host, as
in the JAX package.
"""

import math

from ...ecc import EllipticCurve
from ...polynomial import Polynomial, lagrange_interpolation
from ...transcript import FiatShamirTranscript, hash_to_curve
from ...utils import get_random_int, inner_product, next_power_of_two
from .base import (
    MultiOpeningQuery,
    PolynomialCommitmentScheme,
    group_by_opening_sets,
)


def _halves(seq):
    """Split into (low, high); a 1-element sequence yields an empty high."""
    if len(seq) == 1:
        return list(seq), []
    mid = max(1, len(seq) // 2)
    return list(seq[:mid]), list(seq[mid:])


class IPA(PolynomialCommitmentScheme):
    """Transparent-setup PCS: Pedersen-committed coefficients + log-round
    halving argument (https://eprint.iacr.org/2020/499.pdf, App. A)."""

    def __init__(self, max_degree, group, device="cuda"):
        super().__init__(max_degree, group)
        self.name = "IPA-PCS"
        self.E = EllipticCurve(self.group, device)
        self.order = self.E.order
        self.n = 0
        self.G = []
        self.H = None

    def setup(self, seed=None):
        """Derive the generator basis by hashing (nothing-up-my-sleeve)."""
        seed = seed or self.name.encode()
        self.n = next_power_of_two(self.degree)
        self.G = hash_to_curve(seed, b"G", self.E.name, self.n)
        self.H = hash_to_curve(seed, b"H", self.E.name, 1)
        self.is_setup = True

    def _require_setup(self):
        if not self.is_setup:
            raise RuntimeError("Trusted setup has not been run")

    def zero_commitment(self):
        return self.E.curve.PointG1.identity()

    def _padded_coeffs(self, polynomial, length):
        coeffs = polynomial.coeffs()
        return coeffs + [0] * (length - len(coeffs))

    # pylint: disable-next=arguments-differ
    def commit(self, polynomial, blinding: int):
        """Blinded Pedersen commitment <coeffs, G> + blinding * H."""
        self._require_setup()
        if polynomial.degree() >= self.n:
            raise ValueError("Polynomial exceeded maximum allowed degree")
        scalars = self._padded_coeffs(polynomial, self.n) + [blinding]
        return self.E.multiexp(self.G + [self.H], scalars)

    # pylint: disable-next=arguments-differ
    def open(self, polynomial, point, commitment, blinding, transcript=None):
        self._require_setup()
        evaluation = polynomial(point)
        transcript = transcript or FiatShamirTranscript(self.name.encode(), self.order)
        for item in (self.G, self.H, point, evaluation, commitment):
            transcript.append(item)

        # Mask with a random polynomial shifted to vanish at `point`, so the
        # halving argument leaks nothing about f beyond f(point).
        mask = Polynomial(
            [get_random_int(self.order - 1) for _ in range(self.n)], self.order
        )
        mask -= mask(point)
        mask_blind = get_random_int(self.order - 1)
        commitment_bar = self.E.multiexp(
            self.G + [self.H], self._padded_coeffs(mask, self.n) + [mask_blind]
        )
        transcript.append(commitment_bar)
        alpha = transcript.get_challenge_scalar()

        a_vec = self._padded_coeffs(polynomial, self.n)
        m_vec = self._padded_coeffs(mask, self.n)
        c = [(a + alpha * mv) % self.order for a, mv in zip(a_vec, m_vec)]
        t_prime = blinding + alpha * mask_blind

        commitment_prime = self.E.multiexp(self.G, c)
        transcript.append(commitment_prime)
        h_prime = hash_to_curve(transcript.get_challenge(), b"U", self.E.name, 1)
        transcript.append(commitment_prime + evaluation * h_prime)

        b = [pow(point, i, self.order) for i in range(self.n)]
        basis = list(self.G)
        rounds_L, rounds_R = [], []

        while len(c) > 1:
            c_lo, c_hi = _halves(c)
            b_lo, b_hi = _halves(b)
            g_lo, g_hi = _halves(basis)

            L = self.E.multiexp(g_lo, c_hi) + inner_product(c_hi, b_lo, self.order) * h_prime
            R = self.E.multiexp(g_hi, c_lo) + inner_product(c_lo, b_hi, self.order) * h_prime
            rounds_L.append(L)
            rounds_R.append(R)
            transcript.append(L)
            transcript.append(R)

            u = transcript.get_challenge_scalar()
            u_inv = pow(u, -1, self.order)
            c = [(lo + u_inv * hi) % self.order for lo, hi in zip(c_lo, c_hi)]
            b = [(lo + u * hi) % self.order for lo, hi in zip(b_lo, b_hi)]
            basis = [lo + u * hi for lo, hi in zip(g_lo, g_hi)]

        return [rounds_L, rounds_R, commitment_bar, c[0], t_prime], evaluation

    def verify(self, commitment, proof, point, evaluation, transcript=None):
        self._require_setup()
        if len(proof) != 5:
            return False
        rounds_L, rounds_R, commitment_bar, c, t_prime = proof

        degenerate = (
            commitment.is_zero()
            or commitment_bar.is_zero()
            or t_prime % self.order == 0
            or c % self.order == 0
        )
        if degenerate:
            return False

        transcript = transcript or FiatShamirTranscript(self.name.encode(), self.order)
        for item in (self.G, self.H, point, evaluation, commitment, commitment_bar):
            transcript.append(item)
        alpha = transcript.get_challenge_scalar()

        commitment_prime = commitment + alpha * commitment_bar - t_prime * self.H
        transcript.append(commitment_prime)
        h_prime = hash_to_curve(transcript.get_challenge(), b"U", self.E.name, 1)
        C = commitment_prime + evaluation * h_prime
        transcript.append(C)

        n_rounds = int(math.log2(self.n))
        u_list = []
        for L, R in zip(rounds_L[:n_rounds], rounds_R[:n_rounds]):
            if L.is_zero() or R.is_zero():
                return False
            transcript.append(L)
            transcript.append(R)
            u = transcript.get_challenge_scalar()
            u_list.append(u)
            C = pow(u, -1, self.order) * L + C + u * R

        # g(X) = prod_j (1 + u_{last-j} X^(2^j)); expand by doubling the
        # coefficient vector per factor.
        s = [1]
        for u in reversed(u_list):
            s = s + [v * u % self.order for v in s]

        folded_G = self.E.multiexp(self.G, s)
        powers = [pow(point, i, self.order) for i in range(self.n)]
        folded_b = inner_product(powers, s, self.order)

        return C == self.E.multiexp([folded_G, h_prime], [c, c * folded_b % self.order])

    # -- multipoint batching (same schedule as KZG, plus blinding math) --

    def _fold_groups(self, query: MultiOpeningQuery, x1: int, as_verifier: bool):
        folded, blinds, r_polys, points_per_group = [], [], [], []
        for points, members in group_by_opening_sets(query):
            if as_verifier:
                acc = self.zero_commitment()
                for i, comm in enumerate(members):
                    acc += pow(x1, i, self.order) * comm
                interp_ys = [
                    sum(
                        pow(x1, i, self.order) * query.get_evaluation(comm, p)
                        for i, comm in enumerate(members)
                    )
                    % self.order
                    for p in points
                ]
            else:
                acc = Polynomial([0], self.order)
                blind = 0
                for i, comm in enumerate(members):
                    w = pow(x1, i, self.order)
                    acc += w * query.to_polynomial(comm)
                    blind = (blind + w * query.get_blinding(comm)) % self.order
                blinds.append(blind)
                interp_ys = [acc(p) for p in points]
            folded.append(acc)
            r_polys.append(lagrange_interpolation(points, interp_ys, self.order))
            points_per_group.append(points)
        return folded, blinds, r_polys, points_per_group

    def multi_open(self, points_query: MultiOpeningQuery, transcript=None):
        self._require_setup()
        transcript = transcript or FiatShamirTranscript(self.name.encode(), self.order)
        transcript.append(points_query.commitments)

        verifier_query = MultiOpeningQuery()
        for point, polys in points_query.get_polynomials():
            for poly in polys:
                y = poly(point)
                verifier_query.verifier_query(
                    points_query.to_commitment(poly), point, y
                )
                transcript.append(y)

        x1 = transcript.get_challenge_scalar()
        x2 = transcript.get_challenge_scalar()

        q_polys, q_blinds, r_polys, group_points = self._fold_groups(
            points_query, x1, False
        )

        f_poly = Polynomial([0], self.order)
        for i, points in enumerate(group_points):
            divisor = Polynomial([1], self.order)
            for p in points:
                divisor *= Polynomial([(-p) % self.order, 1], self.order)
            quotient, remainder = (q_polys[i] - r_polys[i]) / divisor
            if not remainder.is_zero():
                raise ValueError("multi_open: non-zero remainder")
            f_poly += pow(x2, i, self.order) * quotient

        f_blind = get_random_int(self.order)
        f_commitment = self.commit(f_poly, f_blind)
        transcript.append(f_commitment)
        x3 = transcript.get_challenge_scalar()

        q_at_x3 = [q(x3) for q in q_polys]
        transcript.append(q_at_x3)
        x4 = transcript.get_challenge_scalar()

        final_poly = f_poly
        final_blind = f_blind
        for i, (q, qb) in enumerate(zip(q_polys, q_blinds)):
            w = pow(x4, i + 1, self.order)
            final_poly += w * q
            final_blind = (final_blind + w * qb) % self.order

        final_commitment = self.commit(final_poly, final_blind)
        opening_proof, _ = self.open(
            final_poly, x3, final_commitment, final_blind, transcript
        )
        return [f_commitment] + q_at_x3 + [opening_proof], verifier_query

    def multi_verify(self, points_query, proof, transcript=None):
        self._require_setup()
        if len(proof) <= 2:
            raise ValueError("Invalid proof")

        transcript = transcript or FiatShamirTranscript(self.name.encode(), self.order)
        transcript.append(points_query.commitments)
        for point, comms in points_query.get_commitments():
            for comm in comms:
                transcript.append(points_query.get_evaluation(comm, point))

        x1 = transcript.get_challenge_scalar()
        x2 = transcript.get_challenge_scalar()

        f_commitment, q_at_x3, opening_proof = proof[0], proof[1:-1], proof[-1]
        transcript.append(f_commitment)
        x3 = transcript.get_challenge_scalar()
        transcript.append(q_at_x3)
        x4 = transcript.get_challenge_scalar()

        q_comms, _, r_polys, group_points = self._fold_groups(points_query, x1, True)

        f_at_x3 = 0
        for i, points in enumerate(group_points):
            denom = 1
            for p in points:
                denom = denom * (x3 - p) % self.order
            numer = (q_at_x3[i] - r_polys[i](x3)) % self.order
            f_at_x3 += pow(x2, i, self.order) * numer * pow(denom, -1, self.order)
        f_at_x3 %= self.order

        final_commitment = f_commitment
        final_eval = f_at_x3
        for i, (qc, qv) in enumerate(zip(q_comms, q_at_x3)):
            w = pow(x4, i + 1, self.order)
            final_commitment += w * qc
            final_eval = (final_eval + w * qv) % self.order

        return self.verify(
            final_commitment, opening_proof, x3, final_eval, transcript
        )
