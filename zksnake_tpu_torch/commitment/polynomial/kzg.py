"""KZG polynomial commitment with halo2-style batched multipoint opening.

Role parity with upstream zksnake: python/zksnake/commitment/polynomial/kzg.py
(same pairing checks, same x1..x4 challenge schedule, same transcript
absorption order). Two design differences: commit/open MSMs ride the torch
dispatch in ecc.multiexp, and the multipoint grouping iterates in
deterministic first-seen order instead of the reference's Python-set order
(the reference's prover/verifier only agree because both walk identically
hashed sets; first-seen order is equivalent and stable).

Copy of zksnake_tpu/commitment/polynomial/kzg.py with the port's imports and
a `device` ("cuda" unless the caller asks for the CPU): the setup's powers
of tau go through the fixed-base batch mul and every commitment and opening
through the MSM dispatch (kernels K1 and K2 on a card, from
MSM_DEVICE_THRESHOLD points).
"""

from ...ecc import EllipticCurve
from ...polynomial import Polynomial, lagrange_interpolation
from ...transcript import FiatShamirTranscript
from ...utils import get_random_int
from .base import (
    MultiOpeningQuery,
    PolynomialCommitmentScheme,
    group_by_opening_sets,
)


class KZG(PolynomialCommitmentScheme):
    def __init__(self, max_degree, group, device="cuda"):
        super().__init__(max_degree, group)
        self.name = "KZG"
        self.E = EllipticCurve(self.group, device)
        self.order = self.E.order
        self.G1_tau = None
        self.G2_tau = None

    def setup(self):
        """Sample toxic tau and build the SRS ([tau^i]G1 via the fixed-base
        device batch mul; one G2 power for the pairing check)."""
        tau = get_random_int(self.order)
        powers = []
        acc = 1
        for _ in range(self.degree + 1):
            powers.append(acc)
            acc = acc * tau % self.order
        self.G1_tau = self.E.batch_mul(self.E.G1(), powers)
        self.G2_tau = self.E.G2() * tau
        self.is_setup = True

    def _require_setup(self):
        if not self.is_setup:
            raise RuntimeError("Trusted setup has not been run")

    def zero_commitment(self):
        return self.E.curve.PointG1.identity()

    def commit(self, polynomial):
        self._require_setup()
        return self.E.multiexp(self.G1_tau, polynomial.coeffs())

    def open(self, polynomial, point):
        """Single opening: commit to (f - f(z)) / (X - z)."""
        self._require_setup()
        evaluation = polynomial(point)
        witness, remainder = (polynomial - evaluation) / Polynomial(
            [(-point) % self.order, 1], self.order
        )
        if not remainder.is_zero():
            raise ValueError("Given polynomial is not divided to zero")
        return self.E.multiexp(self.G1_tau, witness.coeffs()), evaluation

    def verify(self, commitment, proof, point, evaluation, transcript=None):
        """e(W, [tau - z]G2) == e(C - [y]G1, G2)."""
        self._require_setup()
        lhs = self.E.pairing(proof, self.G2_tau - self.E.G2() * point)
        rhs = self.E.pairing(commitment - self.E.G1() * evaluation, self.E.G2())
        return lhs == rhs

    # -- halo2-style multipoint opening ---------------------------------

    def _fold_groups(self, query: MultiOpeningQuery, x1: int, as_verifier: bool):
        """x1-fold each shared-point group. Prover: fold polynomials and
        interpolate r from real evaluations. Verifier: fold commitments and
        interpolate r from claimed evaluations."""
        folded = []
        r_polys = []
        points_per_group = []
        for points, members in group_by_opening_sets(query):
            if as_verifier:
                acc = self.zero_commitment()
                for i, comm in enumerate(members):
                    acc += pow(x1, i, self.order) * comm
                interp_ys = [
                    sum(
                        pow(x1, i, self.order)
                        * query.get_evaluation(comm, p)
                        for i, comm in enumerate(members)
                    )
                    % self.order
                    for p in points
                ]
            else:
                acc = Polynomial([0], self.order)
                for i, comm in enumerate(members):
                    acc += pow(x1, i, self.order) * query.to_polynomial(comm)
                interp_ys = [acc(p) for p in points]
            folded.append(acc)
            r_polys.append(lagrange_interpolation(points, interp_ys, self.order))
            points_per_group.append(points)
        return folded, r_polys, points_per_group

    def _vanishing(self, points):
        v = Polynomial([1], self.order)
        for p in points:
            v *= Polynomial([(-p) % self.order, 1], self.order)
        return v

    def multi_open(self, points_query, transcript=None):
        """Open many (polynomial, point) pairs with one witness commitment."""
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

        q_polys, r_polys, group_points = self._fold_groups(points_query, x1, False)

        # f = sum_i x2^i * (q_i - r_i) / prod_{p in points_i} (X - p)
        f_poly = Polynomial([0], self.order)
        for i, points in enumerate(group_points):
            quotient, remainder = (q_polys[i] - r_polys[i]) / self._vanishing(points)
            if not remainder.is_zero():
                raise ValueError("multi_open: non-zero remainder")
            f_poly += pow(x2, i, self.order) * quotient

        f_commitment = self.commit(f_poly)
        transcript.append(f_commitment)
        x3 = transcript.get_challenge_scalar()

        q_at_x3 = [q(x3) for q in q_polys]
        transcript.append(q_at_x3)
        x4 = transcript.get_challenge_scalar()

        final_poly = f_poly
        for i, q in enumerate(q_polys):
            final_poly += pow(x4, i + 1, self.order) * q
        opening_proof, _ = self.open(final_poly, x3)

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

        q_comms, r_polys, group_points = self._fold_groups(points_query, x1, True)

        # Reconstruct f(x3) from the claimed q_i(x3).
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

        return self.verify(final_commitment, opening_proof, x3, final_eval)
