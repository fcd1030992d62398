"""Sumcheck protocol over multilinear polynomials.

Behavioral parity with upstream zksnake: python/zksnake/subprotocol/sumcheck.py:
identical transcript schedule (claim, then each round's coefficient list) and
the same 4-point NTT domain for interpolating round polynomials. Original
implementation: the simple-MLE and structured-polynomial provers share one
round driver, and the round-polynomial interpolation helper is reused by GKR.

Copy of zksnake_tpu/subprotocol/sumcheck.py with the port's imports and a
`device` ("cuda" unless the caller asks for the CPU): a plain MLE's rounds
run on it through backend/mle.py's sumcheck driver when the table is large
and dense. The 4-point interpolations stay on the host (they are under
NTT_DEVICE_THRESHOLD); the device is passed to them all the same.
"""

from typing import List

from ..backend.config import check_device
from ..polynomial import Polynomial, get_all_evaluation_points, ifft
from ..transcript import FiatShamirTranscript


class SumcheckPolynomial:
    """Hook for structured polynomials (e.g. GKR's wiring polynomial) that
    can produce their own per-round univariate restrictions."""

    def __init__(self, n, p):
        self.n = n
        self.p = p

    def to_evaluations(self) -> List[int]:
        """All evaluations over the boolean hypercube."""
        raise NotImplementedError

    def evaluate(self, points):
        raise NotImplementedError

    def first_round(self):
        """Univariate restriction in the first variable."""
        raise NotImplementedError

    def round_function(self, r):
        """Univariate restriction after fixing the challenge prefix `r`."""
        raise NotImplementedError


def univariate_round_poly(poly, order, device="cuda"):
    """Interpolate g(X) = sum over the remaining boolean cube of poly(X, .)
    from evaluations at the 4-point NTT domain (degree bound 3)."""
    domain = get_all_evaluation_points(3, order)
    sums = [
        sum(poly.partial_evaluate([x]).to_evaluations()) % order for x in domain
    ]
    return Polynomial(ifft(sums, order, device=device), order)


class Sumcheck:
    """Interactive sumcheck driver (Fiat-Shamir via the shared transcript)."""

    def __init__(self, n, order, device="cuda"):
        self.n = n
        self.order = order
        self.device = check_device(device)

    def _fresh_transcript(self):
        return FiatShamirTranscript(b"sumcheck", field=self.order)

    def _drive_rounds(self, sum_claim, first_fn, next_fn, transcript):
        """Shared prover loop: one univariate per variable, each absorbed
        into the transcript; challenges are drawn lazily before rounds 2..n
        and once more at the end for the final evaluation point."""
        transcript.append(sum_claim)
        round_polys = []
        challenges = []
        for rnd in range(self.n):
            if rnd == 0:
                uni = first_fn()
            else:
                challenges.append(transcript.get_challenge_scalar())
                uni = next_fn(challenges)
                consistent = (uni(0) + uni(1)) % self.order
                assert round_polys[-1](challenges[-1]) == consistent
            transcript.append(uni.coeffs())
            round_polys.append(uni)
        challenges.append(transcript.get_challenge_scalar())
        return round_polys, challenges

    def prove(self, mlpoly, transcript=None):
        """Sumcheck for a plain multilinear polynomial.

        Large dense tables ride a device-resident driver (backend/mle.py
        DeviceSumcheckTable): a plain MLE's round polynomial is linear, so
        each round pulls just the two half-sums from the device and each
        challenge folds the table in place — instead of 4 full partial
        evaluations (dense-table host round-trips) per round. Transcript
        bytes are identical: the same 4-point interpolation is built from
        g(x) = S0 + x*(S1 - S0)."""
        assert mlpoly.num_vars == self.n
        from ..backend import mle as _dev_mle

        drv = _dev_mle.sumcheck_driver(
            self.order, mlpoly.num_vars, mlpoly.evals, self.device
        )
        if drv is not None:
            p = self.order
            domain = get_all_evaluation_points(3, p)

            def interp():
                s0, s1 = drv.round_sums()
                step = (s1 - s0) % p
                sums = [(s0 + x * step) % p for x in domain]
                return Polynomial(ifft(sums, p, device=self.device), p)

            def nxt(rs):
                drv.fold(rs[-1])
                return interp()

            first_uni = interp()
            claim = (first_uni(0) + first_uni(1)) % p
            proof, challenges = self._drive_rounds(
                claim,
                lambda: first_uni,
                nxt,
                transcript or self._fresh_transcript(),
            )
            return claim, proof, challenges

        claim = sum(mlpoly.to_evaluations()) % self.order
        proof, challenges = self._drive_rounds(
            claim,
            lambda: univariate_round_poly(mlpoly, self.order, self.device),
            lambda rs: univariate_round_poly(
                mlpoly.partial_evaluate(rs), self.order, self.device
            ),
            transcript or self._fresh_transcript(),
        )
        return claim, proof, challenges

    def prove_arbitrary(self, poly: SumcheckPolynomial, transcript=None):
        """Sumcheck for a structured polynomial with its own round hooks."""
        assert poly.n == self.n
        claim = sum(poly.to_evaluations()) % self.order
        proof, challenges = self._drive_rounds(
            claim,
            poly.first_round,
            poly.round_function,
            transcript or self._fresh_transcript(),
        )
        return claim, proof, challenges

    def verify(self, sum_claim, proof, degree_bound, transcript=None, mlpoly=None):
        """Returns the challenge list when the proof is consistent, else
        False. With `mlpoly` given, also checks the final evaluation."""
        assert len(proof) == self.n

        transcript = transcript or self._fresh_transcript()
        transcript.append(sum_claim)

        challenges = []
        expected = sum_claim
        for rnd, uni in enumerate(proof):
            if uni.degree() > degree_bound:
                return False
            if rnd > 0:
                challenges.append(transcript.get_challenge_scalar())
                expected = proof[rnd - 1](challenges[-1])
            if (uni(0) + uni(1)) % self.order != expected:
                return False
            transcript.append(uni.coeffs())

        challenges.append(transcript.get_challenge_scalar())
        if mlpoly and mlpoly.evaluate(challenges) != proof[-1](challenges[-1]):
            return False
        return challenges
