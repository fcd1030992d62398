"""Optimal ate pairings for BN254 and BLS12-381 (host/bigint path).

Replaces the reference's arkworks `Bn254::pairing` / `Bls12_381::multi_pairing`
(upstream zksnake: src/bn254/curve.rs:417-437). Pairings are verify-only and
size-independent, so a correct host implementation is the right tradeoff
(SURVEY.md section 7: "not perf-critical").

Miller loop runs with the G2 point kept on the sextic twist over Fq2 (slopes
need only Fq2 inversions); line evaluations are embedded into Fq12 in the flat
w-basis (w^6 = xi). Final exponentiation: easy part via conjugation/Frobenius,
hard part (p^4 - p^2 + 1)/r via base-p digit decomposition and a shared
square-and-multiply over Frobenius powers.
"""

from .tower import Fq2Ops, Fq12Ops
from .params import CURVES
from .point import PointG12, _jac_to_affine


class PairingEngine:
    def __init__(self, curve):
        self.curve = curve
        self.p = curve.p
        self.fq2 = Fq2Ops(curve.p)
        self.fq12 = Fq12Ops(curve.p, curve.xi)

        # Untwist embedding: twist point (x', y') in Fq2 maps to
        #   D-type: (x' * w^2, y' * w^3)        [w^6 = xi]
        #   M-type: (x' / w^2, y' / w^3) = (x' * w^4 / xi, y' * w^3 / xi)
        # We only ever need the *slope ratio* w^(b-a) and the coordinate embeddings.
        f12 = self.fq12
        if curve.twist_type == "D":
            self.emb_x = f12.from_fq2((1, 0), 2)  # w^2
            self.emb_y = f12.from_fq2((1, 0), 3)  # w^3
        else:
            xi_inv = self.fq2.inv(curve.xi)
            self.emb_x = f12.from_fq2(xi_inv, 4)  # w^4 / xi = w^-2
            self.emb_y = f12.from_fq2(xi_inv, 3)  # w^3 / xi = w^-3
        # slope embedding = emb_y / emb_x
        self.emb_lam = f12.mul(self.emb_y, f12.inv(self.emb_x))

        # final exponentiation hard-part digits: (p^4 - p^2 + 1) // r in base p
        p = curve.p
        h = (p**4 - p**2 + 1) // curve.r
        assert (p**4 - p**2 + 1) % curve.r == 0
        digits = []
        while h > 0:
            h, d = divmod(h, p)
            digits.append(d)
        self.hard_digits = digits

        # Frobenius endomorphism coefficients on the twist (for the BN254
        # extra addition steps): x -> conj(x) * fx, y -> conj(y) * fy where
        # fx = xi^((p-1)/3), fy = xi^((p-1)/2)
        self.tw_frob_x = self.fq2.pow(curve.xi, (curve.p - 1) // 3)
        self.tw_frob_y = self.fq2.pow(curve.xi, (curve.p - 1) // 2)

    # --- line evaluation -------------------------------------------------
    def _line(self, T, Q, P):
        """Evaluate the line through untwisted T, Q (or tangent at T if T==Q)
        at P=(xp, yp) in G1, returning an Fq12 element. T, Q are affine points
        on the twist (Fq2 coords). Also returns T+Q (or 2T) on the twist."""
        f2 = self.fq2
        f12 = self.fq12
        xt, yt = T
        xq, yq = Q
        if T == Q:
            # tangent: lam2 = 3 x^2 / 2 y   (on the twist)
            num = f2.scalar_mul(f2.sqr(xt), 3)
            den = f2.add(yt, yt)
            lam2 = f2.mul(num, f2.inv(den))
        elif xt == xq:
            # vertical line: l(P) = xp - X_T (embedded)
            xp, yp = P
            l = f12.sub(
                f12.from_fq2((xp % self.p, 0), 0),
                f12.scalar_mul_fq2(self.emb_x, xt),
            )
            return l, None
        else:
            lam2 = f2.mul(f2.sub(yq, yt), f2.inv(f2.sub(xq, xt)))

        # l(P) = yp - Y_T - lam' * (xp - X_T)
        #      = yp - lam'*xp + (lam2*xt)*emb_lam... careful with embeddings:
        # Y_T = yt * emb_y ; X_T = xt * emb_x ; lam' = lam2 * emb_lam
        xp, yp = P
        l = f12.from_fq2((yp % self.p, 0), 0)
        l = f12.sub(l, f12.scalar_mul_fq2(self.emb_y, yt))
        lam_emb = f12.scalar_mul_fq2(self.emb_lam, lam2)
        l = f12.sub(l, f12.scalar_mul_fq(lam_emb, xp % self.p))
        l = f12.add(l, f12.mul(lam_emb, f12.scalar_mul_fq2(self.emb_x, xt)))

        # group law on the twist
        x3 = f2.sub(f2.sub(f2.sqr(lam2), xt), xq)
        y3 = f2.sub(f2.mul(lam2, f2.sub(xt, x3)), yt)
        return l, (x3, y3)

    def miller_loop(self, P, Q):
        """P = (x, y) ints in G1 affine; Q = ((x0,x1),(y0,y1)) on the twist."""
        f12 = self.fq12
        f2 = self.fq2
        T = Q
        f = f12.one()
        loop = self.curve.ate_loop
        for bit in range(loop.bit_length() - 2, -1, -1):
            f = f12.sqr(f)
            l, T = self._line(T, T, P)
            f = f12.mul(f, l)
            if (loop >> bit) & 1:
                l, T = self._line(T, Q, P)
                f = f12.mul(f, l)

        if self.curve.name == "BN254":
            # two extra addition steps with Frobenius images of Q
            q1 = (
                f2.mul(f2.conj(Q[0]), self.tw_frob_x),
                f2.mul(f2.conj(Q[1]), self.tw_frob_y),
            )
            q2x = f2.mul(f2.conj(q1[0]), self.tw_frob_x)
            q2y = f2.mul(f2.conj(q1[1]), self.tw_frob_y)
            q2 = (q2x, f2.neg(q2y))
            l, T = self._line(T, q1, P)
            f = f12.mul(f, l)
            l, T = self._line(T, q2, P)
            f = f12.mul(f, l)
        elif self.curve.ate_loop_neg:
            # x < 0: f <- conj(f)
            f = f12.conj(f)
        return f

    def final_exponentiation(self, f):
        f12 = self.fq12
        # easy part: f^((p^6-1)(p^2+1))
        finv = f12.inv(f)
        f = f12.mul(f12.conj(f), finv)
        f = f12.mul(f12.frobenius_n(f, 2), f)
        # hard part: f^((p^4-p^2+1)/r) via base-p multi-exponentiation
        return f12.multi_pow_frob(f, self.hard_digits)

    def _prep_points(self, g1_point, g2_point):
        """Affine-ize inputs; returns None if either is the identity."""
        a1 = g1_point._affine()
        a2 = g2_point._affine()
        if a1 is None or a2 is None:
            return None
        return a1, a2

    def pairing(self, g1_point, g2_point):
        prep = self._prep_points(g1_point, g2_point)
        if prep is None:
            return PointG12(self.fq12.one(), self.curve.name)
        f = self.miller_loop(prep[0], prep[1])
        return PointG12(self.final_exponentiation(f), self.curve.name)

    def multi_pairing(self, g1_points, g2_points):
        f12 = self.fq12
        f = f12.one()
        for a, b in zip(g1_points, g2_points):
            prep = self._prep_points(a, b)
            if prep is None:
                continue
            f = f12.mul(f, self.miller_loop(prep[0], prep[1]))
        return PointG12(self.final_exponentiation(f), self.curve.name)


_ENGINES = {}


def get_engine(curve_name):
    curve = CURVES[curve_name]
    if curve.name not in _ENGINES:
        _ENGINES[curve.name] = PairingEngine(curve)
    return _ENGINES[curve.name]
