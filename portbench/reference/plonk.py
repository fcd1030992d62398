"""PlonK proofs (the paper's original protocol, cosets k1 = 2 and k2 = 3,
the quotient split in three with two blinds) of the multiplication chain,
from tau and each proof's blinds alone.

With tau known, the commitment to a polynomial f is f(tau) G1. The wire,
permutation and opening polynomials are evaluated at tau from their
values on the n-th roots of unity and their blinds; only the quotient T
needs its coefficients, for its three parts: it is interpolated on a coset
of the 4n-th roots of unity, where the numerator of T = N / Z_H is
evaluated pointwise.
"""

from . import bn254, chain, domain
from .bn254 import R
from .transcript import Transcript

K1, K2 = 2, 3
COSET = 5  # the quotient's coset shift, any non-residue of the 4n roots


def _blinded(coeffs, blinds, n):
    """coeffs + (blinds as a polynomial) * (X^n - 1)."""
    out = list(coeffs) + [0] * (n + len(blinds) - len(coeffs))
    for i, b in enumerate(blinds):
        out[i] = (out[i] - b) % R
        out[i + n] = (out[i + n] + b) % R
    return out


def _lagrange_one(n, k, x, w_k):
    """L_k(x) over the n-th roots of unity, x not a root."""
    return w_k * (pow(x, n, R) - 1) * pow(n * (x - w_k) % R, -1, R) % R


class PlonkReference:
    def __init__(self, n, tau):
        self.n = n
        self.tau = tau
        self.omega = domain.omega(n)
        self.roots = domain.powers(self.omega, n)
        gates = chain.plonk_gates(n)
        self.sel = [[g[0][j] for g in gates] for j in range(5)]  # qL qR qO qM qC
        perm = chain.plonk_permutation([g[1] for g in gates])
        ids = self.roots + [K1 * w % R for w in self.roots] + [K2 * w % R for w in self.roots]
        self.sigma = [[ids[perm[i + lane * n]] for i in range(n)] for lane in range(3)]
        self.lag_tau = domain.lagrange_at(n, tau, self.roots)
        fixed = self.sel + self.sigma
        self.fixed_coeffs = [domain.interpolate(col) for col in fixed]
        self.fixed_tau = [self._at_tau(col) for col in fixed]
        self.fixed_commits = [bn254.g1_bytes(v) for v in self.fixed_tau]
        m = 4 * n
        self.coset = [COSET * u % R for u in domain.powers(domain.omega(m), m)]
        self.fixed_coset = [domain.coset_evals(c, m, COSET) for c in self.fixed_coeffs]
        # Z_H, L_0 and L_(n-1) on the coset (x^n takes four values there)
        zh = [(pow(x, n, R) - 1) % R for x in self.coset[:4]]
        self.zh_inv = domain.batch_inverse(zh)
        self.zh = zh
        n_inv = pow(n, -1, R)
        w_last = self.roots[n - 1]
        inv_l1 = domain.batch_inverse([(x - 1) % R for x in self.coset])
        inv_ll = domain.batch_inverse([(x - w_last) % R for x in self.coset])
        self.l_first = [zh[i % 4] * n_inv % R * d % R for i, d in enumerate(inv_l1)]
        self.l_last = [zh[i % 4] * n_inv % R * w_last % R * d % R for i, d in enumerate(inv_ll)]

    def _at_tau(self, evals):
        return sum(l * v for l, v in zip(self.lag_tau, evals)) % R

    def proof(self, x, blinds, zk=True):
        """The proof's elements as the port lays them out: 9 (name, encoded
        point) then 6 (name, int). zk=False leaves every blind out."""
        n, m, R_ = self.n, 4 * self.n, R
        if not zk:
            blinds = [0] * 11
        public, flat = chain.plonk_witness(x, n)
        wires = [flat[lane::3] for lane in range(3)]
        (pub_gate, pub_val), = public.items()
        tr = Transcript()
        for enc in self.fixed_commits:
            tr.point(enc)
        tr.scalar(pub_val)

        # round 1: the wires, blinded
        wc = [_blinded(domain.interpolate(w), blinds[2 * j:2 * j + 2], n)
              for j, w in enumerate(wires)]
        w_tau = [domain.horner(c, self.tau) for c in wc]
        commits = [bn254.g1_bytes(v) for v in w_tau]
        for enc in commits:
            tr.point(enc)
        beta = tr.challenge()
        gamma = tr.challenge()

        # round 2: the permutation accumulator
        a, b, c = wires
        s1, s2, s3 = self.sigma
        num, den = [], []
        for i, w in enumerate(self.roots):
            num.append((a[i] + beta * w + gamma) * (b[i] + beta * K1 * w + gamma) % R_
                       * (c[i] + beta * K2 * w + gamma) % R_)
            den.append((a[i] + beta * s1[i] + gamma) * (b[i] + beta * s2[i] + gamma) % R_
                       * (c[i] + beta * s3[i] + gamma) % R_)
        den_inv = domain.batch_inverse(den)
        z = [1] * n
        for i in range(n - 1):
            z[i + 1] = z[i] * num[i] % R_ * den_inv[i] % R_
        if z[n - 1] * num[n - 1] % R_ * den_inv[n - 1] % R_ != 1:
            raise ValueError("the copy constraints do not hold")
        zc = _blinded(domain.interpolate(z), blinds[6:9], n)
        z_tau = domain.horner(zc, self.tau)
        commit_z = bn254.g1_bytes(z_tau)
        tr.point(commit_z)
        alpha = tr.challenge()

        # round 3: the quotient on the coset, then its three parts
        ev = [domain.coset_evals(cf, m, COSET) for cf in wc + [zc]]
        ea, eb, ec, ez = ev
        qL, qR, qO, qM, qC, e1, e2, e3 = self.fixed_coset
        alpha2 = alpha * alpha % R_
        t_ev = [0] * m
        for i in range(m):
            xi = self.coset[i]
            ai, bi, ci, zi = ea[i], eb[i], ec[i], ez[i]
            gate = (ai * bi % R_ * qM[i] + ai * qL[i] + bi * qR[i] + ci * qO[i] + qC[i]
                    + pub_val * self.l_last[i]) % R_
            nom = (ai + beta * xi + gamma) * (bi + beta * K1 * xi + gamma) % R_ \
                * (ci + beta * K2 * xi + gamma) % R_
            dn = (ai + beta * e1[i] + gamma) * (bi + beta * e2[i] + gamma) % R_ \
                * (ci + beta * e3[i] + gamma) % R_
            perm = (nom * zi - dn * ez[(i + 4) % m]) % R_
            t_ev[i] = (gate + alpha * perm + alpha2 * (zi - 1) % R_ * self.l_first[i]) \
                % R_ * self.zh_inv[i % 4] % R_
        t = domain.coset_interpolate(t_ev, COSET)
        if any(t[3 * n + 6:]):
            raise ValueError("the quotient does not divide")
        b_lo, b_hi = blinds[9:11]
        t_lo = t[:n] + [b_lo]
        t_mid = t[n:2 * n] + [b_hi]
        t_mid[0] = (t_mid[0] - b_lo) % R_
        t_hi = t[2 * n:3 * n + 6]
        t_hi[0] = (t_hi[0] - b_hi) % R_
        t_parts = [t_lo, t_mid, t_hi]
        t_tau = [domain.horner(p, self.tau) for p in t_parts]
        commit_t = [bn254.g1_bytes(v) for v in t_tau]
        for enc in commit_t:
            tr.point(enc)
        zeta = tr.challenge()

        # round 4: the evaluations
        zeta_w = zeta * self.omega % R_
        evals = [domain.horner(cf, zeta) for cf in wc]
        evals += [domain.horner(self.fixed_coeffs[5], zeta), domain.horner(self.fixed_coeffs[6], zeta),
                  domain.horner(zc, zeta_w)]
        for e in evals:
            tr.scalar(e)
        v = tr.challenge()

        # round 5: the two openings, W(tau) = (f(tau) - f(point)) / (tau - point)
        z_a, z_b, z_c, z_s1, z_s2, z_zw = evals
        l1_zeta = _lagrange_one(n, 0, zeta, 1)
        pi_zeta = pub_val * _lagrange_one(n, pub_gate, zeta, self.roots[pub_gate]) % R_
        zh_zeta = (pow(zeta, n, R_) - 1) % R_
        gate_nom = (z_a + beta * zeta + gamma) * (z_b + beta * K1 * zeta + gamma) \
            * (z_c + beta * K2 * zeta + gamma) % R_
        gate_den = (z_a + beta * z_s1 + gamma) * (z_b + beta * z_s2 + gamma) % R_
        v_pows = [pow(v, i, R_) for i in range(1, 6)]
        weights = [z_a, z_b, z_c, z_a * z_b % R_, 1,
                   (alpha * gate_nom + alpha2 * l1_zeta) % R_,
                   (-alpha * beta * gate_den * z_zw) % R_,
                   (-zh_zeta) % R_,
                   (-zh_zeta * pow(zeta, n, R_)) % R_,
                   (-zh_zeta * pow(zeta, 2 * n, R_)) % R_] + v_pows
        const1 = (pi_zeta - alpha * gate_den * (z_c + gamma) * z_zw - alpha2 * l1_zeta
                  - sum(w * e for w, e in zip(v_pows, evals[:5]))) % R_
        fc = self.fixed_coeffs
        basis = fc[:5] + [zc, fc[7]] + t_parts + wc + [fc[5], fc[6]]
        basis_tau = self.fixed_tau[:5] + [z_tau, self.fixed_tau[7]] + t_tau + w_tau \
            + self.fixed_tau[5:7]
        num_tau = (const1 + sum(w * f for w, f in zip(weights, basis_tau))) % R_
        num_zeta = (const1 + sum(w * domain.horner(f, zeta) for w, f in zip(weights, basis))) % R_
        w_zeta = (num_tau - num_zeta) * pow(self.tau - zeta, -1, R_) % R_
        w_zeta_w = (z_tau - z_zw) * pow(self.tau - zeta_w, -1, R_) % R_

        names = ("tau_a", "tau_b", "tau_c", "tau_z", "tau_t_lo", "tau_t_mid", "tau_t_hi",
                 "tau_W_zeta", "tau_W_zeta_omega")
        points = commits + [commit_z] + commit_t + [bn254.g1_bytes(w_zeta), bn254.g1_bytes(w_zeta_w)]
        scalars = ("zeta_a", "zeta_b", "zeta_c", "zeta_sigma1", "zeta_sigma2", "zeta_omega")
        return list(zip(names, points)) + list(zip(scalars, evals))
