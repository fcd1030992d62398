"""Groth16 proofs of the multiplication chain, from the secrets alone.

With the toxic waste (tau, alpha, beta, gamma, delta) and a proof's r, s
known, each proof element is a multiple of a generator by a scalar worked
out in the scalar field: A = (alpha + U(tau) + r delta) G1,
B = (beta + V(tau) + s delta) G2, C = ((U(tau) V(tau) - W(tau) + K) / delta
+ a s + b r - r s delta) G1, with U, V, W the witness's combinations of the
R1CS columns interpolated over the n-th roots of unity, U V - W = H Z, and K
the private columns' beta u_j(tau) + alpha v_j(tau) + w_j(tau).
"""

from . import bn254, chain, domain
from .bn254 import R


class Groth16Reference:
    def __init__(self, n, waste):
        """n constraints (a power of two); waste = (tau, alpha, beta, gamma,
        delta) as the protocol drew them."""
        self.n = n
        self.tau, self.alpha, self.beta, self.gamma, self.delta = waste
        self.lag = domain.lagrange_at(n, self.tau)
        self.rows = chain.r1cs_rows(n)
        # the public columns' u_j(tau), v_j(tau), w_j(tau)
        self.pub = [[0] * chain.R1CS_PUBLIC for _ in range(3)]
        for i, row in enumerate(self.rows):
            for m, entries in enumerate(row):
                for col, val in entries:
                    if col < chain.R1CS_PUBLIC:
                        self.pub[m][col] = (self.pub[m][col] + self.lag[i] * val) % R

    def scalars(self, x, r, s):
        """(a, b, c) with the proof (a G1, b G2, c G1) for input x."""
        public, private = chain.r1cs_witness(x, self.n)
        z = public + private
        uvw = [0, 0, 0]
        for lag, row in zip(self.lag, self.rows):
            for m, entries in enumerate(row):
                uvw[m] += lag * sum(z[col] * val for col, val in entries)
        U, V, W = (t % R for t in uvw)
        pubs = [sum(z[j] * e for j, e in enumerate(self.pub[m])) % R for m in range(3)]
        k_priv = (self.beta * (U - pubs[0]) + self.alpha * (V - pubs[1]) + (W - pubs[2])) % R
        d_inv = pow(self.delta, -1, R)
        a = (self.alpha + U + r * self.delta) % R
        b = (self.beta + V + s * self.delta) % R
        c = ((U * V - W + k_priv) * d_inv + a * s + b * r - r * s * self.delta) % R
        return a, b, c

    def proof(self, x, r, s, zk=True):
        """The proof's elements as the port encodes them: [("A", bytes),
        ("B", bytes), ("C", bytes)]. zk=False leaves the blinding out
        (r = s = 0)."""
        a, b, c = self.scalars(x, r, s) if zk else self.scalars(x, 0, 0)
        return [("A", bn254.g1_bytes(a)), ("B", bn254.g2_bytes(b)), ("C", bn254.g1_bytes(c))]
