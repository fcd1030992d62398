"""Extension-field tower arithmetic for pairing-friendly curves (host/bigint path).

Fq2  = Fq[u] / (u^2 + 1)                     — elements: tuple (c0, c1) of ints
Fq12 = Fq2[w] / (w^6 - xi)                   — elements: 6-tuple of Fq2
       ("sextic over quadratic" flat basis; w^2 = v, v^3 = xi recovers the
        usual Fq2 -> Fq6 -> Fq12 tower, used only for inversion)

This is the verification-side algebra (pairings are size-independent); the
throughput path lives in backend/ as limb-tensor kernels.

Behavioral parity target: arkworks ark-ff QuadExtField / Fp12 semantics as used by
upstream zksnake: src/bn254/curve.rs and src/bls12_381/curve.rs.
"""


class Fq2Ops:
    """Arithmetic in Fq2 = Fq[u]/(u^2+1) for a prime p with -1 a non-residue."""

    def __init__(self, p):
        self.p = p

    def add(self, a, b):
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def sub(self, a, b):
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def neg(self, a):
        p = self.p
        return (-a[0] % p, -a[1] % p)

    def mul(self, a, b):
        p = self.p
        a0, a1 = a
        b0, b1 = b
        t0 = a0 * b0
        t1 = a1 * b1
        # (a0 + a1)(b0 + b1) - t0 - t1 = a0*b1 + a1*b0
        t2 = (a0 + a1) * (b0 + b1) - t0 - t1
        return ((t0 - t1) % p, t2 % p)

    def sqr(self, a):
        p = self.p
        a0, a1 = a
        # (a0 + a1)(a0 - a1) ; 2 a0 a1
        return ((a0 + a1) * (a0 - a1) % p, 2 * a0 * a1 % p)

    def scalar_mul(self, a, k):
        p = self.p
        return (a[0] * k % p, a[1] * k % p)

    def conj(self, a):
        return (a[0], -a[1] % self.p)

    def inv(self, a):
        p = self.p
        a0, a1 = a
        norm = (a0 * a0 + a1 * a1) % p
        ninv = pow(norm, -1, p)
        return (a0 * ninv % p, -a1 * ninv % p)

    def pow(self, a, e):
        result = (1, 0)
        base = a
        while e > 0:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    def is_zero(self, a):
        return a[0] == 0 and a[1] == 0

    def sqrt(self, a):
        """Square root in Fq2 when p % 4 == 3 and u^2 = -1. Returns None if no root."""
        p = self.p
        a0, a1 = a
        if a1 == 0:
            # sqrt of a base-field element inside Fq2
            r = _sqrt_fq(a0, p)
            if r is not None:
                return (r, 0)
            r = _sqrt_fq(-a0 % p, p)
            if r is None:
                return None
            return (0, r)
        # norm = a0^2 + a1^2 must be a QR in Fq
        norm = (a0 * a0 + a1 * a1) % p
        lam = _sqrt_fq(norm, p)
        if lam is None:
            return None
        inv2 = pow(2, -1, p)
        delta = (a0 + lam) * inv2 % p
        x0 = _sqrt_fq(delta, p)
        if x0 is None:
            delta = (a0 - lam) * inv2 % p
            x0 = _sqrt_fq(delta, p)
            if x0 is None:
                return None
        x1 = a1 * pow(2 * x0 % p, -1, p) % p
        return (x0, x1)


def _sqrt_fq(a, p):
    """Square root mod p for p % 4 == 3. Returns None if a is not a QR."""
    a %= p
    if a == 0:
        return 0
    r = pow(a, (p + 1) // 4, p)
    if r * r % p != a:
        return None
    return r


class Fq12Ops:
    """Arithmetic in Fq12 represented as Fq2[w]/(w^6 - xi)."""

    def __init__(self, p, xi):
        self.p = p
        self.xi = xi
        self.fq2 = Fq2Ops(p)
        self.xi_inv = self.fq2.inv(xi)
        # Frobenius coefficients: (w^i)^p = conj-part handled separately;
        # coefficient i gets multiplied by xi^(i*(p-1)/6)
        e = (p - 1) // 6
        self.frob_coeffs = [self.fq2.pow(xi, i * e) for i in range(6)]

    def zero(self):
        z = (0, 0)
        return (z, z, z, z, z, z)

    def one(self):
        return ((1, 0), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0))

    def from_fq2(self, a, pos=0):
        c = [(0, 0)] * 6
        c[pos] = a
        return tuple(c)

    def add(self, a, b):
        f = self.fq2
        return tuple(f.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        f = self.fq2
        return tuple(f.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        f = self.fq2
        return tuple(f.neg(x) for x in a)

    def mul(self, a, b):
        f = self.fq2
        p = self.p
        xi0, xi1 = self.xi
        # schoolbook product into 11 columns, then reduce w^6 = xi
        # accumulate raw int pairs to defer mod
        cols0 = [0] * 12
        cols1 = [0] * 12
        for i in range(6):
            a0, a1 = a[i]
            if a0 == 0 and a1 == 0:
                continue
            for j in range(6):
                b0, b1 = b[j]
                if b0 == 0 and b1 == 0:
                    continue
                t0 = a0 * b0 - a1 * b1
                t1 = a0 * b1 + a1 * b0
                k = i + j
                cols0[k] += t0
                cols1[k] += t1
        out = []
        for k in range(6):
            h0 = cols0[k + 6]
            h1 = cols1[k + 6]
            # (h0 + h1 u) * (xi0 + xi1 u)
            r0 = cols0[k] + h0 * xi0 - h1 * xi1
            r1 = cols1[k] + h0 * xi1 + h1 * xi0
            out.append((r0 % p, r1 % p))
        return tuple(out)

    def sqr(self, a):
        return self.mul(a, a)

    def scalar_mul_fq(self, a, k):
        f = self.fq2
        return tuple(f.scalar_mul(x, k) for x in a)

    def scalar_mul_fq2(self, a, s):
        f = self.fq2
        return tuple(f.mul(x, s) for x in a)

    def conj(self, a):
        """a^(p^6): negates odd powers of w (w^(p^6) = -w since xi^((p^6-1)/6)... holds
        for sextic twists used here; equivalent to conjugation over Fq6)."""
        f = self.fq2
        return (a[0], f.neg(a[1]), a[2], f.neg(a[3]), a[4], f.neg(a[5]))

    def frobenius(self, a):
        """a^p in flat basis."""
        f = self.fq2
        return tuple(
            f.mul(f.conj(a[i]), self.frob_coeffs[i]) for i in range(6)
        )

    def frobenius_n(self, a, n):
        for _ in range(n % 12):
            a = self.frobenius(a)
        return a

    # --- tower regrouping for inversion ---
    # Fq6 = Fq2[v]/(v^3 - xi); Fq12 = Fq6[w]/(w^2 - v)
    # flat (a0..a5 over w^i) -> c0 = (a0, a2, a4), c1 = (a1, a3, a5)

    def _fq6_mul(self, a, b):
        f = self.fq2
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = f.mul(a0, b0)
        t1 = f.mul(a1, b1)
        t2 = f.mul(a2, b2)
        c0 = f.add(t0, f.mul(self.xi, f.sub(f.mul(f.add(a1, a2), f.add(b1, b2)), f.add(t1, t2))))
        c1 = f.add(f.sub(f.mul(f.add(a0, a1), f.add(b0, b1)), f.add(t0, t1)), f.mul(self.xi, t2))
        c2 = f.add(f.sub(f.mul(f.add(a0, a2), f.add(b0, b2)), f.add(t0, t2)), t1)
        return (c0, c1, c2)

    def _fq6_mul_by_v(self, a):
        f = self.fq2
        return (f.mul(self.xi, a[2]), a[0], a[1])

    def _fq6_neg(self, a):
        f = self.fq2
        return (f.neg(a[0]), f.neg(a[1]), f.neg(a[2]))

    def _fq6_sub(self, a, b):
        f = self.fq2
        return (f.sub(a[0], b[0]), f.sub(a[1], b[1]), f.sub(a[2], b[2]))

    def _fq6_inv(self, a):
        f = self.fq2
        a0, a1, a2 = a
        t0 = f.sub(f.sqr(a0), f.mul(self.xi, f.mul(a1, a2)))
        t1 = f.sub(f.mul(self.xi, f.sqr(a2)), f.mul(a0, a1))
        t2 = f.sub(f.sqr(a1), f.mul(a0, a2))
        norm = f.add(
            f.mul(a0, t0),
            f.mul(self.xi, f.add(f.mul(a2, t1), f.mul(a1, t2))),
        )
        ninv = f.inv(norm)
        return (f.mul(t0, ninv), f.mul(t1, ninv), f.mul(t2, ninv))

    def inv(self, a):
        c0 = (a[0], a[2], a[4])
        c1 = (a[1], a[3], a[5])
        # (c0 + c1 w)^-1 = (c0 - c1 w) / (c0^2 - c1^2 v)
        c0sq = self._fq6_mul(c0, c0)
        c1sq = self._fq6_mul(c1, c1)
        denom = self._fq6_sub(c0sq, self._fq6_mul_by_v(c1sq))
        dinv = self._fq6_inv(denom)
        r0 = self._fq6_mul(c0, dinv)
        r1 = self._fq6_neg(self._fq6_mul(c1, dinv))
        return (r0[0], r1[0], r0[1], r1[1], r0[2], r1[2])

    def pow(self, a, e):
        result = self.one()
        base = a
        while e > 0:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    def eq(self, a, b):
        return a == b

    def multi_pow_frob(self, f, digits):
        """Compute prod_i (f^(p^i))^digits[i] with shared square-and-multiply.

        Used for the hard part of the final exponentiation: the exponent is
        decomposed base p so the p^i powers come from cheap Frobenius maps.
        """
        bases = []
        g = f
        for _ in digits:
            bases.append(g)
            g = self.frobenius(g)
        nbits = max(d.bit_length() for d in digits)
        result = self.one()
        for bit in range(nbits - 1, -1, -1):
            result = self.sqr(result)
            for base, d in zip(bases, digits):
                if (d >> bit) & 1:
                    result = self.mul(result, base)
        return result
