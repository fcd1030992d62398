"""Polynomials over the scalar fields.

API parity with the reference's Rust polynomial module as wrapped by
upstream zksnake: python/zksnake/polynomial.py: a `Polynomial` factory that
builds univariate (list) or multivariate (dict) polynomials, and free
functions fft/ifft/coset_fft/coset_ifft/
add_over_evaluation_domain/mul_over_evaluation_domain/
evaluate_vanishing_polynomial/evaluate_lagrange_coefficients/
get_evaluation_point(s), mul_over_fft, barycentric_eval,
lagrange_interpolation.

Semantics mirror arkworks (src/bn254/polynomial.rs):
- dense univariate coefficients with trailing zeros trimmed
  (DensePolynomial::from_coefficients_vec), zero poly == empty coeffs
- every polynomial carries a radix-2 domain of size next_pow2(domain_size)
  used by multiply/divide_by_vanishing_poly (polynomial.rs:447-489)
- the "coset" FFT uses offset == omega (polynomial.rs:553-556 quirk)

Large transforms run on the caller's torch device (backend/ntt.py; the
transforms take `device`, "cuda" unless the caller asks for the CPU); small
ones use a host bigint NTT (device round-trips dominate below the
threshold). The multilinear part (`MultilinearPolynomial`,
`SparseMultilinearPolynomial`) carries its device the same way: large dense
tables fold there (backend/mle.py), sparse ones walk on the host.
"""

from .utils import next_power_of_two, batch_modinv
from .constant import BN254_SCALAR_FIELD, BLS12_381_SCALAR_FIELD
from .backend import config as _backend_config

# Fr NTT parameters keyed by modulus: (two_adicity, generator)
FIELD_NTT_PARAMS = {
    BN254_SCALAR_FIELD: (28, 5),
    BLS12_381_SCALAR_FIELD: (32, 7),
}


def _field_tuple(p):
    ta, g = FIELD_NTT_PARAMS[p]
    return (p, ta, g)


class _HostDomain:
    """Host bigint radix-2 domain (mirrors backend.ntt.Domain math)."""

    _CACHE = {}

    def __init__(self, p, n):
        ta, g = FIELD_NTT_PARAMS[p]
        self.p = p
        self.n = n
        logn = n.bit_length() - 1
        assert logn <= ta, "domain too large for field 2-adicity"
        root = pow(g, (p - 1) >> ta, p)
        self.omega = pow(root, 1 << (ta - logn), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(n, -1, p) if n > 0 else 1

    @classmethod
    def get(cls, p, n):
        key = (p, n)
        if key not in cls._CACHE:
            cls._CACHE[key] = cls(p, n)
        return cls._CACHE[key]

    def _core(self, vals, omega):
        p = self.p
        n = self.n
        if n == 1:
            return list(vals)
        logn = n.bit_length() - 1
        # bit-reverse copy
        a = list(vals)
        j = 0
        for i in range(1, n):
            bit = n >> 1
            while j & bit:
                j ^= bit
                bit >>= 1
            j |= bit
            if i < j:
                a[i], a[j] = a[j], a[i]
        length = 2
        while length <= n:
            wlen = pow(omega, n // length, p)
            for i in range(0, n, length):
                w = 1
                half = length // 2
                for k in range(i, i + half):
                    u = a[k]
                    v = a[k + half] * w % p
                    a[k] = (u + v) % p
                    a[k + half] = (u - v) % p
                    w = w * wlen % p
            length <<= 1
        return a

    def fft(self, vals):
        return self._core(vals, self.omega)

    def ifft(self, vals):
        res = self._core(vals, self.omega_inv)
        ninv = self.n_inv
        return [x * ninv % self.p for x in res]


def _resize(vals, n, p):
    vals = [int(v) % p for v in vals]
    if len(vals) >= n:
        return vals[:n]
    return vals + [0] * (n - len(vals))


def _domain_size(size):
    return next_power_of_two(size) if size > 1 else 1


def _transform(vals, p, size, kind, device):
    n = _domain_size(size)
    if _backend_config.use_device(device, n, _backend_config.NTT_DEVICE_THRESHOLD):
        from .backend.ntt import transform_host

        return transform_host(_field_tuple(p), vals, size, kind, device)
    dom = _HostDomain.get(p, n)
    vals = _resize(vals, n, p)
    if kind == "fft":
        return dom.fft(vals)
    if kind == "ifft":
        return dom.ifft(vals)
    if kind == "coset_fft":
        # offset = omega (reference quirk): scale input by omega^i
        w = 1
        scaled = []
        for v in vals:
            scaled.append(v * w % p)
            w = w * dom.omega % p
        return dom.fft(scaled)
    if kind == "coset_ifft":
        res = dom.ifft(vals)
        w = 1
        out = []
        for v in res:
            out.append(v * w % p)
            w = w * dom.omega_inv % p
        return out
    raise ValueError(kind)


def fft(coeffs, p, size=None, device="cuda"):
    """Perform FFT from given `coeffs`"""
    size = size or len(coeffs)
    return _transform(coeffs, p, size, "fft", device)


def coset_fft(coeffs, p, size=None, device="cuda"):
    """Perform FFT over Coset from given `coeffs`"""
    size = size or len(coeffs)
    return _transform(coeffs, p, size, "coset_fft", device)


def ifft(evals, p, size=None, device="cuda"):
    """Perform inverse FFT from given `evals`"""
    size = size or len(evals)
    return _transform(evals, p, size, "ifft", device)


def coset_ifft(evals, p, size=None, device="cuda"):
    """Perform inverse FFT over Coset from given `evals`"""
    size = size or len(evals)
    return _transform(evals, p, size, "coset_ifft", device)


def get_evaluation_point(domain, i, p) -> int:
    """get `i`th element over evaluation domain of size `domain`"""
    if i == 0:
        return 1
    n = _domain_size(domain)
    dom = _HostDomain.get(p, n)
    return pow(dom.omega, i, p)


def get_all_evaluation_points(domain, p) -> list:
    """get all elements of evaluation domain of size `domain`"""
    n = _domain_size(domain)
    dom = _HostDomain.get(p, n)
    out = []
    w = 1
    for _ in range(n):
        out.append(w)
        w = w * dom.omega % p
    return out


def add_over_evaluation_domain(domain, evals: list, p):
    """Add multiple polynomials in evaluation form."""
    result = list(evals[0])
    for adder in evals[1:]:
        result = [(result[i] + adder[i]) % p for i in range(domain)]
    return result


def mul_over_evaluation_domain(domain, a, b, p):
    """Multiply two polynomials in evaluation form (zero-padded to domain)."""
    out = []
    for i in range(domain):
        x = a[i] if i < len(a) else 0
        y = b[i] if i < len(b) else 0
        out.append(x * y % p)
    return out


def evaluate_vanishing_polynomial(domain, x, p):
    """Evaluate x^n - 1 for the domain of size next_pow2(domain)."""
    n = _domain_size(domain)
    return (pow(int(x), n, p) - 1) % p


def evaluate_lagrange_coefficients(domain, x, p):
    """Evaluate all Lagrange basis polynomials of the domain at point x
    (arkworks evaluate_all_lagrange_coefficients semantics)."""
    n = _domain_size(domain)
    roots = get_all_evaluation_points(n, p)
    x = int(x) % p
    z = (pow(x, n, p) - 1) % p
    if z == 0:
        return [1 if x == w else 0 for w in roots]
    denoms = batch_modinv([(x - w) % p for w in roots], p)
    n_inv = pow(n, -1, p)
    return [z * w % p * d % p * n_inv % p for w, d in zip(roots, denoms)]


def _trim(coeffs, p):
    coeffs = [int(c) % p for c in coeffs]
    while coeffs and coeffs[-1] == 0:
        coeffs.pop()
    return coeffs


class UnivariatePolynomial:
    """Dense univariate polynomial (arkworks DensePolynomial semantics)."""

    __slots__ = ("p", "_coeffs", "domain")

    def __init__(self, coeffs, p, domain_size=None):
        self.p = p
        self._coeffs = _trim(coeffs, p)
        size = domain_size if domain_size is not None else len(coeffs)
        self.domain = _domain_size(size)

    def coeffs(self):
        return list(self._coeffs)

    def degree(self):
        if not self._coeffs:
            return 0
        return len(self._coeffs) - 1

    def is_zero(self):
        return len(self._coeffs) == 0

    def _wrap(self, coeffs, domain=None):
        poly = UnivariatePolynomial.__new__(UnivariatePolynomial)
        poly.p = self.p
        poly._coeffs = _trim(coeffs, self.p)
        poly.domain = domain if domain is not None else self.domain
        return poly

    def __eq__(self, other):
        if not isinstance(other, UnivariatePolynomial):
            return NotImplemented
        return self.p == other.p and self._coeffs == other._coeffs

    def __hash__(self):
        return hash((self.p, tuple(self._coeffs)))

    def __add__(self, other):
        p = self.p
        if isinstance(other, int):
            c = list(self._coeffs)
            if not c:
                c = [0]
            c[0] = (c[0] + other) % p
            return self._wrap(c)
        if isinstance(other, UnivariatePolynomial):
            n = max(len(self._coeffs), len(other._coeffs))
            a = self._coeffs + [0] * (n - len(self._coeffs))
            b = other._coeffs + [0] * (n - len(other._coeffs))
            return self._wrap([(x + y) % p for x, y in zip(a, b)])
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __neg__(self):
        return self._wrap([-c % self.p for c in self._coeffs])

    def __sub__(self, other):
        p = self.p
        if isinstance(other, int):
            c = list(self._coeffs)
            if not c:
                c = [0]
            c[0] = (c[0] - other) % p
            return self._wrap(c)
        if isinstance(other, UnivariatePolynomial):
            n = max(len(self._coeffs), len(other._coeffs))
            a = self._coeffs + [0] * (n - len(self._coeffs))
            b = other._coeffs + [0] * (n - len(other._coeffs))
            return self._wrap([(x - y) % p for x, y in zip(a, b)])
        return NotImplemented

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __mul__(self, other):
        p = self.p
        if isinstance(other, int):
            return self._wrap([c * other % p for c in self._coeffs])
        if isinstance(other, UnivariatePolynomial):
            a, b = self._coeffs, other._coeffs
            if not a or not b:
                return self._wrap([])
            # route large products through the NTT; small ones stay naive
            if len(a) + len(b) > 512:
                size = next_power_of_two(len(a) + len(b) - 1)
                fa = fft(a, p, size)
                fb = fft(b, p, size)
                prod = [x * y % p for x, y in zip(fa, fb)]
                return self._wrap(ifft(prod, p, size))
            out = [0] * (len(a) + len(b) - 1)
            for i, x in enumerate(a):
                if x == 0:
                    continue
                for j, y in enumerate(b):
                    out[i + j] += x * y
            return self._wrap([c % p for c in out])
        return NotImplemented

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        """Long division returning [quotient, remainder]
        (arkworks divide_with_q_and_r)."""
        p = self.p
        if not isinstance(other, UnivariatePolynomial):
            raise TypeError("Can only divide by a polynomial")
        if other.is_zero():
            raise ZeroDivisionError("Polynomial division by zero")
        if self.is_zero() or len(self._coeffs) < len(other._coeffs):
            return [self._wrap([], _domain_size(0)), self._wrap(self._coeffs)]
        a = list(self._coeffs)
        b = other._coeffs
        db = len(b) - 1
        lead_inv = pow(b[-1], -1, p)
        if db == 0:
            q = [c * lead_inv % p for c in a]
            return [
                self._wrap(q, _domain_size(len(q))),
                self._wrap([], _domain_size(0)),
            ]
        if db == 1:
            # synthetic division by linear divisor (hot path: KZG openings)
            c0 = b[0]
            q = [0] * (len(a) - 1)
            rem = a[-1]
            for i in range(len(a) - 2, -1, -1):
                q[i] = rem * lead_inv % p
                rem = (a[i] - q[i] * c0) % p
            return [
                self._wrap(q, _domain_size(len(q))),
                self._wrap([rem], _domain_size(1)),
            ]
        q = [0] * (len(a) - db)
        for i in range(len(a) - 1, db - 1, -1):
            coef = a[i] * lead_inv % p
            q[i - db] = coef
            if coef:
                for j in range(db + 1):
                    a[i - db + j] = (a[i - db + j] - coef * b[j]) % p
        rem = a[:db]
        return [
            self._wrap(q, _domain_size(len(q))),
            self._wrap(rem, _domain_size(len(_trim(rem, p)))),
        ]

    def multiply_by_vanishing_poly(self):
        """(x^n - 1) * f for the polynomial's domain."""
        n = self.domain
        c = self._coeffs
        out = [0] * (n + len(c))
        for i, v in enumerate(c):
            out[i] = -v % self.p
            out[i + n] = (out[i + n] + v) % self.p
        return self._wrap(out)

    def divide_by_vanishing_poly(self):
        """Divide by (x^n - 1): returns [quotient, remainder]."""
        n = self.domain
        p = self.p
        c = list(self._coeffs)
        if len(c) <= n:
            return [self._wrap([], _domain_size(0)), self._wrap(c)]
        # fold from the top: q_i = c_{i+n} + q_{i+n}
        q = [0] * (len(c) - n)
        for i in range(len(c) - n - 1, -1, -1):
            hi = q[i + n] if i + n < len(q) else 0
            q[i] = (c[i + n] + hi) % p
        r = [(c[i] + q[i]) % p if i < len(q) else c[i] for i in range(n)]
        return [self._wrap(q), self._wrap(r)]

    def __call__(self, point):
        p = self.p
        x = int(point) % p
        acc = 0
        for c in reversed(self._coeffs):
            acc = (acc * x + c) % p
        return acc

    def __str__(self):
        if not self._coeffs:
            return ""
        parts = []
        degree = len(self._coeffs) - 1
        for i, coeff in enumerate(reversed(self._coeffs)):
            exp = degree - i
            if coeff == 0:
                continue
            if exp > 1:
                parts.append(f"{coeff}x^{exp}")
            elif exp == 1:
                parts.append(f"{coeff}x")
            else:
                parts.append(f"{coeff}")
        return " + ".join(parts)

    def __repr__(self):
        return self.__str__()


def _normalize_term(exps):
    """Exponent spec -> canonical tuple of (var, power), sorted, powers>0."""
    acc = {}
    for v, e in exps:
        if e:
            acc[v] = acc.get(v, 0) + e
    return tuple(sorted(acc.items()))


class MultivariatePolynomial:
    """Sparse multivariate polynomial (arkworks SparsePolynomial semantics)."""

    __slots__ = ("p", "num_vars", "terms", "domain")

    def __init__(self, num_vars, coeff_terms, p, domain_size=None):
        """coeff_terms: list of (coeff, [(var, power), ...])."""
        self.p = p
        self.num_vars = num_vars
        acc = {}
        for coeff, exps in coeff_terms:
            key = _normalize_term(exps)
            acc[key] = (acc.get(key, 0) + coeff) % p
        self.terms = {k: v for k, v in acc.items() if v != 0}
        self.domain = _domain_size(domain_size if domain_size is not None else 0)

    def _wrap(self, terms):
        poly = MultivariatePolynomial.__new__(MultivariatePolynomial)
        poly.p = self.p
        poly.num_vars = self.num_vars
        poly.terms = {k: v % self.p for k, v in terms.items() if v % self.p != 0}
        poly.domain = self.domain
        return poly

    def coeffs(self):
        """dict {full exponent tuple: coeff} (parity with Rust coeffs())."""
        out = {}
        for key, coeff in self.terms.items():
            exps = [0] * self.num_vars
            for v, e in key:
                exps[v] = e
            out[tuple(exps)] = coeff
        return out

    def degree(self):
        if not self.terms:
            return 0
        return max(sum(e for _, e in key) for key in self.terms)

    def is_zero(self):
        return not self.terms

    def __eq__(self, other):
        if not isinstance(other, MultivariatePolynomial):
            return NotImplemented
        return self.p == other.p and self.terms == other.terms

    def __hash__(self):
        return hash((self.p, tuple(sorted(self.terms.items()))))

    def __add__(self, other):
        if isinstance(other, int):
            terms = dict(self.terms)
            terms[()] = (terms.get((), 0) + other) % self.p
            return self._wrap(terms)
        if isinstance(other, MultivariatePolynomial):
            terms = dict(self.terms)
            for k, v in other.terms.items():
                terms[k] = (terms.get(k, 0) + v) % self.p
            return self._wrap(terms)
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __neg__(self):
        return self._wrap({k: -v % self.p for k, v in self.terms.items()})

    def __sub__(self, other):
        if isinstance(other, int):
            return self.__add__(-other % self.p)
        if isinstance(other, MultivariatePolynomial):
            return self.__add__(-other)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, int):
            return self._wrap({k: v * other % self.p for k, v in self.terms.items()})
        if isinstance(other, MultivariatePolynomial):
            out = {}
            for k1, v1 in self.terms.items():
                for k2, v2 in other.terms.items():
                    key = _normalize_term(list(k1) + list(k2))
                    out[key] = (out.get(key, 0) + v1 * v2) % self.p
            return self._wrap(out)
        return NotImplemented

    def __rmul__(self, other):
        return self.__mul__(other)

    def __call__(self, points):
        p = self.p
        points = [int(x) % p for x in points]
        acc = 0
        for key, coeff in self.terms.items():
            term = coeff
            for v, e in key:
                term = term * pow(points[v], e, p) % p
            acc = (acc + term) % p
        return acc

    def __str__(self):
        parts = []
        for key, coeff in sorted(self.terms.items()):
            s = ""
            if coeff != 1 or not key:
                s += str(coeff)
            for v, e in key:
                s += f"x{v}"
                if e > 1:
                    s += f"^{e}"
            parts.append(s)
        return " + ".join(parts)

    def __repr__(self):
        return self.__str__()


def Polynomial(coeffs, p, domain_size=None):
    """Construct univariate (list) or multivariate (dict) polynomial —
    parity with reference polynomial.py:17-58."""
    if not domain_size:
        domain_size = len(coeffs)

    if isinstance(coeffs, list):
        return UnivariatePolynomial(coeffs, p, domain_size)
    elif isinstance(coeffs, dict):
        num_vars = len(next(iter(coeffs)))
        coeff_terms = []
        for terms, coeff in coeffs.items():
            sparse_terms = [(v, power) for v, power in enumerate(terms) if power != 0]
            coeff_terms.append((coeff, sparse_terms))
        return MultivariatePolynomial(num_vars, coeff_terms, p, domain_size)
    else:
        raise TypeError("Coefficients must be in list or dict")


class SparseMultilinearPolynomial:
    """Sparse multilinear extension over the boolean hypercube
    (arkworks SparseMultilinearExtension semantics; src/bn254/mle.rs).
    Large dense tables fold on `device` ("cuda" unless the caller asks for
    the CPU; backend/mle.py)."""

    __slots__ = ("p", "num_vars", "evals", "device")

    def __init__(self, num_vars, evaluations, p, device="cuda"):
        self.p = p
        self.num_vars = num_vars
        self.device = _backend_config.check_device(device)
        self.evals = {}
        for i, v in evaluations:
            v = int(v) % p
            self.evals[int(i)] = v
        self.evals = {i: v for i, v in self.evals.items() if v != 0}

    def _wrap(self, num_vars, evals):
        poly = SparseMultilinearPolynomial.__new__(SparseMultilinearPolynomial)
        poly.p = self.p
        poly.num_vars = num_vars
        poly.device = self.device
        poly.evals = {i: v for i, v in evals.items() if v != 0}
        return poly

    @classmethod
    def zero(cls, p=BN254_SCALAR_FIELD, device="cuda"):
        return cls(0, [], p, device)

    def evaluate(self, points):
        if len(points) != self.num_vars:
            raise ValueError(
                "Evaluation requires points to be in the same size as the number of variables"
            )
        return self.partial_evaluate(points).evals.get(0, 0)

    def partial_evaluate(self, partial_points):
        """Fix the first len(partial_points) variables (variable 0 = LSB).

        Large dense tables dispatch to the device strided fold
        (backend/mle.py) on the polynomial's device; sparse ones keep the
        O(nnz) host walk."""
        p = self.p
        evals = self.evals
        nv = self.num_vars

        from .backend import mle as _dev_mle

        k = len(partial_points)
        if _dev_mle.should_use_device(nv, len(evals), k, self.device):
            folded = _dev_mle.partial_evaluate_device(
                p, nv, evals, partial_points, self.device
            )
            return self._wrap(
                nv - k, {i: v for i, v in enumerate(folded) if v}
            )

        for r in partial_points:
            r = int(r) % p
            new = {}
            for idx, v in evals.items():
                contrib = v * (r if (idx & 1) else (1 - r)) % p
                key = idx >> 1
                new[key] = (new.get(key, 0) + contrib) % p
            evals = {i: v for i, v in new.items() if v != 0}
            nv -= 1
        return self._wrap(nv, evals)

    def to_evaluations(self):
        out = [0] * (1 << self.num_vars)
        for i, v in self.evals.items():
            out[i] = v
        return out

    def to_coefficients(self):
        return _mle_ext(self.to_evaluations(), self.p)

    def permute_evaluations(self, permutation):
        nv = self.num_vars
        assert len(permutation) == nv
        new_evals = []
        for index, value in self.evals.items():
            bits = [(index >> i) & 1 for i in range(nv)]
            new_index = 0
            for i, pi in enumerate(permutation):
                new_index |= bits[pi] << i
            new_evals.append((new_index, value))
        return self._wrap(nv, dict(new_evals))

    def swap(self, a, b, k):
        """Relabel: swap variable blocks [a, a+k) and [b, b+k)."""
        if a > b:
            a, b = b, a
        if a == b or k == 0:
            return self._wrap(self.num_vars, dict(self.evals))
        assert a + k <= b and b + k <= self.num_vars
        out = {}
        maskk = (1 << k) - 1
        for idx, v in self.evals.items():
            abits = (idx >> a) & maskk
            bbits = (idx >> b) & maskk
            new = idx & ~(maskk << a) & ~(maskk << b)
            new |= bbits << a
            new |= abits << b
            out[new] = v
        return self._wrap(self.num_vars, out)

    def __add__(self, other):
        if not isinstance(other, SparseMultilinearPolynomial):
            return NotImplemented
        if not self.evals:
            return other._wrap(other.num_vars, dict(other.evals))
        if not other.evals:
            return self._wrap(self.num_vars, dict(self.evals))
        assert self.num_vars == other.num_vars
        out = dict(self.evals)
        for i, v in other.evals.items():
            out[i] = (out.get(i, 0) + v) % self.p
        return self._wrap(self.num_vars, out)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if not isinstance(other, SparseMultilinearPolynomial):
            return NotImplemented
        neg = other._wrap(other.num_vars, {i: -v % other.p for i, v in other.evals.items()})
        return self.__add__(neg)

    def __eq__(self, other):
        if not isinstance(other, SparseMultilinearPolynomial):
            return NotImplemented
        return self.num_vars == other.num_vars and self.evals == other.evals

    def __str__(self):
        return (
            f"SparseMLPolynomial(num_vars={self.num_vars}, "
            f"evaluations={self.to_evaluations()})"
        )

    def __repr__(self):
        return self.__str__()


def _mle_ext(a, p):
    """Evaluations -> multilinear coefficients (mle.rs:9-23 recursion)."""
    if len(a) == 1:
        return [a[0]]
    h = len(a) // 2
    l_result = _mle_ext(a[:h], p)
    r_result = _mle_ext(a[h:], p)
    diff = [(r - l) % p for l, r in zip(l_result, r_result)]
    return l_result + diff


def MultilinearPolynomial(num_vars, sparse_evaluations, p, device="cuda"):
    """Constructs Sparse Multilinear Polynomial from (index, eval) tuples."""
    if num_vars == 0:
        return SparseMultilinearPolynomial.zero(p, device)
    return SparseMultilinearPolynomial(num_vars, sparse_evaluations, p, device)


def _pad_coeffs(a, b):
    a_degree = len(a) - 1
    b_degree = len(b) - 1

    if a_degree != b_degree:
        max_pad = max(a_degree, b_degree)
        length = next_power_of_two(max_pad)
        if a_degree > b_degree:
            pad_a = [0] * length
            pad_b = [0] * (a_degree + length - b_degree)
        else:
            pad_b = [0] * length
            pad_a = [0] * (b_degree + length - a_degree)
    else:
        pad_a = [0] * next_power_of_two(a_degree)
        pad_b = [0] * next_power_of_two(a_degree)

    return a + pad_a, b + pad_b


def mul_over_fft(domain, a, b, p, return_poly=True, device="cuda"):
    """Multiply two polynomials (in coefficient form) over the FFT domain."""
    a, b = _pad_coeffs(a.coeffs(), b.coeffs())

    a_fft = fft(a, p, device=device)
    b_fft = fft(b, p, device=device)
    ab_fft = mul_over_evaluation_domain(len(a_fft), a_fft, b_fft, p)

    if return_poly:
        return Polynomial(ifft(ab_fft, p, device=device), p, domain)

    return ab_fft


def barycentric_eval(domain, sparse_eval: dict, x, p):
    """Evaluate a polynomial at point x from sparse evaluation form."""
    omega = get_evaluation_point(domain, 1, p)

    sum_i = 0
    for i in sparse_eval:
        w_i = pow(omega, i, p)
        sum_i += (sparse_eval[i] * w_i) * pow(x - w_i, -1, p)

    return (pow(x, domain, p) - 1) * pow(domain, -1, p) * sum_i % p


def lagrange_interpolation(x, y, p):
    """Naive Lagrange interpolation from points (x_i, y_i)."""
    M = len(x)
    poly = Polynomial([0], p)
    for j in range(M):
        pt = Polynomial([y[j]], p)
        for k in range(M):
            if k == j:
                continue
            fac = x[j] - x[k]
            divided_poly = [-x[k], 1]
            res = []
            for c in divided_poly:
                res.append(c * pow(fac, -1, p) % p)
            pt *= Polynomial(res, p)
        poly += pt
    return poly
