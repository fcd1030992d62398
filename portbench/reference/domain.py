"""Radix-2 domains of the BN254 scalar field in plain Python: roots of
unity, batch inversion, Lagrange coefficients at a point, and the NTT."""

from .bn254 import FR_GENERATOR, FR_TWO_ADICITY, R


def omega(n):
    """The generator of the n-th roots of unity that the port's domains use:
    g^((r - 1) / 2^28) raised to 2^(28 - log2 n), g = 5."""
    logn = n.bit_length() - 1
    root = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)
    return pow(root, 1 << (FR_TWO_ADICITY - logn), R)


def powers(x, n):
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * x % R
    return out


def batch_inverse(xs):
    """Inverses of nonzero field elements, one inversion for all."""
    pre = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        pre[i + 1] = pre[i] * x % R
    inv = pow(pre[-1], -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = inv * pre[i] % R
        inv = inv * xs[i] % R
    return out


def lagrange_at(n, x, roots=None):
    """L_i(x) for i < n over the n-th roots of unity, x not a root:
    (x^n - 1) / n * w^i / (x - w^i)."""
    roots = roots or powers(omega(n), n)
    scale = (pow(x, n, R) - 1) * pow(n, -1, R) % R
    inv = batch_inverse([(x - w) % R for w in roots])
    return [scale * w % R * d % R for w, d in zip(roots, inv)]


def ntt(values, root):
    """Evaluations of the polynomial with coefficients `values` (length a
    power of two) at root^0 .. root^(n-1); iterative radix 2."""
    a = list(values)
    n = len(a)
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
        half = length // 2
        step = pow(root, n // length, R)
        tw = powers(step, half)
        for start in range(0, n, length):
            for k in range(half):
                u = a[start + k]
                v = a[start + k + half] * tw[k] % R
                a[start + k] = (u + v) % R
                a[start + k + half] = (u - v) % R
        length <<= 1
    return a


def interpolate(evals):
    """Coefficients of the polynomial of degree < n through evals on the
    n-th roots of unity."""
    n = len(evals)
    w = omega(n)
    n_inv = pow(n, -1, R)
    return [c * n_inv % R for c in ntt(evals, pow(w, -1, R))]


def coset_evals(coeffs, size, shift):
    """Evaluations at shift * mu^i, mu a size-th root of unity, of the
    polynomial with these coefficients (fewer than size of them)."""
    scaled = [0] * size
    s = 1
    for i, c in enumerate(coeffs):
        scaled[i] = c * s % R
        s = s * shift % R
    return ntt(scaled, omega(size))


def coset_interpolate(evals, shift):
    """Coefficients of the polynomial of degree < len(evals) that takes
    evals at shift * mu^i."""
    coeffs = interpolate(evals)
    inv = pow(shift, -1, R)
    s = 1
    for i in range(len(coeffs)):
        coeffs[i] = coeffs[i] * s % R
        s = s * inv % R
    return coeffs


def horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc
