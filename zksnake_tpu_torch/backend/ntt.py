"""Radix-2 number-theoretic transform over the scalar fields, on torch.

Port of zksnake_tpu/backend/ntt.py. The domain follows arkworks'
Radix2EvaluationDomain: omega = g^((r-1)/2^s) with 2^s = n, g the field's
2-adic root; the reference's coset transforms use offset = omega itself
(the coset quirk, kept).

One core: the constant-geometry (Pease) radix-2 DIF transform of the JAX
package's _ntt_core_cg_flat. Every stage splits the halves, runs the
butterfly, and riffles the halves back together; stage s's twiddle for lane
i is tw[(i >> s) << s]; a final bit-reversal gather restores natural order.
The butterfly's product is one K1 launch per stage.

With metrics on, ntt_device and intt_device count `ntt_elements`, the rows
times the length of each transform, into every open span
(zksnake_tpu_torch.metrics).
"""

import numpy as np
import torch

from .. import metrics
from .field import FieldSpec, mod_add, mod_sub, mont_mul


class Domain:
    """Radix-2 evaluation domain over Fr with per-device twiddle tables."""

    _CACHE = {}

    def __init__(self, r: int, n: int, two_adicity: int, generator: int):
        assert n & (n - 1) == 0, "domain size must be a power of two"
        self.r = r
        self.n = n
        self.fs = FieldSpec.get(r)
        root = pow(generator, (r - 1) >> two_adicity, r)
        logn = n.bit_length() - 1
        assert logn <= two_adicity, "domain too large for field 2-adicity"
        self.omega = pow(root, 1 << (two_adicity - logn), r)
        self.omega_inv = pow(self.omega, -1, r)
        self.n_inv = pow(n, -1, r)
        self.powers_host = self._powers(self.omega, max(n // 2, 1))
        self._dev = {}

    def _powers(self, g, k):
        out = []
        w = 1
        for _ in range(k):
            out.append(w)
            w = w * g % self.r
        return out

    @classmethod
    def get(cls, curve_or_field, n):
        """curve_or_field: CurveParams, or (r, two_adicity, generator)."""
        if isinstance(curve_or_field, tuple):
            r, ta, g = curve_or_field
        else:
            r, ta, g = (
                curve_or_field.r,
                curve_or_field.fr_two_adicity,
                curve_or_field.fr_generator,
            )
        key = (r, n)
        if key not in cls._CACHE:
            cls._CACHE[key] = cls(r, n, ta, g)
        return cls._CACHE[key]

    def _cached(self, key, device, make):
        k = (key, str(device))
        if k not in self._dev:
            self._dev[k] = make()
        return self._dev[k]

    def twiddles(self, device, inverse=False):
        """(nl, n/2) Montgomery powers of omega (or omega^-1)."""
        def make():
            pw = self._powers(self.omega_inv, max(self.n // 2, 1)) if inverse else self.powers_host
            return self.fs.to_device(self.fs.to_mont_host(pw), device)

        return self._cached(("tw", inverse), device, make)

    def stage_index(self, device):
        """(log n, n/2) int64: stage s's twiddle index (i >> s) << s."""
        def make():
            h = max(self.n // 2, 1)
            iota = np.arange(h, dtype=np.int64)
            logn = self.n.bit_length() - 1
            idx = np.stack([(iota >> s) << s for s in range(logn)]) if logn else np.zeros((0, h), np.int64)
            return torch.from_numpy(idx).to(device)

        return self._cached("stage", device, make)

    def bitrev(self, device):
        def make():
            n = self.n
            logn = n.bit_length() - 1
            idx = np.arange(n)
            rev = np.zeros(n, dtype=np.int64)
            for b in range(logn):
                rev |= ((idx >> b) & 1) << (logn - 1 - b)
            return torch.from_numpy(rev).to(device)

        return self._cached("bitrev", device, make)


def _ntt(dom: Domain, x, tw):
    """x: (nl, ..., n) Montgomery coefficients -> evaluations, natural
    order; every polynomial of the batch in the same launches."""
    fs = dom.fs
    n = dom.n
    if n == 1:
        return x
    h = n // 2
    dev = x.device
    stage = dom.stage_index(dev)
    for s in range(stage.shape[0]):
        u, v = x[..., :h], x[..., h:]
        w = tw[:, stage[s]]  # (nl, h), broadcast over the batch
        a = mod_add(fs, u, v)
        b = mont_mul(fs, mod_sub(fs, u, v), w)
        x = torch.stack([a, b], dim=-1).reshape(x.shape)
    return x[..., dom.bitrev(dev)]


def ntt_device(dom: Domain, x):
    metrics.count("ntt_elements", x.numel() // x.shape[0])
    return _ntt(dom, x, dom.twiddles(x.device, False))


def intt_device(dom: Domain, x):
    metrics.count("ntt_elements", x.numel() // x.shape[0])
    y = _ntt(dom, x, dom.twiddles(x.device, True))
    return mont_mul(dom.fs, y, dom.fs.const_mont(dom.n_inv, x.device, x.ndim - 1))


def coset_scale(dom: Domain, x, inverse=False):
    """Multiply element i by offset^i (offset = omega, the reference quirk)."""
    g = dom.omega_inv if inverse else dom.omega
    table = dom._cached(
        ("coset", inverse), x.device,
        lambda: dom.fs.to_device(dom.fs.to_mont_host(dom._powers(g, dom.n)), x.device),
    )
    return mont_mul(dom.fs, x, table)


def transform(dom: Domain, x, kind):
    """One of the four transforms of polynomial.py on a (nl, n) tensor."""
    if kind == "fft":
        return ntt_device(dom, x)
    if kind == "ifft":
        return intt_device(dom, x)
    if kind == "coset_fft":
        return ntt_device(dom, coset_scale(dom, x, False))
    if kind == "coset_ifft":
        return coset_scale(dom, intt_device(dom, x), True)
    raise ValueError(kind)


@torch.inference_mode()
def transform_host(curve_or_field, vals, size, kind, device):
    """Host entry: list of ints -> list of ints via the device NTT (arkworks
    resize semantics: pad with zeros or truncate to the domain)."""
    from ..utils import next_power_of_two

    n = next_power_of_two(size) if size > 1 else 1
    dom = Domain.get(curve_or_field, n)
    vals = [int(v) % dom.r for v in vals][:n]
    vals += [0] * (n - len(vals))
    x = dom.fs.to_device(dom.fs.to_mont_host(vals), device)
    return dom.fs.from_mont_host(transform(dom, x, kind))
