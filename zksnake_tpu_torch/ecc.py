"""Elliptic-curve facade: name registry + dispatch onto the curve modules.

Role parity with upstream zksnake: python/zksnake/ecc.py (curve aliases,
byte-size metadata, batch_mul / multiexp entry points). Design differs: a
single CurveSpec registry replaces the reference's five parallel Enums, and
the heavy entry points land on the torch dispatch layer inside curves/, on
the device an EllipticCurve is given ("cuda" unless the caller asks for the
CPU).
"""

from dataclasses import dataclass

from .constant import (
    BLS12_381_MODULUS,
    BLS12_381_SCALAR_FIELD,
    BN254_MODULUS,
    BN254_SCALAR_FIELD,
)
from .backend.config import check_device
from .curves import get_curve_module
from .curves.point import get_g1_class, get_g2_class


@dataclass(frozen=True)
class CurveSpec:
    base_modulus: int
    scalar_order: int
    point_bytes: int  # compressed G1 size; G2 is twice this
    scalar_bytes: int


_SPECS = {
    "BN254": CurveSpec(BN254_MODULUS, BN254_SCALAR_FIELD, 32, 32),
    "BLS12_381": CurveSpec(BLS12_381_MODULUS, BLS12_381_SCALAR_FIELD, 48, 32),
}
# BN254 travels under several names (circom/eth tooling).
_SPECS["BN128"] = _SPECS["ALT_BN128"] = _SPECS["BN254"]


def curve_spec(name: str) -> CurveSpec:
    try:
        return _SPECS[name]
    except KeyError:
        raise ValueError(f"Unknown curve: {name}") from None


class _SizeView:
    """Enum-shaped compatibility view: CurvePointSize[name].value."""

    def __init__(self, field):
        self._field = field

    def __getitem__(self, name):
        spec = curve_spec(name)

        class _V:
            value = getattr(spec, self._field)

        return _V


CurvePointSize = _SizeView("point_bytes")
CurveScalarSize = _SizeView("scalar_bytes")

_G1_TYPES = (get_g1_class("BN254"), get_g1_class("BLS12_381"))
_G2_TYPES = (get_g2_class("BN254"), get_g2_class("BLS12_381"))


def ispointG1(x) -> bool:
    return isinstance(x, _G1_TYPES)


def ispointG2(x) -> bool:
    return isinstance(x, _G2_TYPES)


class EllipticCurve:
    """User-facing curve handle; all group arithmetic dispatches through the
    curve module, which routes large batches to the torch backend on
    `device` (raises if that is CUDA and no CUDA device is present)."""

    def __init__(self, curve: str, device="cuda"):
        spec = curve_spec(curve)
        self.name = curve
        self.device = check_device(device)
        self.curve = get_curve_module(curve, self.device)
        self.order = spec.scalar_order
        self.field_modulus = spec.base_modulus

    def G1(self):
        return self.curve.g1()

    def G2(self):
        return self.curve.g2()

    def pairing(self, a, b):
        """e(a, b) for a in G1, b in G2."""
        return self.curve.pairing(a, b)

    def multi_pairing(self, a, b):
        """Product of pairings e(a[i], b[i])."""
        if len(a) != len(b):
            raise ValueError("multi_pairing: length mismatch")
        return self.curve.multi_pairing(a, b)

    def batch_mul(self, g, s):
        """Independent scalar muls [g[i] * s[i]]; fixed-base tables / device
        batch kernels kick in above the dispatch threshold."""
        bases = g if isinstance(g, list) else [g] * len(s)
        if not bases:
            return []
        if isinstance(bases[0], self.curve.PointG1):
            return self.curve.batch_multi_scalar_g1(bases, s)
        if isinstance(bases[0], self.curve.PointG2):
            return self.curve.batch_multi_scalar_g2(bases, s)
        raise TypeError(f"batch_mul: unsupported point type {type(bases[0])}")

    def multiexp(self, g, s):
        """MSM: sum g[i] * s[i]. Extra bases beyond len(s) are ignored
        (callers pass oversized SRS vectors)."""
        if not g:
            raise ValueError("multiexp: empty basis")
        if not s:
            return g[0] * 0
        bases = g[: len(s)] if len(s) < len(g) else g
        if isinstance(bases[0], self.curve.PointG1):
            return self.curve.multiscalar_mul_g1(bases, s)
        if isinstance(bases[0], self.curve.PointG2):
            return self.curve.multiscalar_mul_g2(bases, s)
        raise TypeError(f"multiexp: unsupported point type {type(bases[0])}")

    def from_hex(self, hexstring: str):
        """Parse a compressed point; G1 vs G2 is inferred from the length."""
        raw = bytes.fromhex(hexstring)
        g1_len = curve_spec(self.name).point_bytes
        if len(raw) == g1_len:
            return self.curve.PointG1.from_bytes(raw)
        if len(raw) == 2 * g1_len:
            return self.curve.PointG2.from_bytes(raw)
        raise ValueError(
            f"Expected {g1_len} or {2 * g1_len} bytes, got {len(raw)}"
        )

    def __call__(self, x, y):
        """Point constructor: scalars -> G1, coordinate pairs -> G2."""
        if isinstance(x, (tuple, list)):
            return self.curve.PointG2(x[0], x[1], y[0], y[1])
        return self.curve.PointG1(x, y)
