"""Elliptic curve points (host/bigint path) for BN254 and BLS12-381.

API parity with the reference native core's PyO3 classes
(upstream zksnake: src/bn254/curve.rs:19-324): PointG1/PointG2 with projective
internals, compressed (de)serialization in the arkworks wire format
(little-endian x with 2 flag bits in the top byte: 0x40 = infinity,
0x80 = "y is negative" i.e. y > -y lexicographically), hash_to_field /
hash_to_curve (curves/hash2curve.py, host work), from_x, identity, and
operator overloads.

These objects are the *scalar* path. Bulk kernels (MSM, batched scalar mul)
run on the torch device via backend/msm.py and accept/return these points.
"""

from .tower import Fq2Ops, _sqrt_fq
from .params import CURVES


class _FqField:
    """Adapter for the prime base field (ints)."""

    def __init__(self, p, nbytes):
        self.p = p
        self.nbytes = nbytes

    zero = 0
    one = 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def sqr(self, a):
        return a * a % self.p

    def neg(self, a):
        return -a % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def scalar(self, k):
        return k % self.p

    def is_zero(self, a):
        return a == 0

    def sqrt(self, a):
        return _sqrt_fq(a, self.p)

    def is_negative(self, a):
        """arkworks SWFlags convention: negative iff a > -a (i.e. a > p/2)."""
        return a > self.p - a

    def to_bytes(self, a):
        return int(a).to_bytes(self.nbytes, "little")

    def from_bytes(self, b):
        v = int.from_bytes(b, "little")
        if v >= self.p:
            raise ValueError("Field element out of range")
        return v


class _Fq2Field:
    """Adapter for Fq2 (tuples (c0, c1))."""

    def __init__(self, p, nbytes):
        self.p = p
        self.nbytes = nbytes
        self.ops = Fq2Ops(p)

    @property
    def zero(self):
        return (0, 0)

    @property
    def one(self):
        return (1, 0)

    def add(self, a, b):
        return self.ops.add(a, b)

    def sub(self, a, b):
        return self.ops.sub(a, b)

    def mul(self, a, b):
        return self.ops.mul(a, b)

    def sqr(self, a):
        return self.ops.sqr(a)

    def neg(self, a):
        return self.ops.neg(a)

    def inv(self, a):
        return self.ops.inv(a)

    def scalar(self, k):
        return (k % self.p, 0)

    def is_zero(self, a):
        return a == (0, 0)

    def sqrt(self, a):
        return self.ops.sqrt(a)

    def is_negative(self, a):
        """arkworks QuadExtField ordering: lexicographic on (c1, c0)."""
        n = self.neg(a)
        return (a[1], a[0]) > (n[1], n[0])

    def to_bytes(self, a):
        return int(a[0]).to_bytes(self.nbytes, "little") + int(a[1]).to_bytes(
            self.nbytes, "little"
        )

    def from_bytes(self, b):
        n = self.nbytes
        c0 = int.from_bytes(b[:n], "little")
        c1 = int.from_bytes(b[n:], "little")
        if c0 >= self.p or c1 >= self.p:
            raise ValueError("Field element out of range")
        return (c0, c1)


def _jac_double(F, b, P):
    X1, Y1, Z1 = P
    if F.is_zero(Z1):
        return P
    A = F.sqr(X1)
    B = F.sqr(Y1)
    C = F.sqr(B)
    t = F.sqr(F.add(X1, B))
    D = F.add(F.sub(F.sub(t, A), C), F.sub(F.sub(t, A), C))  # 2*((X+B)^2 - A - C)
    E = F.add(F.add(A, A), A)
    Fv = F.sqr(E)
    X3 = F.sub(Fv, F.add(D, D))
    C8 = F.add(F.add(C, C), F.add(C, C))
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.mul(F.add(Y1, Y1), Z1)
    return (X3, Y3, Z3)


def _jac_add(F, b, P, Q):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if F.is_zero(Z1):
        return Q
    if F.is_zero(Z2):
        return P
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return _jac_double(F, b, P)
        return (F.one, F.one, F.zero)  # P + (-P) = infinity
    H = F.sub(U2, U1)
    I = F.sqr(F.add(H, H))
    J = F.mul(H, I)
    rr = F.add(F.sub(S2, S1), F.sub(S2, S1))
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.add(V, V))
    S1J = F.mul(S1, J)
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.add(S1J, S1J))
    # Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def _jac_neg(F, P):
    X, Y, Z = P
    return (X, F.neg(Y), Z)


def _jac_to_affine(F, P):
    X, Y, Z = P
    if F.is_zero(Z):
        return None
    zinv = F.inv(Z)
    zinv2 = F.sqr(zinv)
    return (F.mul(X, zinv2), F.mul(Y, F.mul(zinv2, zinv)))


def _jac_scalar_mul(F, b, P, k):
    R = (F.one, F.one, F.zero)
    if k == 0:
        return R
    Q = P
    while k > 0:
        if k & 1:
            R = _jac_add(F, b, R, Q)
        Q = _jac_double(F, b, Q)
        k >>= 1
    return R


class _BasePoint:
    """Shared logic for G1/G2 points. Subclasses bind (curve, field, b)."""

    __slots__ = ("_jac", "_affine_cache")

    # class attrs set by factory: CURVE (CurveParams), FIELD, B, IS_G2

    def __init_from_jac(self, jac):
        self._jac = jac
        self._affine_cache = None

    @classmethod
    def _from_jac(cls, jac):
        obj = object.__new__(cls)
        obj._jac = jac
        obj._affine_cache = None
        return obj

    def _affine(self):
        if self._affine_cache is None:
            self._affine_cache = (_jac_to_affine(self.FIELD, self._jac),)
        return self._affine_cache[0]

    # --- arithmetic ---
    def __add__(self, other):
        return self._from_jac(_jac_add(self.FIELD, self.B, self._jac, other._jac))

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._from_jac(
            _jac_add(self.FIELD, self.B, self._jac, _jac_neg(self.FIELD, other._jac))
        )

    def __rsub__(self, other):
        return self.__sub__(other)

    def __neg__(self):
        return self._from_jac(_jac_neg(self.FIELD, self._jac))

    def __mul__(self, other):
        k = int(other) % self.CURVE.r  # Fr::from semantics (curve.rs:101-106)
        return self._from_jac(_jac_scalar_mul(self.FIELD, self.B, self._jac, k))

    def __rmul__(self, other):
        return self.__mul__(other)

    def __eq__(self, other):
        if not isinstance(other, _BasePoint):
            return NotImplemented
        return self._affine() == other._affine()

    def __hash__(self):
        a = self._affine()
        return hash((self.CURVE.name, self.IS_G2, a))

    def is_zero(self):
        return self._affine() is None

    def is_on_curve(self):
        a = self._affine()
        if a is None:
            return True
        F = self.FIELD
        x, y = a
        return F.sqr(y) == F.add(F.mul(F.sqr(x), x), self.B)

    def in_subgroup(self):
        r = self.CURVE.r
        return _jac_to_affine(
            self.FIELD, _jac_scalar_mul(self.FIELD, self.B, self._jac, r)
        ) is None

    # --- serialization (arkworks compressed format) ---
    def to_bytes(self):
        F = self.FIELD
        a = self._affine()
        if a is None:
            b = bytearray(F.to_bytes(F.zero))
            b[-1] |= 0x40
            return list(b)
        x, y = a
        b = bytearray(F.to_bytes(x))
        if F.is_negative(y):
            b[-1] |= 0x80
        return list(b)

    def to_hex(self):
        return bytes(self.to_bytes()).hex()

    @classmethod
    def from_bytes(cls, data):
        data = bytes(bytearray(data))
        F = cls.FIELD
        expected = F.nbytes * (2 if cls.IS_G2 else 1)
        if len(data) != expected:
            raise ValueError(f"Cannot deserialize point: expected {expected} bytes")
        b = bytearray(data)
        flags = b[-1] & 0xC0
        if flags == 0xC0:
            raise ValueError("Cannot deserialize point: invalid flags")
        b[-1] &= 0x3F
        if flags == 0x40:
            return cls.identity()
        x = F.from_bytes(bytes(b))
        y = cls._y_from_x(x, greatest=None, negative=(flags == 0x80))
        if y is None:
            raise ValueError("Cannot deserialize point: no square root")
        pt = cls._from_jac((x, y, F.one))
        if not pt.in_subgroup():
            raise ValueError("Cannot deserialize point: not in subgroup")
        return pt

    @classmethod
    def _y_from_x(cls, x, greatest=None, negative=None):
        F = cls.FIELD
        rhs = F.add(F.mul(F.sqr(x), x), cls.B)
        y = F.sqrt(rhs)
        if y is None:
            return None
        want_neg = negative if negative is not None else greatest
        if F.is_negative(y) != want_neg:
            y = F.neg(y)
        return y

    # --- accessors ---
    @property
    def generator(self):
        return type(self).gen()

    def __repr__(self):
        return self.__str__()


def _make_g1(curve):
    F = _FqField(curve.p, curve.fq_bytes)

    class PointG1(_BasePoint):
        __slots__ = ()
        CURVE = curve
        FIELD = F
        B = curve.b
        IS_G2 = False

        def __init__(self, x, y):
            x = int(x)
            y = int(y)
            if x >= curve.p or y >= curve.p:
                raise ValueError("Coordinate out of field range")
            self._jac = (x, y, 1)
            self._affine_cache = None
            if not self.is_on_curve() or not self.in_subgroup():
                raise ValueError("Point is not on curve")

        @property
        def x(self):
            a = self._affine()
            return 0 if a is None else a[0]

        @property
        def y(self):
            a = self._affine()
            return 0 if a is None else a[1]

        def __str__(self):
            a = self._affine()
            if a is None:
                return "infinity"
            return f"({a[0]}, {a[1]})"

        @classmethod
        def gen(cls):
            return cls._from_jac((curve.g1_gen[0], curve.g1_gen[1], 1))

        @classmethod
        def identity(cls):
            return cls._from_jac((1, 1, 0))

        @classmethod
        def from_x(cls, x):
            """arkworks get_point_from_x_unchecked(x, greatest=true) + subgroup check
            (curve.rs:167-178)."""
            y = cls._y_from_x(int(x), greatest=True)
            if y is None:
                raise ValueError("Cannot found point")
            pt = cls._from_jac((int(x), y, 1))
            if not pt.is_on_curve() or not pt.in_subgroup():
                raise ValueError("Point is not on curve")
            return pt

        @classmethod
        def hash_to_field(cls, dst, data):
            from .hash2curve import hash_to_field_fq

            return hash_to_field_fq(bytes(bytearray(data)), bytes(bytearray(dst)), curve, 1)[0]

        @classmethod
        def hash_to_curve(cls, dst, data):
            from .hash2curve import hash_to_curve_g1

            return hash_to_curve_g1(bytes(bytearray(data)), bytes(bytearray(dst)), curve, cls)

    PointG1.__name__ = "PointG1"
    PointG1.__qualname__ = f"PointG1_{curve.name}"
    return PointG1


def _make_g2(curve):
    F = _Fq2Field(curve.p, curve.fq_bytes)

    class PointG2(_BasePoint):
        __slots__ = ()
        CURVE = curve
        FIELD = F
        B = curve.b2
        IS_G2 = True

        def __init__(self, x1, x2, y1, y2):
            x = (int(x1) % curve.p, int(x2) % curve.p)
            y = (int(y1) % curve.p, int(y2) % curve.p)
            self._jac = (x, y, F.one)
            self._affine_cache = None
            if not self.is_on_curve() or not self.in_subgroup():
                raise ValueError("Point is not on curve")

        @property
        def x(self):
            a = self._affine()
            return [0, 0] if a is None else [a[0][0], a[0][1]]

        @property
        def y(self):
            a = self._affine()
            return [0, 0] if a is None else [a[1][0], a[1][1]]

        def __str__(self):
            return f"({self.x}, {self.y})"

        @classmethod
        def gen(cls):
            return cls._from_jac((curve.g2_gen[0], curve.g2_gen[1], F.one))

        @classmethod
        def identity(cls):
            return cls._from_jac((F.one, F.one, F.zero))

    PointG2.__name__ = "PointG2"
    PointG2.__qualname__ = f"PointG2_{curve.name}"
    return PointG2


class PointG12:
    """Pairing output (element of the target group GT in Fq12)."""

    __slots__ = ("value", "curve_name")

    def __init__(self, value, curve_name):
        self.value = value
        self.curve_name = curve_name

    def __eq__(self, other):
        return (
            isinstance(other, PointG12)
            and self.curve_name == other.curve_name
            and self.value == other.value
        )

    def __hash__(self):
        return hash((self.curve_name, self.value))

    def __str__(self):
        return f"GT({self.curve_name})"

    def __repr__(self):
        return self.__str__()


_G1_CLASSES = {}
_G2_CLASSES = {}


def get_g1_class(curve_name):
    curve = CURVES[curve_name]
    if curve.name not in _G1_CLASSES:
        _G1_CLASSES[curve.name] = _make_g1(curve)
    return _G1_CLASSES[curve.name]


def get_g2_class(curve_name):
    curve = CURVES[curve_name]
    if curve.name not in _G2_CLASSES:
        _G2_CLASSES[curve.name] = _make_g2(curve)
    return _G2_CLASSES[curve.name]
