"""BN254 in plain Python: the base and scalar fields, Fq2 = Fq[u]/(u^2 + 1),
G1 (y^2 = x^3 + 3) and G2 over the D-type twist (y^2 = x^3 + 3/(9 + u)),
scalar multiplication, and the arkworks compressed encoding (x little-endian,
0x80 in the last byte where y is the larger of y and -y, 0x40 for the
point at infinity)."""

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FR_TWO_ADICITY = 28
FR_GENERATOR = 5

G1 = (1, 2)
G2 = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


class Fq:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)

    @staticmethod
    def larger(y):
        return y > P - y

    @staticmethod
    def encode(x):
        return x.to_bytes(32, "little")


class Fq2:
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)

    @staticmethod
    def inv(a):
        norm_inv = pow(a[0] * a[0] + a[1] * a[1], -1, P)
        return (a[0] * norm_inv % P, -a[1] * norm_inv % P)

    @staticmethod
    def larger(y):
        """Ordered as (c1, c0): y is larger than -y."""
        neg = (-y[0] % P, -y[1] % P)
        return (y[1], y[0]) > (neg[1], neg[0])

    @staticmethod
    def encode(x):
        return x[0].to_bytes(32, "little") + x[1].to_bytes(32, "little")


def _double(F, pt):
    """Jacobian doubling on y^2 = x^3 + b (a = 0)."""
    X, Y, Z = pt
    if Z == F.zero:
        return pt
    XX = F.mul(X, X)
    YY = F.mul(Y, Y)
    YYYY = F.mul(YY, YY)
    S = F.mul(F.add(F.mul(X, YY), F.mul(X, YY)), F.add(F.one, F.one))  # 4 X Y^2
    M = F.add(F.add(XX, XX), XX)  # 3 X^2
    X3 = F.sub(F.mul(M, M), F.add(S, S))
    eight = F.add(F.add(F.one, F.one), F.add(F.one, F.one))
    eight = F.add(eight, eight)
    Y3 = F.sub(F.mul(M, F.sub(S, X3)), F.mul(eight, YYYY))
    Z3 = F.mul(F.add(Y, Y), Z)
    return (X3, Y3, Z3)


def _add(F, p1, p2):
    """Jacobian addition, doubling where the two points are equal."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1 == F.zero:
        return p2
    if Z2 == F.zero:
        return p1
    Z1Z1 = F.mul(Z1, Z1)
    Z2Z2 = F.mul(Z2, Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        return _double(F, p1) if S1 == S2 else (F.one, F.one, F.zero)
    H = F.sub(U2, U1)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    Rr = F.sub(S2, S1)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.mul(Rr, Rr), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(F.mul(Z1, Z2), H)
    return (X3, Y3, Z3)


def scalar_mul(F, base, k):
    """k * base for an affine base; returns an affine point, or None for the
    point at infinity."""
    k %= R
    acc = (F.one, F.one, F.zero)
    pt = (base[0], base[1], F.one)
    while k:
        if k & 1:
            acc = _add(F, acc, pt)
        pt = _double(F, pt)
        k >>= 1
    X, Y, Z = acc
    if Z == F.zero:
        return None
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi)))


def encode(F, pt):
    """The compressed encoding of an affine point (None: infinity)."""
    if pt is None:
        b = bytearray(F.encode(F.zero))
        b[-1] |= 0x40
        return bytes(b)
    b = bytearray(F.encode(pt[0]))
    if F.larger(pt[1]):
        b[-1] |= 0x80
    return bytes(b)


def g1_bytes(k):
    """The encoding of k * G1."""
    return encode(Fq, scalar_mul(Fq, G1, k))


def g2_bytes(k):
    """The encoding of k * G2."""
    return encode(Fq2, scalar_mul(Fq2, G2, k))
