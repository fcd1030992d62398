"""Hash-to-curve (RFC 9380) for G1 of BN254 and BLS12-381.

Parity target: reference uses `bn254_hash2curve::HashToG1` for BN254 (RFC 9380
SVDW suite) and arkworks `MapToCurveBasedHasher<.., WBMap>` for BLS12-381
(upstream zksnake: src/bn254/curve.rs:154-165, src/bls12_381/curve.rs:157-175).

We implement expand_message_xmd(SHA-256) + hash_to_field + per-curve maps:
SVDW for BN254 (the `bn254_hash2curve` crate's suite) and the WB suite for
BLS12-381 G1 — simplified SSWU onto the 11-isogenous curve E' followed by
the isogeny map to E and fast cofactor clearing by h_eff = 1 - x (RFC 9380
8.8.1), matching arkworks' WBMap bit-for-bit. The isogeny constants are
derived, not transcribed: see scripts/derive_iso11.py and
_iso11_bls12_381.py.

Copy of zksnake_tpu/curves/hash2curve.py: host bigint work, no device.
"""

import hashlib


def _expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    b_in_bytes = 32
    r_in_bytes = 64
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255:
        raise ValueError("expand_message_xmd: requested too many bytes")
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * r_in_bytes
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(x ^ y for x, y in zip(b0, prev))
        blocks.append(hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_field_fq(msg: bytes, dst: bytes, curve, count: int):
    """RFC 9380 hash_to_field over the base field Fq (arkworks
    DefaultFieldHasher<Sha256, 128> semantics: big-endian chunks mod p)."""
    p = curve.p
    L = -(-(p.bit_length() + 128) // 8)
    uniform = _expand_message_xmd(msg, dst, count * L)
    return [
        int.from_bytes(uniform[i * L : (i + 1) * L], "big") % p for i in range(count)
    ]


def _sgn0(x):
    return x & 1


_SVDW_CACHE = {}


def _svdw_constants(curve):
    """Find Z and precompute the SVDW constants (RFC 9380 section 6.6.1 / H.3)."""
    if curve.name in _SVDW_CACHE:
        return _SVDW_CACHE[curve.name]
    p = curve.p
    b = curve.b

    def g(x):
        return (x * x % p * x + b) % p

    def is_square(x):
        return x == 0 or pow(x, (p - 1) // 2, p) == 1

    def sqrt(x):
        r = pow(x, (p + 1) // 4, p)
        assert r * r % p == x
        return r

    # find_z_svdw (RFC 9380 H.3)
    Z = None
    ctr = 1
    while Z is None:
        for cand in (ctr, -ctr % p):
            gz = g(cand)
            if gz == 0:
                continue
            t = (3 * cand * cand) % p  # 3Z^2 + 4A, A = 0
            if t == 0:
                continue
            hz = (-(3 * cand * cand) * pow(4 * gz % p, -1, p)) % p
            if hz == 0 or not is_square(hz):
                continue
            if is_square(gz) or is_square(g(-cand * pow(2, -1, p) % p)):
                Z = cand
                break
        ctr += 1

    gz = g(Z)
    c1 = gz
    c2 = (-Z * pow(2, -1, p)) % p
    t = (3 * Z * Z) % p
    c3 = sqrt((-gz * t) % p)
    if _sgn0(c3) != 0:
        c3 = (-c3) % p
    c4 = (-4 * gz * pow(t, -1, p)) % p
    _SVDW_CACHE[curve.name] = (Z, c1, c2, c3, c4)
    return _SVDW_CACHE[curve.name]


def _map_to_curve_svdw(u, curve):
    p = curve.p
    b = curve.b
    Z, c1, c2, c3, c4 = _svdw_constants(curve)

    def is_square(x):
        return x == 0 or pow(x, (p - 1) // 2, p) == 1

    tv1 = u * u % p * c1 % p
    tv2 = (1 + tv1) % p
    tv1 = (1 - tv1) % p
    tv3 = tv1 * tv2 % p
    tv3 = pow(tv3, -1, p) if tv3 != 0 else 0
    tv4 = u * tv1 % p * tv3 % p * c3 % p
    x1 = (c2 - tv4) % p
    gx1 = (x1 * x1 % p * x1 + b) % p
    e1 = is_square(gx1)
    x2 = (c2 + tv4) % p
    gx2 = (x2 * x2 % p * x2 + b) % p
    e2 = is_square(gx2) and not e1
    x3 = tv2 * tv2 % p * tv3 % p
    x3 = x3 * x3 % p * c4 % p
    x3 = (x3 + Z) % p
    x = x3
    if e1:
        x = x1
    elif e2:
        x = x2
    gx = (x * x % p * x + b) % p
    y = pow(gx, (p + 1) // 4, p)
    assert y * y % p == gx
    if _sgn0(u) != _sgn0(y):
        y = (-y) % p
    return x, y


# --- BLS12-381 G1 WB suite: simplified SSWU on E' + 11-isogeny to E ---

# SSWU-friendly curve E': y^2 = x^3 + A'x + B' (RFC 9380 8.8.1; validated by
# the group-order assertion in scripts/derive_iso11.py)
_BLS_SSWU_A = 0x144698A3B8E9433D693A02C96D4982B0EA985383EE66A8D8E8981AEFD881AC98936F8DA0E0F97F5CF428082D584C1D
_BLS_SSWU_B = 0x12E2908D11688030018B12E8753EEE3B2016C1F0F24F4070A0B9C14FCEF35EF55A23215A316CEAA5D1CC48E98E172BE0
_BLS_SSWU_Z = 11
# fast cofactor clearing multiplier h_eff = 1 - x_BLS (arkworks G1 clear_cofactor)
_BLS_H_EFF = 0xD201000000010001


def _map_to_curve_sswu_bls(u, p):
    """Simplified SSWU (RFC 9380 6.6.2) onto E'; returns affine (x', y')."""
    A, B, Z = _BLS_SSWU_A, _BLS_SSWU_B, _BLS_SSWU_Z
    t1 = Z * u % p * u % p
    t2 = (t1 * t1 + t1) % p
    if t2 == 0:
        x1 = B * pow(Z * A % p, -1, p) % p
    else:
        x1 = (p - B) * pow(A, -1, p) % p * ((1 + pow(t2, -1, p)) % p) % p
    gx1 = (x1 * x1 % p * x1 + A * x1 + B) % p
    if pow(gx1, (p - 1) // 2, p) != p - 1:
        x, gx = x1, gx1
    else:
        x = t1 * x1 % p
        gx = (x * x % p * x + A * x + B) % p
    y = pow(gx, (p + 1) // 4, p)
    assert y * y % p == gx
    if _sgn0(u) != _sgn0(y):
        y = (p - y) % p
    return x, y


def _iso11_map(x, y, p):
    """Apply the 11-isogeny E' -> E (rational map with derived coefficients)."""
    from ._iso11_bls12_381 import ISO11_X_DEN, ISO11_X_NUM, ISO11_Y_DEN, ISO11_Y_NUM

    def horner(tab):
        acc = 0
        for c in reversed(tab):
            acc = (acc * x + c) % p
        return acc

    xn, xd = horner(ISO11_X_NUM), horner(ISO11_X_DEN)
    yn, yd = horner(ISO11_Y_NUM), horner(ISO11_Y_DEN)
    return xn * pow(xd, -1, p) % p, y * yn % p * pow(yd, -1, p) % p


def hash_to_curve_g1(msg: bytes, dst: bytes, curve, point_cls):
    """Full RO hash-to-curve: two field elements, two maps, add, clear cofactor.

    BN254: SVDW + multiply by cofactor (=1, no-op) — the reference crate's suite.
    BLS12-381: SSWU/iso-11 + multiply by h_eff — arkworks WBMap semantics.
    """
    u = hash_to_field_fq(msg, dst, curve, 2)
    if curve.name == "BLS12_381":
        p = curve.p
        pts = []
        for ui in u:
            xp, yp = _map_to_curve_sswu_bls(ui, p)
            pts.append(_iso11_map(xp, yp, p))
        (x0, y0), (x1, y1) = pts
        h = _BLS_H_EFF
    else:
        x0, y0 = _map_to_curve_svdw(u[0], curve)
        x1, y1 = _map_to_curve_svdw(u[1], curve)
        h = curve.g1_cofactor
    q0 = point_cls._from_jac((x0, y0, 1))
    q1 = point_cls._from_jac((x1, y1, 1))
    r = q0 + q1
    if h != 1:
        # scalar mul by the clearing multiplier itself (no mod-r reduction)
        from .point import _jac_scalar_mul

        r = point_cls._from_jac(_jac_scalar_mul(point_cls.FIELD, point_cls.B, r._jac, h))
    return r
