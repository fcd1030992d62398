"""Byte-stream helpers for the proof/key wire formats.

The byte layouts themselves follow the reference
(upstream zksnake: python/zksnake/{groth16,plonk}/serialization.py): arkworks
compressed points (G2 twice the G1 width), u64 little-endian length prefixes
on vectors, 32-byte little-endian scalars. This module centralizes the
cursor/codec logic the reference re-implements inline in every class.
"""

from .ecc import EllipticCurve, curve_spec


class ByteReader:
    """Sequential reader over a serialized artifact."""

    def __init__(self, raw: bytes, curve: str):
        self._raw = raw
        self._pos = 0
        # parsing only: no bulk op runs here, so no card is needed
        self.E = EllipticCurve(curve, device="cpu")
        self.g1_len = curve_spec(curve).point_bytes

    def remaining(self) -> int:
        return len(self._raw) - self._pos

    def take(self, n: int) -> bytes:
        if self.remaining() < n:
            raise ValueError("Truncated serialization")
        chunk = self._raw[self._pos : self._pos + n]
        self._pos += n
        return chunk

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def scalar(self, width: int = 32) -> int:
        return int.from_bytes(self.take(width), "little")

    def g1(self):
        return self.E.from_hex(self.take(self.g1_len).hex())

    def g2(self):
        return self.E.from_hex(self.take(2 * self.g1_len).hex())

    def g1_vec(self):
        return [self.g1() for _ in range(self.u64())]

    def g2_vec(self):
        return [self.g2() for _ in range(self.u64())]

    def scalar_vec(self, width: int = 32):
        return [self.scalar(width) for _ in range(self.u64())]


class ByteWriter:
    """Sequential writer producing the same layouts."""

    def __init__(self):
        self._buf = bytearray()

    def point(self, p):
        self._buf += bytes(p.to_bytes())
        return self

    def u64(self, v: int):
        self._buf += v.to_bytes(8, "little")
        return self

    def scalar(self, v: int, width: int = 32):
        self._buf += v.to_bytes(width, "little")
        return self

    def point_vec(self, points):
        self.u64(len(points))
        for p in points:
            self.point(p)
        return self

    def scalar_vec(self, scalars, width: int = 32):
        self.u64(len(scalars))
        for v in scalars:
            self.scalar(v, width)
        return self

    def getvalue(self) -> bytes:
        return bytes(self._buf)
