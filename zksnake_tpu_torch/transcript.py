"""Fiat-Shamir transcript over blake2b.

Byte-exact behavioral parity with upstream zksnake: python/zksnake/transcript.py
(SURVEY.md §7 "hard parts" #3): every absorption and challenge derivation
below produces the identical byte stream, including the reference's quirks —
ints are absorbed as big-endian buffers whose BYTE length equals the value's
BIT length (reference transcript.py:47,51), and each challenge re-seeds the
hasher with the previous digest (:65-68). The code itself is original.

Copy of zksnake_tpu/transcript.py with the port's imports. Its
hash_to_scalar and hash_to_curve are host work: they take the curve's point
class (curves.point.get_g1_class) where the JAX package builds an
EllipticCurve, so they need no device.
"""

import hashlib

from .constant import BN254_SCALAR_FIELD
from .curves.point import get_g1_class
from .ecc import ispointG1, ispointG2


def hash_to_scalar(data: bytes, domain_separation_tag: bytes, curve: str = "BN254"):
    """Field element from bytes via the curve's hash_to_field."""
    return get_g1_class(curve).hash_to_field(domain_separation_tag, data)


def hash_to_curve(
    data: bytes, domain_separation_tag: bytes, curve: str = "BN254", size: int = 1
):
    """Derive `size` G1 points; each round re-hashes the previous point's
    compressed bytes (chain derivation, matching the reference)."""
    cls = get_g1_class(curve)
    out = []
    seed = data
    while len(out) < size:
        pt = cls.hash_to_curve(domain_separation_tag, seed)
        out.append(pt)
        seed = bytes(pt.to_bytes())
    return out[0] if size == 1 else out


def _int_to_transcript_bytes(value: int) -> bytes:
    # Quirk preserved from the reference: byte count == bit count, so e.g.
    # 5 (3 bits) absorbs as b"\x00\x00\x05" and 0 absorbs as b"".
    return value.to_bytes(value.bit_length(), "big")


class FiatShamirTranscript:
    """Absorb-only transcript; challenges are digests that also become the
    next hasher seed."""

    def __init__(self, label: bytes = b"", field: int = BN254_SCALAR_FIELD, alg: str = "blake2b"):
        self.alg = alg
        self.label = label
        self.field = field
        self.state = []
        self.hasher = hashlib.new(alg, label)

    def reset(self):
        self.hasher = hashlib.new(self.alg, self.label)

    def _encode(self, item) -> bytes:
        if isinstance(item, bytes):
            return item
        if isinstance(item, str):
            return item.encode()
        if isinstance(item, int):
            return _int_to_transcript_bytes(item)
        if ispointG1(item) or ispointG2(item):
            return bytes(item.to_bytes())
        raise TypeError(f"Type of {type(item)} is not supported as transcript")

    def append(self, data):
        if isinstance(data, list):
            # Only non-empty int/point lists are absorbable (per reference).
            head_ok = bool(data) and (
                isinstance(data[0], int) or ispointG1(data[0]) or ispointG2(data[0])
            )
            if not head_ok:
                raise TypeError(
                    f"Type of {type(data)} is not supported as transcript"
                )
            for item in data:
                self.hasher.update(self._encode(item))
        else:
            self.hasher.update(self._encode(data))

    def get_challenge(self) -> bytes:
        digest = self.hasher.digest()
        self.hasher = hashlib.new(self.alg, digest)
        return digest

    def get_challenge_scalar(self) -> int:
        return int.from_bytes(self.get_challenge(), "big") % self.field
