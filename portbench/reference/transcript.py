"""The PlonK prover's Fiat-Shamir transcript, from its definition: blake2b
over the absorbed items; an int is absorbed big-endian in as many bytes as
it has bits (so 0 absorbs nothing), a point as its compressed encoding; a
challenge is the digest mod r, and the digest seeds the next hasher."""

import hashlib

from .bn254 import R


class Transcript:
    def __init__(self):
        self.hasher = hashlib.blake2b(b"")

    def point(self, encoded):
        self.hasher.update(encoded)

    def scalar(self, value):
        self.hasher.update(value.to_bytes(value.bit_length(), "big"))

    def challenge(self):
        digest = self.hasher.digest()
        self.hasher = hashlib.blake2b(digest)
        return int.from_bytes(digest, "big") % R
