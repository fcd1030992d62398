"""blake2b Merkle-tree vector commitment.

Role parity with upstream zksnake: python/zksnake/commitment/vector/merkle.py
(odd node paired with its own duplicate, so roots match the reference
byte-for-byte on power-of-two vectors). One deliberate divergence, kept from
round 1: the reference's `open` SKIPS a proof level whenever the node has no
sibling, which desynchronizes the verifier's index walk on odd tails (a
latent untested bug there); here the duplicated node itself is emitted as the
sibling so any vector length round-trips.

Copy of zksnake_tpu/commitment/vector/merkle.py: host hashing, no device.
"""

import hashlib

from .base import VectorCommitmentScheme


class Merkle(VectorCommitmentScheme):
    def __init__(self, alg: str = "blake2b"):
        super().__init__()
        self.alg = alg

    def setup(self):
        pass

    def _h(self, data: bytes) -> bytes:
        return hashlib.new(self.alg, data).digest()

    def _levels(self, vector):
        """All tree levels, leaves first, root-level last."""
        level = [self._h(item) for item in vector]
        out = [level]
        while len(level) > 1:
            # odd tail duplicates the last node
            padded = level + level[-1:] if len(level) & 1 else level
            level = [
                self._h(padded[i] + padded[i + 1]) for i in range(0, len(padded), 2)
            ]
            out.append(level)
        return out

    def commit(self, vector) -> bytes:
        return self._levels(vector)[-1][0]

    def open(self, vector, index: int):
        path = []
        for level in self._levels(vector)[:-1]:
            sibling = index ^ 1
            path.append(level[sibling] if sibling < len(level) else level[index])
            index >>= 1
        return path

    def verify(self, commitment, proof, index: int, element) -> bool:
        node = self._h(element)
        for sibling in proof:
            pair = node + sibling if index & 1 == 0 else sibling + node
            node = self._h(pair)
            index >>= 1
        return node == commitment
