"""Vector-commitment interface.

Role parity with upstream zksnake: python/zksnake/commitment/vector/base.py.
Copy of zksnake_tpu/commitment/vector/base.py.
"""

from abc import ABC, abstractmethod


class VectorCommitmentScheme(ABC):
    """commit(vector) -> digest; open(vector, i) -> proof; verify checks
    membership of `element` at position `i` under the digest."""

    def __init__(self):
        self.order = None

    @abstractmethod
    def setup(self):
        ...

    @abstractmethod
    def commit(self, vector):
        ...

    @abstractmethod
    def open(self, vector, index):
        ...

    @abstractmethod
    def verify(self, commitment, proof, index, element):
        ...
