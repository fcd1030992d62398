from .merkle import Merkle
from .base import VectorCommitmentScheme
