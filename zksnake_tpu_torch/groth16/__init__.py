"""Groth16 on the torch backend (same surface as zksnake_tpu.groth16)."""

from .protocol import Groth16
from .serialization import Proof, ProvingKey, VerifyingKey
