"""PlonK (parity with upstream zksnake: python/zksnake/plonk/__init__.py),
proving on a torch device."""

from .protocol import Plonk
from .serialization import Proof, ProvingKey, VerifyingKey
