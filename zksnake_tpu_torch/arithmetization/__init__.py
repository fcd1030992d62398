"""Arithmetization front-ends (parity with reference
python/zksnake/arithmetization/__init__.py: Var, Field, ConstraintSystem,
R1CS, Plonkish; LayeredCircuit comes with the GKR port)."""

from . import symbolic as circuit
from .symbolic import ConstraintSystem, Field
from .r1cs import R1CS
from .plonkish import Plonkish

Var = Field
