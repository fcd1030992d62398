"""Arithmetization front-ends (parity with reference
python/zksnake/arithmetization/__init__.py: Var, Field, ConstraintSystem,
R1CS; Plonkish and LayeredCircuit come with the PlonK and GKR ports)."""

from . import symbolic as circuit
from .symbolic import ConstraintSystem, Field
from .r1cs import R1CS

Var = Field
