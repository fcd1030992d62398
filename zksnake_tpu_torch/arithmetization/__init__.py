"""Arithmetization front-ends (parity with reference
python/zksnake/arithmetization/__init__.py: Var, Field, ConstraintSystem,
R1CS, Plonkish, LayeredCircuit)."""

from . import symbolic as circuit
from .symbolic import ConstraintSystem, Field
from .r1cs import R1CS
from .plonkish import Plonkish
from .layered_circuit import LayeredCircuit

Var = Field
