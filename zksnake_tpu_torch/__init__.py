"""zksnake_tpu_torch: the zksnake-tpu prover on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The JAX package `zksnake_tpu` stays the reference. This package imports
nothing of it: it keeps its own copies of the host modules it needs
(constants, utils, the sparse array, limb codecs and the native codec,
curve parameters, points and pairings, the Circom parser, the R1CS front
end, the univariate polynomials, the QAP and the wire formats), each
differing from its original only in imports and device seams, and ports
the modules that bind to a backend: field and point arithmetic, MSM, NTT,
SpMV and the fused Groth16 prover. It imports torch and never jax. Entry
points take a torch device, "cuda" unless the caller asks for the CPU.

Entry point: zksnake_tpu_torch.groth16.Groth16(r1cs, curve, device).
"""

from .arithmetization import ConstraintSystem, R1CS, Var  # noqa: F401
from .constant import (  # noqa: F401
    BLS12_381_MODULUS,
    BLS12_381_SCALAR_FIELD,
    BN254_MODULUS,
    BN254_SCALAR_FIELD,
)
