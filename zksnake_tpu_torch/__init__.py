"""zksnake_tpu_torch: the zksnake-tpu prover on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The JAX package `zksnake_tpu` stays the reference. This package imports
nothing of it: it keeps its own copies of the host modules it needs
(constants, utils, the sparse array, limb codecs and the native codec,
curve parameters, points, pairings and hash-to-curve, the Circom parser,
the R1CS, Plonkish and layered-circuit front ends, the polynomials, the
QAP, the wire formats, the sumcheck and GKR, the commitments and
Bulletproofs), each differing from its original only in imports and device
seams, and ports the modules that bind to a backend: field and point
arithmetic, MSM, NTT, SpMV, MLE folds and the fused Groth16 and PlonK
provers. It imports torch and never jax. Entry points take a torch device,
"cuda" unless the caller asks for the CPU.

Entry points: zksnake_tpu_torch.groth16.Groth16(r1cs, curve, device),
plonk.Plonk, subprotocol.sumcheck.Sumcheck, subprotocol.gkr.GKR,
commitment.polynomial.KZG / IPA, subprotocol.bulletproofs.RangeProof.
"""

from .arithmetization import ConstraintSystem, R1CS, Var  # noqa: F401
from .constant import (  # noqa: F401
    BLS12_381_MODULUS,
    BLS12_381_SCALAR_FIELD,
    BN254_MODULUS,
    BN254_SCALAR_FIELD,
)
