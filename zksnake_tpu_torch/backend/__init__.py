"""Torch compute core of the port: limb-tensor field arithmetic, point
arithmetic, MSM, NTT, SpMV and the fused Groth16 prover, with the
hand-written CUDA kernels K1-K3 bound in kernels.py (sources in ../csrc)."""
