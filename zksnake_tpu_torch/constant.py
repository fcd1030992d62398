"""Field moduli for the supported curves (the same primes as the reference's
constant.py — there is nothing else to write; values shown in hex with their
usual structure)."""

# BN254 (alt_bn128): base field prime q and scalar field prime r
BN254_MODULUS = int(
    "30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47", 16
)
BN254_SCALAR_FIELD = int(
    "30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001", 16
)

# BLS12-381: base field prime q and scalar field prime r
BLS12_381_MODULUS = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
BLS12_381_SCALAR_FIELD = int(
    "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16
)
