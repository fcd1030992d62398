"""The yardstick of the roofline metrics: one NVIDIA H100 SXM's peaks and
the least time a K1 or K2 call could take.

HBM3 3.35 TB/s is NVIDIA's data sheet. The 32-bit integer multiply-add
rate is derived, not published: 64 per SM per clock (NVIDIA's throughput
table, compute capability 9.0) x 132 SMs x 1.98 GHz, the clock behind the
sheet's 67 TFLOP/s float32.
"""

HBM_BYTES_S = 3.35e12
IMAD_OPS_S = 132 * 64 * 1.98e9


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the slowest operation type over its peak rate. ops: [(count, rate)].
    (Frozen copy of chip_smoke.py::bound.)"""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max((n / rate for n, rate in ops), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cios_imads(nw):
    """32-bit integer multiply-adds of one CIOS product of nw-word elements
    (field.cuh::fmul: nw^2 for a*b, nw^2 for m*p, nw for m = t0 pinv), each
    32x32->64 multiply counted as two (its low and high halves).
    (Frozen copy of chip_smoke.py::cios_imads.)"""
    return 2 * (2 * nw * nw + nw)


# The fewest field products of a mixed addition (an affine point into a
# running sum) that any formula is known to need: batch-affine addition,
# the slope lambda = (y2 - y1) / (x2 - x1) with the inversion shared by a
# batch through Montgomery's trick (3 products a member), then lambda (y
# over x: 1), lambda^2 (1) and lambda (x1 - x3) (1): 6 products, against
# RCB15's 11 where 3b is small. A G2 product is 3 base-field products
# (Karatsuba over Fq2).
MIXED_ADD_PRODUCTS = 6


def mont_mul_bound_s(nl, lanes):
    """K1 (a, b -> a b R^-1 over nl 16-bit limbs in int32, `lanes` wide):
    a and b read once and the product written once, or its CIOS
    multiply-adds, whichever takes longer."""
    ms, _ = bound(3 * 4 * nl * lanes, [(lanes * cios_imads(nl // 2), IMAD_OPS_S)])
    return ms * 1e-3


def bucket_bound_s(group, nl, nbytes, adds):
    """K2 (a window's bucket sums of sorted affine points): its input and
    output bytes once, or `adds` mixed additions at MIXED_ADD_PRODUCTS
    products each, whichever takes longer."""
    prods = adds * MIXED_ADD_PRODUCTS * (1 if group == 1 else 3)
    ms, _ = bound(nbytes, [(prods * cios_imads(nl // 2), IMAD_OPS_S)])
    return ms * 1e-3

