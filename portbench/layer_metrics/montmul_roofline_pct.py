"""K1's share of its roofline (csrc/montmul.cu): the least time of every
K1 call in the traced proofs (peaks.mont_mul_bound_s, from each call's
shape) over the device time of K1's kernels in the trace, in percent."""

import re

from portbench.peaks import mont_mul_bound_s

KERNEL = re.compile(r"\bmontmul_kernel\b")


def read(trace):
    count, seconds = trace.kernel_seconds(KERNEL)
    if not trace.k1_calls or count != len(trace.k1_calls) or seconds <= 0:
        return None
    return 100.0 * sum(mont_mul_bound_s(nl, lanes) for nl, lanes in trace.k1_calls) / seconds
