"""K2's share of its roofline (csrc/bucket.cu, bucket_chunks.cuh): the least
time of every K2 call in the traced proofs (peaks.bucket_bound_s: the
bucket additions that each call's run lengths need, at the fewest products
of any mixed-add formula) over the device time of K2's chunk and fold
kernels in the trace, in percent."""

import re

from portbench.peaks import bucket_bound_s

KERNEL = re.compile(r"\b(chunk_kernel|fold_kernel)\b")


def read(trace):
    count, seconds = trace.kernel_seconds(KERNEL)
    calls = trace.k2_calls
    if not calls or not count or seconds <= 0 or any(c[3] is None for c in calls):
        return None
    return 100.0 * sum(bucket_bound_s(*c) for c in calls) / seconds
