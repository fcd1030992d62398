"""Seconds a proof spends in the MSMs' reduction passes (backend/msm.py,
reduce_buckets: the top-window fold, the suffix scan, the window tree and
Horner across windows, launched from the host): the port's msm.reduce
spans."""

SPAN = "msm.reduce"


def read(trace):
    if not trace.proofs or SPAN not in trace.phases:
        return None
    return trace.phases[SPAN] / trace.proofs
