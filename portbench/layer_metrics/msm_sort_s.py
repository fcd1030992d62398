"""Seconds a proof spends sorting the MSMs' points by window digit
(backend/msm.py, sort_by_digit: digits, top-window spreading, argsort,
gathers, run bounds): the port's msm.sort spans."""

SPAN = "msm.sort"


def read(trace):
    if not trace.proofs or SPAN not in trace.phases:
        return None
    return trace.phases[SPAN] / trace.proofs
