"""Seconds a proof spends in the MSMs' bucket accumulation (backend/msm.py:
K2, or K2m under the flag, with the chunk table its wrapper builds): the
port's msm.accumulate spans."""

SPAN = "msm.accumulate"


def read(trace):
    if not trace.proofs or SPAN not in trace.phases:
        return None
    return trace.phases[SPAN] / trace.proofs
