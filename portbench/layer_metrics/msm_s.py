"""Seconds a proof spends in the MSM (backend/msm.py): the port's
*.prove.msm spans."""


def read(trace):
    got = [trace.phases[p] for p in trace.msm_phases if p in trace.phases]
    if not trace.proofs or not got:
        return None
    return sum(got) / trace.proofs
