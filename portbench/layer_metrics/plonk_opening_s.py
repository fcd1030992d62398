"""Seconds a PlonK proof spends on its openings (backend/plonk_device.py,
round 5: the linearization as one weighted sum of 15 polynomials and the
two divisions by X - zeta and X - zeta omega, each a scan): the port's
plonk.prove.opening spans."""

SPAN = "plonk.prove.opening"


def read(trace):
    if not trace.proofs or SPAN not in trace.phases:
        return None
    return trace.phases[SPAN] / trace.proofs
