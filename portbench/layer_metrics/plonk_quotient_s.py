"""Seconds a PlonK proof spends on its quotient (backend/plonk_device.py,
round 3: Z_omega, the 8n extension of nom, den, Z and Z_omega with its
products and inverse NTT, (Z - 1) L1 over 4n, and the division by X^n - 1
with its remainder check): the port's plonk.prove.quotient spans."""

SPAN = "plonk.prove.quotient"


def read(trace):
    if not trace.proofs or SPAN not in trace.phases:
        return None
    return trace.phases[SPAN] / trace.proofs
