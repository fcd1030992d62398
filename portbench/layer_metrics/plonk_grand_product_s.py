"""Seconds a PlonK proof spends on its permutation argument's grand product
(backend/plonk_device.py, round 2: the ratios sampled from the 4n
extension, their batched inversion, the prefix product and the
copy-constraint check): the port's plonk.prove.grand_product spans."""

SPAN = "plonk.prove.grand_product"


def read(trace):
    if not trace.proofs or SPAN not in trace.phases:
        return None
    return trace.phases[SPAN] / trace.proofs
