"""Seconds a proof spends in the protocol layer (groth16/protocol.py,
plonk/protocol.py) outside the fused prover: the harness's span around
prove() less the port's top-level phase spans inside it (witness upload,
proof assembly on the host, the transcript)."""


def read(trace):
    if not trace.proofs or not trace.top_phases:
        return None
    inner = sum(trace.phases.get(p, 0.0) for p in trace.top_phases)
    if inner == 0.0:
        return None
    return (sum(trace.spans_s) - inner) / trace.proofs
