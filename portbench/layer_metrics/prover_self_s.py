"""Seconds a proof spends in the fused prover (backend/groth16_device.py,
backend/plonk_device.py: the QAP, NTTs, SpMV and the PlonK rounds) outside
the MSM: the top-level phase spans less the MSM spans among them."""


def read(trace):
    top = [trace.phases[p] for p in trace.top_phases if p in trace.phases]
    if not trace.proofs or not top:
        return None
    return (sum(top) - sum(trace.phases.get(p, 0.0) for p in trace.msm_phases)) / trace.proofs
