"""Point ops a proof runs in the MSMs' reduction passes: the port's
point_ops counter in its msm.reduce spans (each call of curve_ops' add,
double or add_affine counts one, whatever its batch).

Trace.phases keeps seconds only, so this reads the port's metrics.report()
itself. When the harness calls the readers, that report holds exactly the
span proofs (trace.proofs): the recorder resets it at the first proof and
turns metrics off before the profiled ones."""

SPAN = "msm.reduce"


def read(trace):
    from zksnake_tpu_torch import metrics

    ops = metrics.report().get(SPAN, {}).get("point_ops")
    if not trace.proofs or ops is None:
        return None
    return ops / trace.proofs
