"""Windows the MSM's reduction takes a request: the port's msm_windows
counter (backend/msm.py, msm_pippenger_many: M W over point tensors, one a
job over a fixed-base table) in its kzg.cells.msm spans.

Read from the port's metrics.report() itself, as cells_msm_points is: when
the harness calls the readers, that report holds exactly the span proofs
(trace.proofs). A program without the counter reads nothing."""

SPAN = "kzg.cells.msm"


def read(trace):
    from zksnake_tpu_torch import metrics

    windows = metrics.report().get(SPAN, {}).get("msm_windows")
    if not trace.proofs or windows is None:
        return None
    return windows / trace.proofs
