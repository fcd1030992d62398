"""Elements a PlonK proof transforms: the port's ntt_elements counter
(backend/ntt.py, ntt_device and intt_device: rows times length of each
transform) summed over the plonk.prove.round1..5 spans, which do not nest.

Read from the port's metrics.report() itself, as cells_msm_points is: when
the harness calls the readers, that report holds exactly the span proofs
(trace.proofs). A program without the counter reads nothing."""

ROUNDS = tuple(f"plonk.prove.round{i}" for i in range(1, 6))


def read(trace):
    from zksnake_tpu_torch import metrics

    report = metrics.report()
    counts = [report[r]["ntt_elements"] for r in ROUNDS if "ntt_elements" in report.get(r, {})]
    if not trace.proofs or not counts:
        return None
    return sum(counts) / trace.proofs
