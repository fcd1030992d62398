"""The share of the traced proofs' wall time in which no device activity
runs, from the profiler's trace, in percent."""


def read(trace):
    if trace.busy_s is None or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
