"""CUDA kernels a proof launches, the port's and torch's: the kernels in
the profiler's trace of the profiled proofs, over their count."""


def read(trace):
    if not trace.profiled or not trace.kernels:
        return None
    return len(trace.kernels) / trace.profiled
