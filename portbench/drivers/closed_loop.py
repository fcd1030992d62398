"""One stream of back-to-back proofs (concurrency 1), each on a witness no
earlier request of the run used.

Parameters (traffic file): warmup, the proofs made before the window (on
requests 0 .. warmup - 1); pool_prove_s, the shortest proof time the
witness pool is sized for: set-up makes ceil(seconds / pool_prove_s) +
pool_spare requests' witnesses, and the window makes any further one
between proofs, outside every proof's time; span_proofs and trace_proofs,
the proofs that a traced run records with only the spans on and then
under the profiler (the first of the window, trace.Recorder).

The window runs from the first timed proof to the end of the proof that
crosses `seconds`. Each proof is timed on the host clock from the call to
the return of prove() and the synchronisation after it.
"""

import contextlib
import math
import time


class Window:
    def __init__(self):
        self.records = []  # (request, seconds or None, proof or the exception)
        self.t_first = None  # perf_counter at the first timed proof's start
        self.seconds = None  # from the first proof's start to the last one's end
        self.made_in_window = 0
        self.trace = None
        self.setup_stages = {}  # seconds of the pool and of the warm-up


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def run(protocol, traffic, seconds, recorder=None):
    if traffic.get("concurrency", 1) != 1:
        raise ValueError("closed_loop drives one stream")
    device = protocol.device
    warm = traffic["warmup"]
    pool_n = math.ceil(seconds / traffic["pool_prove_s"]) + traffic["pool_spare"]
    out = Window()
    t0 = time.perf_counter()
    pool = {k: protocol.request(k) for k in range(warm, warm + pool_n)}
    t1 = time.perf_counter()
    for k in range(warm):
        protocol.prove(protocol.request(k))
        _sync(device)
    out.setup_stages = {"pool": t1 - t0, "warmup": time.perf_counter() - t1}
    k = warm
    while out.t_first is None or time.perf_counter() - out.t_first < seconds:
        inputs = pool.pop(k, None)
        if inputs is None:
            inputs = protocol.request(k)
            out.made_in_window += 1
        if recorder:
            recorder.before(k - warm)
        t0 = time.perf_counter()
        if out.t_first is None:
            out.t_first = t0
        try:
            with recorder.proof(k - warm) if recorder else contextlib.nullcontext():
                proof = protocol.prove(inputs)
                _sync(device)
            out.records.append((k, time.perf_counter() - t0, proof))
        except Exception as exc:  # a failed request counts against the run
            out.records.append((k, None, exc))
        if recorder:
            recorder.after(k - warm)
        k += 1
    out.seconds = time.perf_counter() - out.t_first
    if recorder:
        out.trace = recorder.finish()
    return out
