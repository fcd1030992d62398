"""What a traced run records over its first proofs, and the Trace that the
per-layer readers (layer_metrics/) read.

The recorder turns on the port's phase spans (zksnake_tpu_torch.metrics,
which synchronise the device at each edge), opens its own span around each
prove() (PROVE_SPAN), notes the shape of every K1 and K2 call by wrapping
kernels.mont_mul and kernels.bucket_accumulate, and runs torch.profiler.
The wrappers only note what a call was given; the device times come from
the profiler's kernel events, by kernel name.
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

PROVE_SPAN = "portbench.prove"
OUTSIDE = "harness"  # an idle gap outside every span


class Trace:
    """The readings of one traced window. Device times in seconds."""

    def __init__(self):
        self.proofs = 0  # proofs with spans on
        self.spans_s = []  # host seconds of each of their prove() calls
        self.phases = {}  # the port's phase spans over them: name -> seconds
        self.profiled = 0  # proofs under the profiler
        self.top_phases = ()  # the spans directly inside prove()
        self.msm_phases = ()  # the MSM's spans, among the top ones
        self.kernels = []  # (name, seconds) of each device kernel
        self.busy_s = None
        self.window_s = None
        self.idle_by_span = {}
        self.k1_calls = []  # (limbs, lanes)
        self.k2_calls = []  # (group, limbs, bytes, additions)

    def kernel_seconds(self, pattern):
        """(count, seconds) of the device kernels whose name matches."""
        hits = [s for name, s in self.kernels if pattern.search(name)]
        return len(hits), sum(hits)

    def breakdown(self, top=10):
        ops = defaultdict(float)
        for name, s in self.kernels:
            ops[name[:160]] += s
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in rank(ops)],
                "idle_gaps": [[k, v] for k, v in rank(self.idle_by_span)]}


def _merged(starts, ends):
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def read_profile(events, spans, trace):
    """Fill trace's device readings from the profiler's events and the host
    spans (name, start_ns, end_ns) noted on the same clock: kernels (every
    device activity that is not a copy or a fill), busy time (the union of
    all device activity) over the window from the first PROVE_SPAN's start
    to the last one's end, and each idle gap's seconds under the innermost
    host span around its middle."""
    dev = [(e.name(), e.start_ns(), e.duration_ns()) for e in events
           if e.device_type().name == "CUDA" and not e.is_user_annotation()]
    proves = [s for s in spans if s[0] == PROVE_SPAN]
    if not proves:
        return
    w0 = min(s[1] for s in proves)
    w1 = max(s[2] for s in proves)
    trace.window_s = (w1 - w0) * 1e-9
    trace.kernels = [(n, d * 1e-9) for n, _, d in dev
                     if not n.startswith(("Memcpy", "Memset"))]
    if not dev:
        return
    st = np.array([d[1] for d in dev], dtype=np.int64)
    en = st + np.array([d[2] for d in dev], dtype=np.int64)
    st, en = np.clip(st, w0, w1), np.clip(en, w0, w1)
    bs, be = _merged(st, en)
    trace.busy_s = float((be - bs).sum()) * 1e-9
    gs = np.concatenate([[w0], be])
    ge = np.concatenate([bs, [w1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mid = (gs + ge) // 2
    label = np.full(len(mid), -1)
    width = np.full(len(mid), np.iinfo(np.int64).max)
    names = [s[0] for s in spans]
    for i, (_, a, b) in enumerate(spans):
        inside = (mid >= a) & (mid < b) & (b - a < width)
        label[inside] = i
        width[inside] = b - a
    idle = defaultdict(float)
    for lab, sec in zip(label, (ge - gs) * 1e-9):
        idle[names[lab] if lab >= 0 else OUTSIDE] += float(sec)
    trace.idle_by_span = dict(idle)


class Recorder:
    """The traced run's recording, in two stages over the window's first
    proofs: `spanned` proofs with only the port's phase spans on, for the
    layers' times; then `profiled` proofs under torch.profiler (CUDA
    activity only: kernels and copies, no host operator events, which would
    slow the host-bound prover down more), with the harness's and the
    port's spans noted on the host clock that the profiler's timestamps
    share, and the K1 and K2 calls noted. For proof i the traffic loop calls
    before(i), wraps the proof in proof(i), and calls after(i) once the
    proof's time is taken."""

    def __init__(self, device, top_phases, msm_phases, profiled, spanned):
        self.device = device
        self.profiled, self.spanned = profiled, spanned
        self.trace = Trace()
        self.trace.top_phases = tuple(top_phases)
        self.trace.msm_phases = tuple(msm_phases)
        self._spans = []  # (name, start_ns, end_ns) of the profiled proofs
        self._lens = []
        self._prof = None
        self._saved = None
        self._spanning = False

    def _wrap(self):
        from zksnake_tpu_torch import metrics
        from zksnake_tpu_torch.backend import kernels

        mont_mul, bucket, phase = kernels.mont_mul, kernels.bucket_accumulate, metrics.phase
        k1, k2, lens_kept, spans = (self.trace.k1_calls, self.trace.k2_calls, self._lens,
                                    self._spans)

        def mont_mul_noted(fs, a, b):
            k1.append((fs.nl, a.shape[1]))
            return mont_mul(fs, a, b)

        def bucket_noted(gs, pts, starts, lens):
            out = 3 * gs.group * gs.fs.nl * starts.numel()
            k2.append([gs.group, gs.fs.nl,
                       4 * (pts.numel() + starts.numel() + lens.numel() + out), None])
            lens_kept.append(lens)
            return bucket(gs, pts, starts, lens)

        @contextmanager
        def phase_noted(name, items=0):
            t0 = time.time_ns()
            with phase(name, items):
                yield
            spans.append((name, t0, time.time_ns()))

        self._saved = (kernels, mont_mul, bucket, metrics, phase)
        kernels.mont_mul, kernels.bucket_accumulate = mont_mul_noted, bucket_noted
        metrics.phase = phase_noted

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def before(self, i):
        """Open the stage that proof i starts (before its time is taken)."""
        from torch.profiler import ProfilerActivity, profile
        from zksnake_tpu_torch import metrics

        if i == 0 and self.spanned:
            metrics.enable()
            metrics.reset()
            self._spanning = True
        if i == self.spanned and self.profiled:
            self._close_spans()
            self._wrap()
            self._sync()
            cuda = self.device.type == "cuda"
            self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else
                                             ProfilerActivity.CPU])
            self._prof.__enter__()

    @contextmanager
    def proof(self, i):
        """Proof i of the window, under the harness's span."""
        import torch

        t0, w0 = time.perf_counter(), time.time_ns()
        with torch.profiler.record_function(PROVE_SPAN):
            yield
        if i < self.spanned:
            self.trace.spans_s.append(time.perf_counter() - t0)
            self.trace.proofs += 1
        elif i < self.spanned + self.profiled:
            self._spans.append((PROVE_SPAN, w0, time.time_ns()))

    def after(self, i):
        """Close the recording once proof i was the last it takes."""
        if i == self.spanned + self.profiled - 1:
            self.finish()

    def _close_spans(self):
        from zksnake_tpu_torch import metrics

        if self._spanning:
            self.trace.phases = {k: v["seconds"] for k, v in metrics.report().items()}
            metrics.enable(False)
            self._spanning = False

    def finish(self):
        """Close whatever is open (also where the window ended first) and
        return the Trace."""
        import torch

        self._close_spans()
        if self._prof is None:
            return self.trace
        self._sync()
        self._prof.__exit__(None, None, None)
        kernels, mont_mul, bucket, metrics, phase = self._saved
        kernels.mont_mul, kernels.bucket_accumulate = mont_mul, bucket
        metrics.phase = phase
        self.trace.profiled = sum(1 for s in self._spans if s[0] == PROVE_SPAN)
        if self._lens:
            adds = torch.stack([(t.long() - 1).clamp(min=0).sum() for t in self._lens]).tolist()
            for call, a in zip(self.trace.k2_calls, adds):
                call[3] = a
        self._lens.clear()
        read_profile(self._prof.profiler.kineto_results.events(), self._spans, self.trace)
        self._prof = None
        return self.trace
