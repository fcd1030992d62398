"""Per-phase metrics for the port, with the JAX package's API and phase
names (groth16.prove.qap, groth16.prove.msm, groth16.setup.*), plus nested
spans and counters.

    from zksnake_tpu_torch import metrics

    metrics.enable()              # or ZKSNAKE_METRICS=1
    with metrics.phase("groth16.prove.msm", items=n):
        with metrics.phase("msm.reduce"):
            metrics.count("point_ops")
    print(metrics.report())

When enabled, each phase synchronizes the CUDA device at its start and end,
so its time covers the device work queued inside it, and opens a
torch.profiler.record_function range of the same name for traces. Phases
nest: report() gives each name its inclusive `seconds`, its `self_seconds`
(less its direct children's), `calls`, `items`, the `parent` it last ran
under, and every counter that count() added while it was open. Disabled
(the default), `phase` and `count` are no-ops.

Code that opens a phase looks it up on this module at call time
(`metrics.phase(...)`, or an import inside the function), so that a caller
may wrap the attribute to note every span.
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_ENABLED = os.environ.get("ZKSNAKE_METRICS", "0") == "1"
_STATS = defaultdict(lambda: {"seconds": 0.0, "self_seconds": 0.0, "calls": 0, "items": 0,
                              "parent": None, "counts": defaultdict(int)})
_OPEN = []  # the open phases, innermost last: [name, seconds of its direct children]


def enable(on=True):
    global _ENABLED
    _ENABLED = on


def enabled():
    return _ENABLED


def reset():
    _STATS.clear()


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def phase(name, items=0):
    """Time a named phase; `items` feeds the items/s throughput counter."""
    if not _ENABLED:
        yield
        return
    _sync()
    parent = _OPEN[-1][0] if _OPEN else None
    frame = [name, 0.0]
    _OPEN.append(frame)
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            _OPEN.pop()
            if _OPEN:
                _OPEN[-1][1] += dt
            s = _STATS[name]
            s["seconds"] += dt
            s["self_seconds"] += dt - frame[1]
            s["calls"] += 1
            s["items"] += items
            s["parent"] = parent


def count(name, n=1):
    """Add n to the counter `name` of every open phase (inclusive, as
    seconds are). Outside any phase, or disabled, nothing is recorded."""
    if not _ENABLED:
        return
    for span, _ in _OPEN:
        _STATS[span]["counts"][name] += n


def report():
    """Snapshot of accumulated phase stats with derived throughput."""
    out = {}
    for name, s in sorted(_STATS.items()):
        entry = {"seconds": round(s["seconds"], 6),
                 "self_seconds": round(s["self_seconds"], 6), "calls": s["calls"]}
        if s["parent"] is not None:
            entry["parent"] = s["parent"]
        if s["items"]:
            entry["items"] = s["items"]
            if s["seconds"] > 0:
                entry["items_per_s"] = round(s["items"] / s["seconds"], 1)
        entry.update(s["counts"])
        out[name] = entry
    return out
