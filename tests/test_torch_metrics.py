"""The port's metrics (zksnake_tpu_torch.metrics): nested spans with self
time and inclusive counters, no-ops when disabled, and the MSM's spans and
counters on a CPU MSM (the kernels' plain versions); the benchmark's reader
of the MSM's window counter."""

import time

import numpy as np
import pytest
import torch

from zksnake_tpu_torch import metrics
from zksnake_tpu_torch.backend import kernels
from zksnake_tpu_torch.backend import msm as tmsm
from zksnake_tpu_torch.backend.curve_ops import get_group_spec

from torch_support import CURVE, PORT

REDUCE_CHILDREN = ("msm.reduce.top", "msm.reduce.scan", "msm.reduce.tree", "msm.reduce.horner")


@pytest.fixture(autouse=True)
def metrics_off():
    metrics.enable(False)
    metrics.reset()
    yield
    metrics.enable(False)
    metrics.reset()


def reduce_point_ops(r, c, nbits=256):
    """Point ops of one reduction pass (reduce_buckets), by stage: the
    top-window fold over S_top sub-buckets, the suffix scan, the window
    tree, and Horner's c doublings and one add a window."""
    W = -(-nbits // c)
    B2 = 1 << (c - 1)
    V_top = (r >> (c * (W - 1))) + 2
    V_cap = 1 << (V_top - 1).bit_length()
    S_top = B2 // V_cap if V_cap < B2 else 1
    return {"msm.reduce.top": S_top.bit_length() - 1, "msm.reduce.scan": c - 1,
            "msm.reduce.tree": c - 1, "msm.reduce.horner": c * W + W}


def test_nested_spans_hold_their_children():
    metrics.enable()
    with metrics.phase("outer", items=5):
        time.sleep(0.01)
        metrics.count("ops", 2)
        for _ in range(2):
            with metrics.phase("inner"):
                time.sleep(0.01)
                metrics.count("ops")
                metrics.count("other", 3)
    rep = metrics.report()
    outer, inner = rep["outer"], rep["inner"]
    assert inner["parent"] == "outer" and "parent" not in outer
    assert (outer["calls"], inner["calls"], outer["items"]) == (1, 2, 5)
    assert inner["seconds"] <= outer["seconds"]
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"], abs=2e-6)
    assert outer["self_seconds"] >= 0.01
    assert inner["self_seconds"] == inner["seconds"]
    assert (outer["ops"], inner["ops"]) == (4, 2)
    assert (outer["other"], inner["other"]) == (6, 6)


def test_count_outside_spans_or_disabled_records_nothing():
    metrics.enable()
    metrics.count("ops", 7)
    assert metrics.report() == {}
    metrics.enable(False)
    with metrics.phase("a"):
        metrics.count("ops")
    assert metrics.report() == {}


def test_disabled_report_stays_empty():
    with metrics.phase("a", items=3):
        with metrics.phase("b"):
            metrics.count("ops")
    assert metrics.report() == {}
    assert metrics._OPEN == []


def test_closed_form_at_the_benchmark_size():
    """2^16 points: c = 11, W = 24, S_top = 256, so 316 point ops a pass."""
    assert tmsm._pick_window(1 << 16) == 11
    assert sum(reduce_point_ops(CURVE.r, 11).values()) == 316


def _msm_jobs(gs, n, seed):
    g = PORT.g1()
    points, P = [], g * 7
    for _ in range(n):
        points.append(P)
        P = P + g * (11 + seed)
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % CURVE.r for _ in range(n)]
    return (gs.points_to_device(points, "cpu"), tmsm.scalars_to_device(scalars, CURVE.r, "cpu"))


@pytest.fixture(scope="module", params=[3, 5])
def msm_runs(request):
    """Two G1 MSMs of 64 points in one msm_pippenger_many at window c,
    with metrics off, then on: (c, result off, result on, report on)."""
    c = request.param
    gs = get_group_spec(CURVE, 1)
    jobs = [_msm_jobs(gs, 64, 1), _msm_jobs(gs, 64, 2)]
    metrics.enable(False)
    metrics.reset()
    off = tmsm.msm_pippenger_many(gs, jobs, c)
    assert metrics.report() == {}
    metrics.enable()
    try:
        on = tmsm.msm_pippenger_many(gs, jobs, c)
        rep = metrics.report()
    finally:
        metrics.enable(False)
        metrics.reset()
    return c, off, on, rep


def test_msm_spans_split_every_pass(msm_runs):
    _, _, _, rep = msm_runs
    assert rep["msm.sort"]["calls"] == 2 and rep["msm.accumulate"]["calls"] == 2
    assert rep["msm.reduce"]["calls"] == 1
    for name in REDUCE_CHILDREN:
        assert rep[name]["calls"] == 1 and rep[name]["parent"] == "msm.reduce"
    children = sum(rep[name]["seconds"] for name in REDUCE_CHILDREN)
    assert children <= rep["msm.reduce"]["seconds"] + 1e-5
    assert rep["msm.reduce"]["self_seconds"] == pytest.approx(
        rep["msm.reduce"]["seconds"] - children, abs=1e-5)


def test_msm_reduce_point_ops_closed_form(msm_runs):
    c, _, _, rep = msm_runs
    want = reduce_point_ops(CURVE.r, c)
    assert want["msm.reduce.top"] > 0  # both sizes spread the top window
    assert rep["msm.reduce"]["point_ops"] == sum(want.values())
    for name, ops in want.items():
        assert rep[name]["point_ops"] == ops


def test_msm_result_same_with_metrics_on_and_off(msm_runs):
    _, off, on, _ = msm_runs
    for a, b in zip(get_group_spec(CURVE, 1).leaves(off), get_group_spec(CURVE, 1).leaves(on)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_msm_reduce_on_the_cpu_is_the_plain_version(msm_runs):
    """On CPU tensors no reduction pass is the kernel's: the plain version's
    spans, no msm.reduce.window and no reduce_kernel_passes."""
    _, _, _, rep = msm_runs
    assert "msm.reduce.window" not in rep
    assert all("reduce_kernel_passes" not in entry for entry in rep.values())


def test_msm_over_point_tensors_counts_every_window_and_no_fixed_points():
    """A call over point tensors: msm_windows is the sum over its jobs of W
    (in msm.reduce and every span around it), msm_fixed_points 0."""
    gs = get_group_spec(CURVE, 1)
    jobs = [_msm_jobs(gs, 16, 1), _msm_jobs(gs, 16, 2), _msm_jobs(gs, 8, 3)]
    metrics.enable()
    with metrics.phase("caller"):
        tmsm.msm_pippenger_many(gs, jobs, 5)
    rep = metrics.report()
    windows = 3 * -(-256 // 5)
    assert rep["caller"]["msm_windows"] == rep["msm.reduce"]["msm_windows"] == windows
    assert (rep["caller"]["msm_points"], rep["caller"]["msm_fixed_points"]) == (40, 0)


def test_cells_msm_windows_reader_reads_the_counter_in_the_msm_spans():
    """portbench's cells_msm_windows: msm_windows in kzg.cells.msm a span
    proof; nothing where the program has no such counter or no proofs."""
    from portbench import harness
    from portbench.trace import Trace

    def read(proofs):
        t = Trace()
        t.proofs = proofs
        return harness.module("layer_metrics", "cells_msm_windows").read(t)

    metrics.enable()
    for _ in range(2):  # two span proofs of one call each
        with metrics.phase("kzg.cells.msm"):
            metrics.count("msm_points", 99)
            with metrics.phase("msm.reduce"):
                metrics.count("msm_windows", 774)
    with metrics.phase("groth16.prove.msm"):
        with metrics.phase("msm.reduce"):
            metrics.count("msm_windows", 120)  # outside the cells' spans
    metrics.enable(False)
    assert read(2) == 774
    assert read(0) is None
    metrics.reset()
    metrics.enable()
    with metrics.phase("kzg.cells.msm"):
        metrics.count("msm_points", 99)  # a parent that counts no windows
    metrics.enable(False)
    assert read(1) is None


def test_bucket_reduce_on_the_cpu_takes_the_plain_version():
    """kernels.bucket_reduce on CPU tensors: no launch counted, the plain
    version's spans and point ops, and the MSMs' sums: window w's buckets
    S_{w,b} give sum_w 2^(c (W - 1 - w)) sum_b (b + 1) S_{w,b}, the top
    window's sub-bucket lanes j V_cap + b folded into lane b first."""
    c, M, W, S_top, V_cap = 3, 2, 2, 2, 2
    B2 = 1 << (c - 1)
    gs = get_group_spec(CURVE, 1)
    g = PORT.g1()
    pool = [g * (i + 3) for i in range(7)] + [type(g).identity()]
    idx = np.random.default_rng(5).integers(0, len(pool), size=(M, W, B2))
    idx[0, 0, 1] = idx[0, 0, 0]  # an add of P + P in the top fold
    dev = gs.points_to_device(pool, "cpu")
    buckets = torch.stack([t[:, torch.from_numpy(idx)] for t in gs.leaves(dev)]).contiguous()
    before = dict(kernels.LAUNCHES)
    metrics.enable()
    got = kernels.bucket_reduce(gs, buckets, c, S_top, V_cap)
    rep = metrics.report()
    assert kernels.LAUNCHES == before
    assert sorted(rep) == sorted(REDUCE_CHILDREN)
    assert {name: rep[name]["point_ops"] for name in REDUCE_CHILDREN} == {
        "msm.reduce.top": 1, "msm.reduce.scan": c - 1, "msm.reduce.tree": c - 1,
        "msm.reduce.horner": W * (c + 1)}
    assert all("reduce_kernel_passes" not in entry for entry in rep.values())
    for m, point in enumerate(gs.points_from_device(gs.unflatten(list(got)), type(g))):
        total = type(g).identity()
        for w in range(W):
            lanes = [pool[i] for i in idx[m, w]]
            if w == 0:
                lanes = [lanes[b] + lanes[b + V_cap] for b in range(V_cap)]
            window = type(g).identity()
            for b, S in enumerate(lanes):
                window = window + S * (b + 1)
            total = total * (1 << c) + window
        assert point == total

