"""The MSM layer's readers: the msm.sort, msm.accumulate and msm.reduce
spans a proof, and the point_ops counter of msm.reduce read from the
port's metrics.report()."""

import pytest

from portbench import harness
from portbench.trace import Trace

SPAN_READERS = ("msm_sort_s", "msm_accumulate_s", "msm_reduce_s")


@pytest.fixture(autouse=True)
def metrics_off():
    from zksnake_tpu_torch import metrics

    metrics.enable(False)
    metrics.reset()
    yield
    metrics.enable(False)
    metrics.reset()


def _trace(**kw):
    t = Trace()
    for k, v in kw.items():
        setattr(t, k, v)
    return t


def _read(name, trace):
    return harness.module("layer_metrics", name).read(trace)


def test_msm_span_readers_split_the_msm_into_its_stages():
    t = _trace(proofs=2, spans_s=[3.0, 3.2], top_phases=("q", "m"), msm_phases=("m",),
               phases={"q": 0.4, "m": 5.0, "msm.sort": 0.2, "msm.accumulate": 0.06,
                       "msm.reduce": 4.6, "msm.reduce.horner": 3.9})
    assert _read("msm_sort_s", t) == pytest.approx(0.1)
    assert _read("msm_accumulate_s", t) == pytest.approx(0.03)
    assert _read("msm_reduce_s", t) == pytest.approx(2.3)
    assert _read("msm_s", t) == pytest.approx(2.5)


def test_msm_readers_read_nothing_where_the_program_has_no_such_span():
    parent = _trace(proofs=3, spans_s=[3.0] * 3, top_phases=("q", "m"), msm_phases=("m",),
                    phases={"q": 0.4, "m": 5.0})
    for name in SPAN_READERS + ("msm_reduce_point_ops",):
        assert _read(name, parent) is None
        assert _read(name, _trace()) is None


def test_point_ops_reader_reads_the_ports_counter():
    from zksnake_tpu_torch import metrics

    metrics.enable()
    for _ in range(2):  # two span proofs of two reduction passes each
        with metrics.phase("groth16.prove.msm"):
            metrics.count("point_ops", 5)  # outside the reduction
            for ops in (316, 316):
                with metrics.phase("msm.reduce"):
                    with metrics.phase("msm.reduce.horner"):
                        metrics.count("point_ops", ops - 28)
                    metrics.count("point_ops", 28)
    metrics.enable(False)
    assert _read("msm_reduce_point_ops", _trace(proofs=2)) == 632
    # no span proofs, nothing to read
    assert _read("msm_reduce_point_ops", _trace()) is None
    metrics.reset()
    assert _read("msm_reduce_point_ops", _trace(proofs=2)) is None
