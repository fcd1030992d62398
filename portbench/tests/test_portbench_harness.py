"""The harness at toy sizes on the CPU: cells, configurations, traffic and
per-layer metrics found by name; the closed loop's window and witness
pool; the roofline work counts; the whole-name module check."""

import os
import re
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, peaks, seeds
from portbench.drivers import closed_loop
from portbench.trace import PROVE_SPAN, Recorder, Trace, read_profile

BENCH = harness.load_benchmark()


def test_every_cell_finds_its_files_by_name():
    for cell in BENCH["workloads"]:
        found, config, traffic = harness.find_cell(BENCH, cell["name"])
        assert found is cell and config["name"] == cell["config"]
        proto = harness.module("protocols", config["protocol"])
        assert hasattr(proto.Protocol, "prove") and proto.TOP_PHASES and proto.MSM_PHASES
        assert hasattr(harness.module("drivers", traffic["kind"]), "run")
        readers = harness.layer_metrics(BENCH)
        assert [m["name"] for m, _ in readers] == [m["name"] for m in BENCH["per_layer"]]
    for c in BENCH["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_names_are_checked_before_they_become_paths():
    with pytest.raises(ValueError):
        harness.module("protocols", "../run")
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "no-such-cell")


def test_module_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "zksnake_tpu",
             "zksnake_tpu.backend.msm", "zksnake_tpu_torch", "zksnake_tpu_torch.backend",
             "jaxtyping", "flaxen", "torch", "portbench.harness"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "zksnake_tpu",
        "zksnake_tpu.backend.msm"]


class _FakeProtocol:
    """prove() sleeps `seconds` and returns its input."""

    def __init__(self, seconds, fail=()):
        self.device = torch.device("cpu")
        self.seconds, self.fail = seconds, fail
        self.made, self.proved = [], []

    def request(self, k):
        self.made.append(k)
        return ("input", k)

    def prove(self, inputs):
        time.sleep(self.seconds)
        self.proved.append(inputs[1])
        if inputs[1] in self.fail:
            raise ValueError("planted failure")
        return inputs


TRAFFIC = {"kind": "closed_loop", "concurrency": 1, "warmup": 2, "pool_prove_s": 0.05,
           "pool_spare": 1, "trace_proofs": 0, "span_proofs": 0}


def test_closed_loop_runs_to_the_proof_that_crosses_the_window():
    proto = _FakeProtocol(0.02)
    w = closed_loop.run(proto, TRAFFIC, 0.1)
    done = [k for k, _, _ in w.records]
    assert proto.proved[:2] == [0, 1] and done == proto.proved[2:]
    times = [s for _, s, _ in w.records]
    # every proof but the last started inside the window; the last crossed it
    assert sum(times[:-1]) < 0.1 + 0.02 * len(times) and w.seconds >= 0.1
    assert harness.prove_seconds(w) == pytest.approx(sum(times) / len(times))


def test_prove_seconds_is_over_completed_proofs():
    w = closed_loop.Window()
    w.records = [(2, 1.0, "p"), (3, None, ValueError()), (4, 2.0, "p"), (5, 4.0, "p")]
    assert harness.prove_seconds(w) == pytest.approx(7.0 / 3)
    w.records = [(2, None, ValueError())]
    assert harness.prove_seconds(w) is None


def test_witness_pool_never_repeats_and_grows_in_the_window():
    proto = _FakeProtocol(0.005, fail={4})
    traffic = dict(TRAFFIC, pool_prove_s=0.1, pool_spare=0)  # a pool of 1 for 0.1 s
    w = closed_loop.run(proto, traffic, 0.1)
    assert len(set(proto.made)) == len(proto.made)
    assert len(set(proto.proved)) == len(proto.proved)
    assert sorted(proto.proved) == list(range(len(proto.proved)))
    assert w.made_in_window == len(w.records) - 1
    assert [k for k, s, _ in w.records if s is None] == [4]
    xs = [seeds.request_input(11, k, 2**61 - 1) for k in range(200)]
    assert len(set(xs)) == 200
    assert xs == [seeds.request_input(11, k, 2**61 - 1) for k in range(200)]


def test_roofline_work_counts_match_hand_counts():
    # K1 at (16 limbs, 2^20 lanes): 3 x 16 x 2^20 int32 = 201,326,592 bytes
    assert peaks.mont_mul_bound_s(16, 1 << 20) == pytest.approx(201326592 / 3.35e12)
    # a CIOS product of 8 words: 2 (2 x 64 + 8) = 272 multiply-adds
    assert peaks.cios_imads(8) == 272
    assert peaks.IMAD_OPS_S == pytest.approx(16.72704e12)
    # K2: 1,000,000 G1 adds at 6 products of 272: 1.632e9 / 16.727e12 s
    assert peaks.bucket_bound_s(1, 16, 1000, 10**6) == pytest.approx(1.632e9 / 16.72704e12)
    # G2 at 3 base products a product; a bytes-bound call takes its bytes
    assert peaks.bucket_bound_s(2, 16, 1000, 10**6) == pytest.approx(3 * 1.632e9 / 16.72704e12)
    assert peaks.bucket_bound_s(1, 16, 3.35e9, 1) == pytest.approx(1e-3)


def test_recorder_stages_and_the_additions_each_bucket_call_needs(monkeypatch):
    from zksnake_tpu_torch import metrics
    from zksnake_tpu_torch.backend import kernels

    monkeypatch.setattr(kernels, "bucket_accumulate", lambda gs, pts, starts, lens: "out")
    monkeypatch.setattr(kernels, "mont_mul", lambda fs, a, b: "prod")
    rec = Recorder(torch.device("cpu"), ("p.top", "p.msm"), ("p.msm",), 1, 2)
    gs = SimpleNamespace(group=2, fs=SimpleNamespace(nl=16))
    lens = torch.tensor([[0, 1, 3], [2, 0, 5]], dtype=torch.int32)
    pts = torch.zeros((4, 16, 2, 5), dtype=torch.int32)
    for i in range(4):
        rec.before(i)
        with rec.proof(i):
            with metrics.phase("p.msm"):
                assert kernels.bucket_accumulate(gs, pts, lens, lens) == "out"
            assert kernels.mont_mul(SimpleNamespace(nl=16), torch.zeros(16, 7), None) == "prod"
        rec.after(i)
    trace = rec.finish()
    # the first two proofs carry the spans; only the third is profiled, and
    # only its calls are noted: runs of 0, 1, 3, 2, 0, 5 points need
    # 0 + 0 + 2 + 1 + 0 + 4 additions; the fourth records nothing
    assert trace.proofs == 2 and len(trace.spans_s) == 2
    assert set(trace.phases) == {"p.msm"}
    out_bytes = 4 * 3 * 2 * 16 * 6
    assert trace.k2_calls == [[2, 16, 4 * (640 + 6 + 6) + out_bytes, 7]]
    assert trace.k1_calls == [(16, 7)]
    assert trace.profiled == 1 and trace.window_s > 0
    assert not metrics.enabled()
    assert kernels.mont_mul(None, None, None) == "prod"


def _trace(**kw):
    t = Trace()
    for k, v in kw.items():
        setattr(t, k, v)
    return t


def _read(name, trace):
    return harness.module("layer_metrics", name).read(trace)


def test_span_readers_split_a_proof_into_its_layers():
    g16 = _trace(proofs=2, spans_s=[3.0, 3.2], top_phases=("q", "m"), msm_phases=("m",),
                 phases={"q": 0.4, "m": 5.0})
    assert _read("protocol_self_s", g16) == pytest.approx(0.4)
    assert _read("prover_self_s", g16) == pytest.approx(0.2)
    assert _read("msm_s", g16) == pytest.approx(2.5)
    # PlonK: the MSMs beside the rounds
    pl = _trace(proofs=1, spans_s=[4.0], top_phases=("r1", "r2", "m"), msm_phases=("m",),
                phases={"r1": 0.5, "r2": 0.5, "m": 2.5})
    assert _read("protocol_self_s", pl) == pytest.approx(0.5)
    assert _read("prover_self_s", pl) == pytest.approx(1.0)
    assert _read("msm_s", pl) == pytest.approx(2.5)
    empty = _trace()
    for name in ("protocol_self_s", "prover_self_s", "msm_s", "launches_per_proof",
                 "montmul_roofline_pct", "bucket_roofline_pct", "device_idle_pct"):
        assert _read(name, empty) is None


def test_device_readers():
    k1 = "void montmul_kernel<8>(int const*, int const*, int*, long, zk::FieldParams<8>)"
    kern = [(k1, 2e-3), ("void chunk_kernel<16, 1>(...)", 3e-3),
            ("void fold_kernel<16, 1>(...)", 1e-3), ("void montmul_mma_kernel<8>(...)", 1.0),
            ("elementwise_kernel", 4e-3)]
    t = _trace(profiled=2, kernels=kern, k1_calls=[(16, 1 << 20)],
               k2_calls=[[1, 16, 0, 10**6]], busy_s=1.0, window_s=4.0)
    assert _read("launches_per_proof", t) == 2.5
    assert _read("device_idle_pct", t) == pytest.approx(75.0)
    assert _read("montmul_roofline_pct", t) == pytest.approx(
        100 * peaks.mont_mul_bound_s(16, 1 << 20) / 2e-3)
    assert _read("bucket_roofline_pct", t) == pytest.approx(
        100 * peaks.bucket_bound_s(1, 16, 0, 10**6) / 4e-3)
    # calls and kernels that do not pair up read nothing
    t.k1_calls = t.k1_calls * 2
    assert _read("montmul_roofline_pct", t) is None


class _Ev:
    def __init__(self, name, start, dur, cuda=False, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev = SimpleNamespace(name="CUDA" if cuda else "CPU")
        self._a = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


def test_read_profile_busy_time_and_idle_gaps_by_span():
    spans = [("groth16.prove.msm", 500, 1000), (PROVE_SPAN, 0, 1000)]
    ev = [_Ev("k_a", 100, 200, cuda=True), _Ev("k_b", 250, 100, cuda=True),
          _Ev("Memcpy HtoD", 600, 100, cuda=True), _Ev("cudaLaunchKernel", 90, 5),
          _Ev(PROVE_SPAN, 0, 1000, cuda=True, annotation=True)]
    t = Trace()
    read_profile(ev, spans, t)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(350e-9)  # [100, 350) and [600, 700)
    assert [n for n, _ in t.kernels] == ["k_a", "k_b"]
    assert t.idle_by_span == pytest.approx({PROVE_SPAN: 350e-9, "groth16.prove.msm": 300e-9})
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k_a" and b["device_ops"][0][1] == pytest.approx(200e-9)
    assert len(b["idle_gaps"]) == 2


def test_breakdown_lists_at_most_ten():
    t = _trace(kernels=[(f"k{i}", float(i)) for i in range(30)],
               idle_by_span={f"s{i}": float(i) for i in range(12)})
    b = t.breakdown()
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k29", 29.0]
    assert len(b["idle_gaps"]) == 10


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                          "g16-bn254-2e16.stream", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert re.search(r"needs 1 CUDA card", out.stderr)
