"""Runs one cell of BENCHMARK.json once, and judges what it produced.

Everything that belongs to one configuration, traffic mix, protocol,
traffic kind or per-layer metric is a file of its own, found by the name
that BENCHMARK.json or the configuration gives:

    configs/<config>.json            the deployment ("protocol", "curve", ...)
    traffic/<traffic>.json           a traffic mix ("kind", its parameters)
    protocols/<protocol>.py          the adapter onto the port's prover
    drivers/<kind>.py                the traffic kind's driver
    layer_metrics/<metric>.py        one per-layer metric's reader
"""

import importlib
import json
import os
import re
import subprocess
import time

from portbench import seeds

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "zksnake_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _checked(name):
    if not _NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find_cell(bench, workload):
    """(cell, configuration, traffic) of the named workload."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(os.path.join(HERE, "configs", _checked(cell["config"]) + ".json"))
    traffic = load_json(os.path.join(HERE, "traffic", _checked(cell["traffic"]) + ".json"))
    return cell, config, traffic


def module(kind, name):
    """portbench.<kind>.<name>, the file found by name."""
    return importlib.import_module(f"portbench.{kind}.{_checked(name)}")


def layer_metrics(bench):
    """[(metric entry, reader)] of the per-layer metrics; a reader that finds
    nothing to read in a cell's trace returns None."""
    return [(m, module("layer_metrics", m["name"]).read) for m in bench["per_layer"]]


def forbidden_modules(names):
    """Loaded modules whose whole top-level name is jax, jaxlib, flax or the
    JAX package (zksnake_tpu_torch begins with zksnake_tpu and is not one)."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def prove_seconds(window):
    """The mean of the completed proofs' wall times: their sum over their
    count (None where none completed)."""
    times = [s for _, s, _ in window.records if s is not None]
    return sum(times) / len(times) if times else None


def check(protocol, sample, records, seed, control=False):
    """Compare the completed proofs of `records` (all, or `sample` of them
    drawn from the seed) with the plain reference's, element by element.
    control=True puts the reference without its blinding in the program's
    place."""
    done = [(k, proof) for k, s, proof in records if s is not None]
    picked = done if sample is None else seeds.sample(seed, done, sample)
    mismatched, wrong = 0, []
    for k, proof in picked:
        got = (protocol.expected(k, zk=False) if control else protocol.elements(proof))
        want = protocol.expected(k)
        bad = [name for (name, g), (_, w) in zip(got, want) if g != w]
        if len(got) != len(want):
            bad.append("length")
        if bad:
            wrong.append((k, bad))
        mismatched += len(bad)
    return {"checked": len(picked), "mismatched": mismatched, "wrong": wrong}


def run_cell(workload, seed, seconds, trace, device, t_start, bench=None, config=None,
             traffic=None):
    """One run of a cell on `device`: set-up, the window, the per-layer
    readings (trace) and the comparison with the plain reference. Returns
    the result's fields; `config` and `traffic` stand in others (tests)."""
    import torch

    bench = bench or load_benchmark()
    _, cfg, traffic_file = find_cell(bench, workload)
    cfg, traffic = config or cfg, traffic or traffic_file
    device = torch.device(device)
    proto_mod = module("protocols", cfg["protocol"])
    driver = module("drivers", traffic["kind"])
    stages = {"start": time.perf_counter() - t_start}
    if device.type == "cuda":
        from zksnake_tpu_torch.backend import kernels

        t0 = time.perf_counter()
        kernels.build(cfg["kernel_libraries"])
        stages["build"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
    protocol = proto_mod.Protocol(cfg, seed, device)
    protocol.setup()
    stages.update(protocol.setup_stages)
    recorder = None
    if trace:
        from portbench.trace import Recorder

        recorder = Recorder(device, proto_mod.TOP_PHASES, proto_mod.MSM_PHASES,
                            traffic["trace_proofs"], traffic["span_proofs"])
    smi_before = smi("clocks.sm,power.draw,temperature.gpu") if device.type == "cuda" else None
    window = driver.run(protocol, traffic, seconds, recorder)
    setup_s = window.t_first - t_start
    stages.update(window.setup_stages)
    smi_after = smi("clocks.sm,power.draw,temperature.gpu") if device.type == "cuda" else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(1 for _, s, _ in window.records if s is None)
    result = {"workload": workload, "seed": seed, "setup_s": setup_s,
              "prove_s": prove_seconds(window), "attempted": len(window.records),
              "failed": failed, "not_completed": failed, "memory_peak_bytes": peak, "window": window,
              "smi": [smi_before, smi_after], "trace": window.trace,
              "setup_stages": stages}
    if trace:
        readings = {}
        for m, read in layer_metrics(bench):
            value = read(window.trace)
            if value is not None:
                readings[m["name"]] = {"value": value, "unit": m["unit"]}
        result["per_layer"] = readings
    protocol.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = check(protocol, proto_mod.REFERENCE_SAMPLE, window.records, seed)
    result["check"] = got
    result["failed"] += len(got["wrong"])
    result["reference_s"] = time.perf_counter() - t0
    result["errors"] = [repr(p) for _, s, p in window.records if s is None][:3]
    return result


def verdict(result):
    """(correct, checks): each number compared with its limit."""
    got = result["check"]
    checks = {
        "mismatched_elements": {"value": got["mismatched"], "limit": 0, "rule": "<="},
        "proofs_not_completed": {"value": result["not_completed"], "limit": 0, "rule": "<="},
        "proofs_checked": {"value": got["checked"], "limit": 1, "rule": ">="},
    }
    ok = (got["mismatched"] <= 0 and result["not_completed"] <= 0 and got["checked"] >= 1)
    return ok, checks
