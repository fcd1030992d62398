"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), device, with
--trace 1 breakdown, and last checks, each number compared beside its
limit (also the last lines of standard error). Exits non-zero and prints
no result without enough CUDA cards, or when jax, jaxlib, flax or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, "portbench", "_cache")


def _environment():
    """The port's defaults (no ZKSNAKE_* override), and every cache the
    program could use at a fixed path inside the checkout."""
    for key in [k for k in os.environ if k.startswith("ZKSNAKE_")]:
        del os.environ[key]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    _environment()
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    cell, _, _ = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s), {n} found",
              file=sys.stderr)
        return 2
    res = harness.run_cell(args.workload, args.seed, args.seconds, args.trace,
                           "cuda", T_START, bench)
    correct, checks = harness.verdict(res)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: modules of jax or the JAX package were loaded: {bad[:10]}",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = res["per_layer"]
    else:
        metrics = {m["name"]: {"value": res[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if res.get(m["name"]) is not None}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit": harness.smi("power.limit")}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    tr = res["trace"]
    if args.trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["checks"] = checks
    print("clocks.sm, power.draw, temperature.gpu before / after the window: "
          + " / ".join(res["smi"]))
    print(json.dumps({"run": {"reference_s": res["reference_s"], "proofs": res["attempted"],
                              "prove_s": res["prove_s"], "setup_s": res["setup_s"],
                              "made_in_window": res["window"].made_in_window,
                              "setup_stages": res["setup_stages"],
                              "proof_s": [s for _, s, _ in res["window"].records],
                              "window_s": res["window"].seconds,
                              "wrong": res["check"]["wrong"][:5], "errors": res["errors"]}}))
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
