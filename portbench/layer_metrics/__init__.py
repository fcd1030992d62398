"""Per-layer metric readers: one module a metric, named as the metric is in
BENCHMARK.json, each with read(trace) -> float or None (None where the
trace holds nothing to read; the harness then leaves the metric out)."""
