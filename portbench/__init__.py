"""portbench: the benchmark of the PyTorch and CUDA port (zksnake_tpu_torch).

One command runs one cell of BENCHMARK.json once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Configurations, traffic mixes, protocol adapters, traffic drivers and
per-layer metric readers are files of their own that the harness finds by
name (harness.py). The plain reference (reference/) imports nothing of the
port.
"""
