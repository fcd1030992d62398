"""The control of the comparison that decides `correct`, and a check of the
circuit's layout, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--requests 12] [--layout]

The control puts the plain reference, with the configuration's
zero-knowledge blinding left out (Groth16's r = s = 0, PlonK's 11 blinds
0), in the program's place for `--requests` requests of the window on each
seed, and compares it with the reference as a run compares the program's
proofs: every element that differs counts. --layout also builds the
circuit through the port's front end, solves request 0's input through
its public path, and checks that the reference's circuit and witness are
laid out as the port's. Prints one JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def layout(config, seed):
    """The port's compiled circuit and solved witness against the
    reference's, at the configuration's size."""
    from portbench import chains, seeds
    from portbench.reference import chain
    from portbench.reference.bn254 import R

    n = 1 << config["log2_size"]
    x = seeds.request_input(seed, 0, R)
    if config["protocol"] == "groth16":
        cs, r1cs = chains.mult_chain(n, "BN254")
        rows = chain.r1cs_rows(n)
        same = r1cs.generate_witness(cs.solve({"inp": x})) == chain.r1cs_witness(x, n)
        for m, mat in enumerate((r1cs.A, r1cs.B, r1cs.C)):
            got = sorted((i, c, v) for i, lst in mat.triplets_map.items() for c, v in lst)
            same &= got == sorted((i, c, v) for i, row in enumerate(rows) for c, v in row[m])
        return same
    cs, pl = chains.plonk_chain(n, "BN254")
    gates = chain.plonk_gates(n)
    return (pl.generate_witness(pl.solve({"inp": x})) == chain.plonk_witness(x, n)
            and [pl.qL, pl.qR, pl.qO, pl.qM, pl.qC] == [[g[0][j] for g in gates] for j in range(5)]
            and pl.permutation == chain.plonk_permutation([g[1] for g in gates]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--layout", action="store_true")
    args = ap.parse_args()
    from portbench import harness

    bench = harness.load_benchmark()
    _, config, traffic = harness.find_cell(bench, args.workload)
    proto_mod = harness.module("protocols", config["protocol"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        protocol = proto_mod.Protocol(config, seed, "cpu")
        warm = traffic["warmup"]
        records = [(k, 0.0, None) for k in range(warm, warm + args.requests)]
        got = harness.check(protocol, proto_mod.REFERENCE_SAMPLE, records, seed, control=True)
        row = {"workload": args.workload, "seed": seed, "control": True,
               "checked": got["checked"], "mismatched_elements": got["mismatched"],
               "wrong": got["wrong"], "seconds": time.perf_counter() - t0}
        if args.layout:
            row["layout_equal"] = layout(config, seed)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
