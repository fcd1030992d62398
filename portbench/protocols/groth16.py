"""Groth16 on the port: Groth16(r1cs, curve, device).setup() in set-up,
Groth16.prove in the window; the witness of request k comes from input
seeds.request_input(seed, k), and every draw the protocol makes (the toxic
waste, then r and s a proof) from the seed's protocol stream."""

import time

from portbench import chains, seeds
from portbench.reference import chain as ref_chain
from portbench.reference.bn254 import R
from portbench.reference.groth16 import Groth16Reference

TOP_PHASES = ("groth16.prove.qap", "groth16.prove.msm")
MSM_PHASES = ("groth16.prove.msm",)
SETUP_DRAWS, PROVE_DRAWS = 5, 2
REFERENCE_SAMPLE = None  # every proof of the window is checked


class Protocol:
    def __init__(self, config, seed, device):
        if config["curve"] != "BN254" or config["circuit"] != "mult_chain":
            raise ValueError("the Groth16 adapter runs the BN254 multiplication chain")
        self.n = 1 << config["log2_size"]
        self.seed = seed
        self.device = device
        self._patch = None
        self._ref = None

    def setup(self):
        from zksnake_tpu_torch.groth16 import Groth16, protocol

        t0 = time.perf_counter()
        _, r1cs = chains.mult_chain(self.n, "BN254")
        if r1cs.A.n_row != self.n:
            raise ValueError(f"the chain has {r1cs.A.n_row} constraints, not {self.n}")
        self._patch = seeds.det_random(protocol, seeds.stream(self.seed, "protocol"))
        self._patch.__enter__()
        t1 = time.perf_counter()
        self.g16 = Groth16(r1cs, "BN254", device=self.device)
        t2 = time.perf_counter()
        self.g16.setup()
        self.setup_stages = {"frontend": t1 - t0, "prover": t2 - t1,
                             "keys": time.perf_counter() - t2}

    def request(self, k):
        return ref_chain.r1cs_witness(seeds.request_input(self.seed, k, R), self.n)

    def prove(self, inputs):
        return self.g16.prove(*inputs)

    @staticmethod
    def elements(proof):
        b = proof.to_bytes()
        return [("A", b[:32]), ("B", b[32:96]), ("C", b[96:])]

    def close(self):
        if self._patch is not None:
            self._patch.__exit__(None, None, None)
            self._patch = None
        self.g16 = None

    def expected(self, k, zk=True):
        """Request k's proof elements by the plain reference."""
        draws = seeds.protocol_draws(self.seed, R - 1, SETUP_DRAWS + PROVE_DRAWS * (k + 1))
        if self._ref is None:
            self._ref = Groth16Reference(self.n, draws[:SETUP_DRAWS])
        r, s = draws[-PROVE_DRAWS:]
        return self._ref.proof(seeds.request_input(self.seed, k, R), r, s, zk=zk)
