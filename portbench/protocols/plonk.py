"""PlonK on the port: Plonk(plonkish, curve, device).setup() in set-up (tau
drawn there), Plonk.prove in the window (11 blinds drawn a proof), on the
fused device prover; request k's witness comes from input
seeds.request_input(seed, k)."""

import time

from portbench import chains, seeds
from portbench.reference import chain as ref_chain
from portbench.reference.bn254 import R
from portbench.reference.plonk import PlonkReference

# the rounds and, beside them, each round's commitment MSMs
TOP_PHASES = tuple(f"plonk.prove.round{i}" for i in range(1, 6)) + ("plonk.prove.msm",)
MSM_PHASES = ("plonk.prove.msm",)
SETUP_DRAWS, PROVE_DRAWS = 1, 11
REFERENCE_SAMPLE = 2  # proofs of the window checked, drawn from the seed

_POINTS = ("tau_a", "tau_b", "tau_c", "tau_z", "tau_t_lo", "tau_t_mid", "tau_t_hi",
           "tau_W_zeta", "tau_W_zeta_omega")
_SCALARS = ("zeta_a", "zeta_b", "zeta_c", "zeta_sigma1", "zeta_sigma2", "zeta_omega")


class Protocol:
    def __init__(self, config, seed, device):
        if config["curve"] != "BN254" or config["circuit"] != "mult_chain":
            raise ValueError("the PlonK adapter runs the BN254 multiplication chain")
        self.n = 1 << config["log2_size"]
        self.seed = seed
        self.device = device
        self._patch = None
        self._ref = None

    def setup(self):
        from zksnake_tpu_torch.plonk import Plonk, protocol

        t0 = time.perf_counter()
        _, plonkish = chains.plonk_chain(self.n, "BN254")
        if plonkish.length != self.n:
            raise ValueError(f"the chain has {plonkish.length} gates, not {self.n}")
        self._patch = seeds.det_random(protocol, seeds.stream(self.seed, "protocol"))
        self._patch.__enter__()
        t1 = time.perf_counter()
        self.plonk = Plonk(plonkish, "BN254", device=self.device)
        t2 = time.perf_counter()
        self.plonk.setup()
        self.setup_stages = {"frontend": t1 - t0, "prover": t2 - t1,
                             "keys": time.perf_counter() - t2}
        from zksnake_tpu_torch.backend import config

        if not config.use_device(self.device, self.n, config.PLONK_DEVICE_THRESHOLD):
            raise ValueError("the fused device prover does not run at this size")

    def request(self, k):
        return ref_chain.plonk_witness(seeds.request_input(self.seed, k, R), self.n)

    def prove(self, inputs):
        return self.plonk.prove(*inputs)

    @staticmethod
    def elements(proof):
        return ([(k, bytes(getattr(proof, k).to_bytes())) for k in _POINTS]
                + [(k, getattr(proof, k)) for k in _SCALARS])

    def close(self):
        if self._patch is not None:
            self._patch.__exit__(None, None, None)
            self._patch = None
        self.plonk = None

    def expected(self, k, zk=True):
        """Request k's proof elements by the plain reference."""
        draws = seeds.protocol_draws(self.seed, R - 1, SETUP_DRAWS + PROVE_DRAWS * (k + 1))
        if self._ref is None:
            self._ref = PlonkReference(self.n, draws[0])
        return self._ref.proof(seeds.request_input(self.seed, k, R), draws[-PROVE_DRAWS:], zk=zk)
