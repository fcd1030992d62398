"""Groth16 proof system (https://eprint.iacr.org/2016/260.pdf).

Behavioral parity with upstream zksnake: python/zksnake/groth16/protocol.py
(same key material, same proof equation, byte-identical keys for a fixed
toxic waste). Setup and prove run the fused pipeline
(backend/groth16_device.py: tau-power scans, Lagrange coefficients by
batched inversion, L/R/O as transpose-SpMV, fixed-base MSMs, then SpMV ->
iNTT -> 2n product -> vanishing fold -> 5 MSMs for prove) on the torch
`device` at every circuit size; the host key generation below mirrors the
reference's bignum loops and runs for a tau that is a domain element
(tau^n = 1), which the device Lagrange step cannot take.
Verifying is host pairing arithmetic.

With a mesh, every rank of the mesh's process group runs this same program
(SPMD): each builds the same keys and proves with the same r, s, drawn on
rank 0 and broadcast, and the prove shards the QAP and the MSMs over the
ranks (backend/sharding.py).
"""

from ..arithmetization.r1cs import R1CS
from ..ecc import EllipticCurve
from ..polynomial import (
    evaluate_lagrange_coefficients,
    evaluate_vanishing_polynomial,
)
from ..utils import get_random_int
from .qap import QAP
from .serialization import Proof, ProvingKey, VerifyingKey


class Groth16:
    """Groth16 over `BN254` or `BLS12_381`, built from a compiled R1CS,
    proving on the torch `device` ("cuda" unless the caller asks for the
    CPU; raises if CUDA is asked for and missing)."""

    def __init__(self, r1cs: R1CS, curve: str = "BN254", device="cuda", mesh=None):
        """`mesh` opts into sharded proving: a 1-D torch DeviceMesh
        (backend.sharding.make_mesh builds one). Every rank of it constructs
        this object and calls setup and prove; a rank proves on
        cuda:(rank % cards) when `device` is CUDA without an index. The
        mesh's device type must be `device`'s."""
        self._group = None
        if mesh is not None:
            from ..backend.config import check_device
            from ..backend.sharding import rank_device

            device = check_device(device)
            if mesh.device_type != device.type:
                raise ValueError(
                    f"a {mesh.device_type} mesh cannot drive a prover on {device}"
                )
            if mesh.ndim != 1:
                raise ValueError(f"the mesh must be 1-D, not {mesh.ndim}-D")
            self._group = mesh.get_group(0)
            device = rank_device(device)
        self.E = EllipticCurve(curve, device)
        self.device = self.E.device
        self.order = self.E.order
        self.qap = QAP(self.order, self.device)
        self.qap.from_r1cs(r1cs)
        self.proving_key = None
        self.verifying_key = None
        self._device_prover = None

    # -- device pipeline -------------------------------------------------

    def _get_device_prover(self):
        """Fused pipeline on self.device (built on first use)."""
        if self._device_prover is None:
            from ..backend.groth16_device import Groth16DeviceProver
            from ..curves.params import CURVES

            self._device_prover = Groth16DeviceProver(
                self.qap, CURVES[self.E.name], self.device
            )
        return self._device_prover

    # -- setup ------------------------------------------------------------

    def _random_ints(self, count):
        """`count` random scalars in [1, r - 1]; on a mesh, rank 0's draws,
        broadcast, so every rank builds the same keys and proof."""
        if self._group is None:
            return [get_random_int(self.order - 1) for _ in range(count)]
        import torch.distributed as dist

        from ..backend.sharding import broadcast_ints

        mine = dist.get_rank(self._group) == 0
        return broadcast_ints(
            [get_random_int(self.order - 1) for _ in range(count)] if mine else [],
            self._group,
        )

    def setup(self):
        """Trusted setup: sample toxic waste and derive both keys."""
        self._setup_from_waste(*self._random_ints(5))

    def _setup_from_waste(self, tau, alpha, beta, gamma, delta):
        """Key generation from explicit toxic waste (deterministic tests).

        The device path requires tau^n != 1; a domain-element tau takes the
        host path (which produces a degenerate key there as well)."""
        G1, G2 = self.E.G1(), self.E.G2()
        n_rows = self.qap.a.n_row

        if pow(tau, n_rows, self.order) != 1:
            tau_G1, tau_G2, target_G1, k_gamma_G1, k_delta_G1 = (
                self._get_device_prover().setup_device(
                    self.qap.n_public, tau, alpha, beta, gamma, delta,
                    G1, G2, self.E.curve.PointG1, self.E.curve.PointG2,
                )
            )
        else:
            tau_G1, tau_G2, target_G1, k_gamma_G1, k_delta_G1 = self._setup_host(
                tau, alpha, beta, gamma, delta, G1, G2
            )

        self.proving_key = ProvingKey(
            G1 * alpha, G1 * beta, G2 * beta, G1 * delta, G2 * delta,
            tau_G1, tau_G2, target_G1, k_delta_G1,
        )
        self.verifying_key = VerifyingKey(
            G1 * alpha, G2 * beta, G2 * gamma, G2 * delta, k_gamma_G1
        )

    def _setup_host(self, tau, alpha, beta, gamma, delta, G1, G2):
        """Host bignum key generation (reference protocol.py:32-113 shape)."""
        p = self.order
        n_rows = self.qap.a.n_row
        n_cols = self.qap.a.n_col

        # K[j] = beta*L_j(tau) + alpha*R_j(tau) + O_j(tau), accumulated from
        # sparse triplets scaled by the Lagrange coefficients at tau.
        lagrange = evaluate_lagrange_coefficients(n_rows, tau, p)
        K = [0] * n_cols
        per_matrix = (
            (beta, self.qap.a.triplets_map),
            (alpha, self.qap.b.triplets_map),
            (1, self.qap.c.triplets_map),
        )
        for weight, rows in per_matrix:
            for i, coeff in enumerate(lagrange):
                scaled = weight * coeff
                for col, value in rows.get(i, []):
                    K[col] += scaled * value
        K = [k % p for k in K]

        powers = []
        acc = 1
        for _ in range(n_rows):
            powers.append(acc)
            acc = acc * tau % p

        t_over_delta = (
            evaluate_vanishing_polynomial(n_rows, tau, p)
            * pow(delta, -1, p)
            % p
        )

        tau_G1 = self.E.batch_mul(G1, powers)
        tau_G2 = self.E.batch_mul(G2, powers)
        target_G1 = self.E.batch_mul(G1, [x * t_over_delta % p for x in powers])
        k_gamma_G1 = self.E.batch_mul(
            G1 * pow(gamma, -1, p), K[: self.qap.n_public]
        )
        k_delta_G1 = self.E.batch_mul(
            G1 * pow(delta, -1, p), K[self.qap.n_public :]
        )
        return tau_G1, tau_G2, target_G1, k_gamma_G1, k_delta_G1

    # -- prove / verify ----------------------------------------------------

    def _assemble_proof(self, msm_a, msm_b1, msm_b2, hz, kdelta_w, r, s):
        """Blind and combine the five MSM results into (A, B, C)."""
        pk = self.proving_key
        A = msm_a + pk.alpha_1 + pk.delta_1 * r
        B1 = msm_b1 + pk.beta_1 + pk.delta_1 * s
        B2 = msm_b2 + pk.beta_2 + pk.delta_2 * s
        C = hz + kdelta_w + A * s + B1 * r - pk.delta_1 * (r * s % self.order)
        return Proof(A, B2, C)

    def prove(self, public_witness: list, private_witness: list) -> Proof:
        """Produce a proof for the given witness split."""
        if not self.proving_key:
            raise RuntimeError("ProvingKey has not been generated")
        if len(self.proving_key.kdelta_1) != len(private_witness):
            raise ValueError("Length of kdelta_1 and private_witness must be equal")

        r, s = self._random_ints(2)
        full_witness = public_witness + private_witness

        try:
            parts = self._get_device_prover().prove_msms(
                self.proving_key, full_witness, private_witness,
                self.E.curve.PointG1, self.E.curve.PointG2, group=self._group,
            )
        except ValueError as exc:
            raise ValueError("Failed to evaluate with the given witness") from exc
        return self._assemble_proof(*parts, r, s)

    def verify(self, proof: Proof, public_witness: list) -> bool:
        """e(A, B) == e(alpha, beta) * e(IC(w), gamma) * e(C, delta)."""
        if not self.verifying_key:
            raise RuntimeError("VerifyingKey has not been generated")
        vk = self.verifying_key
        if len(vk.ic) != len(public_witness):
            raise ValueError("Length of IC and public_witness must be equal")

        ic_w = self.E.multiexp(vk.ic, public_witness)
        return self.E.pairing(proof.A, proof.B) == self.E.multi_pairing(
            [vk.alpha_1, ic_w, proof.C],
            [vk.beta_2, vk.gamma_2, vk.delta_2],
        )
