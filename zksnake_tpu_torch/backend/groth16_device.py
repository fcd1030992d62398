"""Fused device pipeline for the Groth16 prover, on torch.

Port of zksnake_tpu/backend/groth16_device.py:

    witness limbs -> SpMV (Az, Bz, Cz) -> iNTT x3 -> 2n-NTT product -> iNTT
      -> vanishing-polynomial fold -> raw scalar limbs -> five MSMs

against a device-resident proving key, plus the device trusted setup
(tau-power scan, Lagrange coefficients by batched inversion, L/R/O as
transpose SpMVs, fixed-base batch muls). The host sees only the result
points and the divisibility flag. Given a mesh's process group,
prove_msms runs the same prove on every rank of it, each rank on its share
of the QAP and of the MSMs' lanes (backend/sharding.py).
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from .curve_ops import get_group_spec
from .field import (
    FieldSpec,
    from_mont,
    mod_add,
    mod_sub,
    mont_inv_batch,
    mont_mul,
    prefix_prod,
    to_mont,
)
from .msm import _pick_window, batch_mul_fixed_base_raw, msm_pippenger_many
from .ntt import Domain, intt_device, ntt_device
from .sharding import FourStepPlan, all_ok, shard_lanes, sharded_msm_many
from .spmv import DeviceSparseMatrix, segment_sum_field


class Groth16DeviceProver:
    """Per-(qap, proving key) device state for fused proving on `device`."""

    def __init__(self, qap, curve, device):
        self.curve = curve
        self.device = torch.device(device)
        self.fr = FieldSpec.get(curve.r)
        self.n = qap.a.n_row  # padded domain size
        self.m = qap.a.n_col
        self.dom = Domain.get(curve, self.n)
        self.dom2 = Domain.get(curve, 2 * self.n)
        fr = self.fr
        self.A = DeviceSparseMatrix.from_sparse_array(fr, qap.a, self.device)
        self.B = DeviceSparseMatrix.from_sparse_array(fr, qap.b, self.device)
        self.C = DeviceSparseMatrix.from_sparse_array(fr, qap.c, self.device)
        self._pk_dev = None
        self._w_pows = None
        self._sqap = None
        self._pk_perm = None

    def _limbs(self, ints):
        fr = self.fr
        return fr.to_device(fr.raw_to_host(ints), self.device)

    def _spmv(self, mat, w_mont):
        terms = mont_mul(self.fr, mat.vals, w_mont[:, mat.cols])
        return segment_sum_field(self.fr, terms, mat.rows, self.n)

    def qap(self, w_raw):
        """Raw witness limbs (nl, m) -> raw limbs of U, V, H and the
        divisibility flag of U*V - W by x^n - 1."""
        fr = self.fr
        n = self.n
        w = to_mont(fr, w_raw)
        u = intt_device(self.dom, self._spmv(self.A, w))
        v = intt_device(self.dom, self._spmv(self.B, w))
        wpoly = intt_device(self.dom, self._spmv(self.C, w))
        # U*V over the 2n domain
        zpad = torch.zeros_like(u)
        u2 = ntt_device(self.dom2, torch.cat([u, zpad], dim=1))
        v2 = ntt_device(self.dom2, torch.cat([v, zpad], dim=1))
        uv = intt_device(self.dom2, mont_mul(fr, u2, v2))
        # T = UV - W (first n coefficients), divided by x^n - 1: the
        # quotient is H = T[n:], the remainder T_i + H_i must vanish
        h = uv[:, n:]
        r_col = mod_add(fr, mod_sub(fr, uv[:, :n], wpoly), h)
        ok = bool((r_col == 0).all())
        return from_mont(fr, u), from_mont(fr, v), from_mont(fr, h), ok

    def evaluate_witness_device(self, witness_ints):
        """witness ints -> (U, V, H) raw limbs on the device."""
        u, v, h, ok = self.qap(self._limbs(witness_ints))
        if not ok:
            raise ValueError("(U * V - W) did not divided by Z to zero")
        return u, v, h

    # ------------------------------------------------------------------
    # Sharded QAP: one rank's part of witness -> U, V, H
    #
    # The SpMV of the rank's constraint rows, three inverse four-step NTTs
    # (one batch), two forward 2n four-steps (one batch), the product, the
    # inverse 2n four-step and the x^n - 1 fold, all on the rank's rows:
    # each four-step's output layout is the next one's input layout
    # (sharding.FourStepPlan), so the only collectives are the four-steps'
    # all_to_alls and one all_reduce of the divisibility flag. U, V and H
    # stay split in the "pos" layout, pos = k2 n1 + k1 holding coefficient
    # m = k2 + n2 k1, rank i holding pos in [i n/D, (i + 1) n/D); the MSMs
    # pair them with the rank's slice of a permuted proving key
    # (_pk_permuted).
    # ------------------------------------------------------------------

    def _sharded_qap(self, group):
        """The sharded QAP of `group` (built once, cached with the group it
        was built for), or None where the mesh does not divide the split:
        the QAP then runs replicated and only the MSMs are sharded, as in
        the JAX package."""
        if self._sqap is None or self._sqap[0] is not group:
            out = self._build_sharded_qap(group)
            if out is None:
                print(
                    f"[zksnake] sharded QAP unavailable for n={self.n} on a "
                    f"{dist.get_world_size(group)}-device mesh (split does not "
                    f"divide); QAP runs replicated, MSMs stay sharded",
                    file=sys.stderr, flush=True,
                )
            self._sqap = (group, out)
        return self._sqap[1]

    def _build_sharded_qap(self, group):
        fr = self.fr
        r = fr.p
        n = self.n
        D = dist.get_world_size(group)
        rank = dist.get_rank(group)
        k = n.bit_length() - 1
        n1 = 1 << (k // 2)
        n2 = n // n1
        if n1 % D or n2 % D or (2 * n1) % D:
            return None
        plans = (
            FourStepPlan(fr, r, n1, n2, self.dom.omega_inv, scale=pow(n, -1, r)),
            FourStepPlan(fr, r, n2, 2 * n1, self.dom2.omega),
            FourStepPlan(fr, r, 2 * n1, n2, self.dom2.omega_inv, scale=pow(2 * n, -1, r)),
        )
        tws = [p.tw_local(group, self.device) for p in plans]

        # the rank's triplets of A|B|C as one SpMV: constraint row `row` sits
        # at (i1, i2) = (row % n1, row // n1) and belongs to rank i1 // rows1;
        # its segment is matrix * rows_local + (i1 % rows1) n2 + i2
        rows1 = n1 // D
        rows_local = rows1 * n2
        segs, cols, vals = [], [], []
        for m_i, mat in enumerate((self.A, self.B, self.C)):
            i1 = mat.rows % n1
            mine = i1 // rows1 == rank
            segs.append(m_i * rows_local + (i1[mine] % rows1) * n2 + mat.rows[mine] // n1)
            cols.append(mat.cols[mine])
            vals.append(mat.vals[:, mine])
        segs, cols, vals = torch.cat(segs), torch.cat(cols), torch.cat(vals, dim=1)

        def eval_fn(witness_ints):
            w = to_mont(fr, self._limbs(witness_ints))
            terms = mont_mul(fr, vals, w[:, cols])
            abc = segment_sum_field(fr, terms, segs, 3 * rows_local)
            uvw = plans[0].local(abc.reshape(fr.nl, 3, rows1, n2), tws[0], group)
            # uvw: (nl, 3, n2/D, n1) coefficients of U, V, W
            uv2 = torch.cat([uvw[:, :2], torch.zeros_like(uvw[:, :2])], dim=-1)
            ev = plans[1].local(uv2, tws[1], group)  # (nl, 2, 2 n1/D, n2)
            qc = plans[2].local(mont_mul(fr, ev[:, 0], ev[:, 1]), tws[2], group)
            # qc: (nl, n2/D, 2 n1) coefficients of U V; H = its top half and
            # the remainder T_i + H_i of T = U V - W must vanish
            h = qc[..., n1:]
            r_col = mod_add(fr, mod_sub(fr, qc[..., :n1], uvw[:, 2]), h)
            if not all_ok(bool((r_col == 0).all()), group, self.device):
                raise ValueError("(U * V - W) did not divided by Z to zero")
            return tuple(from_mont(fr, t).reshape(fr.nl, -1) for t in (uvw[:, 0], uvw[:, 1], h))

        eval_fn.n1, eval_fn.n2 = n1, n2
        return eval_fn

    def _pk_permuted(self, pkd, n1, n2, group):
        """This rank's slice of tau1, tau2 and target1 in the sharded QAP's
        pos layout (pos = k2 n1 + k1 holds coefficient m = k2 + n2 k1),
        cached for the key `pkd`; kdelta1 stays in natural order."""
        if self._pk_perm is None or self._pk_perm[0] is not pkd:
            w = self.n // dist.get_world_size(group)
            lo = dist.get_rank(group) * w
            pos = torch.arange(lo, lo + w, device=self.device)
            idx = pos // n1 + n2 * (pos % n1)
            groups = {"tau1": 1, "tau2": 2, "target1": 1}
            perm = {
                name: get_group_spec(self.curve, g).map(lambda t: t[..., idx], pkd[name])
                for name, g in groups.items()
            }
            self._pk_perm = (pkd, perm)
        return self._pk_perm[1]

    # ------------------------------------------------------------------
    # Device trusted setup
    # ------------------------------------------------------------------

    def _domain_elements(self):
        """(nl, n) Montgomery tensor of w^0..w^(n-1) (w^(n/2) = -1, so the
        second half negates the first)."""
        if self._w_pows is None:
            r = self.fr.p
            if self.n == 1:
                full = [1]
            else:
                first = self.dom.powers_host
                full = list(first) + [(r - w) % r for w in first]
            self._w_pows = self.fr.to_device(self.fr.to_mont_host(full), self.device)
        return self._w_pows

    def _spmv_t(self, mat, vec):
        """Transpose SpMV: out[col] = sum over rows of val * vec[row]."""
        terms = mont_mul(self.fr, mat.vals, vec[:, mat.rows])
        return segment_sum_field(self.fr, terms, mat.cols, self.m)

    def setup_scalars(self, n_public, tau_m, alpha_m, beta_m, invgamma_m,
                      invdelta_m, tinvdelta_m, zn_m):
        """The setup's scalar pipeline on (nl, 1) Montgomery constants ->
        raw limbs of tau^i, tau^i t(tau)/delta, K_j/delta, K_j/gamma."""
        fr = self.fr
        n = self.n
        w_pows = self._domain_elements()
        one = fr.one_mont_dev((1,), self.device)
        tau_b = tau_m.expand(fr.nl, n)
        # tau^0..tau^(n-1) by a log-depth prefix-product scan
        pow_tau = prefix_prod(fr, torch.cat([one, tau_b[:, 1:]], dim=1))
        # Lagrange coefficients at tau: l_i(tau) = (Z(tau)/n) w^i / (tau - w^i)
        den = mod_sub(fr, tau_b, w_pows)
        lag = mont_mul(fr, mont_mul(fr, zn_m, w_pows), mont_inv_batch(fr, den))
        L = self._spmv_t(self.A, lag)
        R = self._spmv_t(self.B, lag)
        O = self._spmv_t(self.C, lag)
        K = mod_add(fr, mod_add(fr, mont_mul(fr, L, beta_m), mont_mul(fr, R, alpha_m)), O)
        kgamma = mont_mul(fr, K[:, :n_public], invgamma_m)
        kdelta = mont_mul(fr, K[:, n_public:], invdelta_m)
        target = mont_mul(fr, pow_tau, tinvdelta_m)
        return (from_mont(fr, pow_tau), from_mont(fr, target),
                from_mont(fr, kdelta), from_mont(fr, kgamma))

    @torch.inference_mode()
    def setup_device(self, n_public, tau, alpha, beta, gamma, delta,
                     g1_gen, g2_gen, point_cls_g1, point_cls_g2):
        """Trusted-setup hot path on the device. Returns host point vectors
        (tau_G1, tau_G2, target_G1, k_gamma_G1, k_delta_G1) and keeps the
        affine device tensors as the prover's proving key. tau must not be a
        domain element (tau^n != 1)."""
        from ..metrics import phase

        fr = self.fr
        r = fr.p
        inv_gamma = pow(gamma, -1, r)
        inv_delta = pow(delta, -1, r)
        z_tau = (pow(tau, self.n, r) - 1) % r
        t_invdelta = z_tau * inv_delta % r
        zn = z_tau * pow(self.n, -1, r) % r

        def c1(v):
            return fr.to_device(fr.to_mont_host([v]), self.device)

        with phase("groth16.setup.scalars", items=self.n):
            pow_tau_raw, target_raw, kdelta_raw, kgamma_raw = self.setup_scalars(
                n_public, c1(tau), c1(alpha), c1(beta), c1(inv_gamma),
                c1(inv_delta), c1(t_invdelta), c1(zn),
            )

        g1 = get_group_spec(self.curve, 1)
        g2 = get_group_spec(self.curve, 2)

        def fixed(gs, gen, raw):
            return gs.normalize(batch_mul_fixed_base_raw(gs, gen, raw))

        with phase("groth16.setup.msm", items=4 * self.n):
            # the four G1 vectors share the base G1: one batch over all lanes
            raws = [pow_tau_raw, target_raw, kgamma_raw, kdelta_raw]
            all1 = fixed(g1, g1_gen, torch.cat(raws, dim=1))
            ends = np.cumsum([0] + [t.shape[1] for t in raws])
            tau1, target1, kgamma1, kdelta1 = [
                g1.map(lambda t: t[:, a:b], all1) if b > a else None
                for a, b in zip(ends[:-1], ends[1:])
            ]
            tau2 = fixed(g2, g2_gen, pow_tau_raw)

        self._pk_dev = {"tau1": tau1, "tau2": tau2, "target1": target1, "kdelta1": kdelta1}

        def host(gs, P, cls):
            return [] if P is None else gs.points_from_device(P, cls)

        with phase("groth16.setup.to_host", items=4 * self.n):
            return (
                host(g1, tau1, point_cls_g1),
                host(g2, tau2, point_cls_g2),
                host(g1, target1, point_cls_g1),
                host(g1, kgamma1, point_cls_g1),
                host(g1, kdelta1, point_cls_g1),
            )

    def pk_device(self, pk):
        """Device tensors of the proving key's point vectors (cached)."""
        if self._pk_dev is None:
            g1 = get_group_spec(self.curve, 1)
            g2 = get_group_spec(self.curve, 2)
            dev = self.device
            self._pk_dev = {
                "tau1": g1.points_to_device(pk.tau_1, dev),
                "tau2": g2.points_to_device(pk.tau_2, dev),
                "target1": g1.points_to_device(pk.target_1, dev),
                "kdelta1": g1.points_to_device(pk.kdelta_1, dev) if pk.kdelta_1 else None,
            }
        return self._pk_dev

    def load_state(self, state):
        """Adopt device state built elsewhere (backend/state.py): the sparse
        matrices "A", "B", "C" and the proving key "pk"."""
        for name in ("A", "B", "C"):
            if name in state:
                setattr(self, name, state[name])
        if "pk" in state:
            self._pk_dev = dict(state["pk"])

    @torch.inference_mode()
    def prove_msms(self, pk, witness_ints, private_witness, point_cls_g1, point_cls_g2,
                   group=None):
        """QAP and the five MSMs of Groth16.prove on the device; returns host
        points (msmA, msmB1, msmB2, msmHZ, msmKpriv).

        With a mesh's process group `group`, every rank of it calls this
        (SPMD) and gets the same five points: the QAP is sharded over the
        ranks where the mesh divides its split (replicated otherwise), and
        every MSM runs on the rank's lanes, one all_gather of partial
        points for the G1 MSMs and one for the G2 MSM. U, V, H of the
        sharded QAP are the rank's already, against its slice of the
        permuted key; the replicated QAP's and K-private's are padded to a
        multiple of the mesh and split (shard_lanes)."""
        from ..metrics import phase

        g1 = get_group_spec(self.curve, 1)
        g2 = get_group_spec(self.curve, 2)
        n = self.n
        sq = None if group is None else self._sharded_qap(group)
        with phase("groth16.prove.qap_sharded" if sq is not None else "groth16.prove.qap", items=n):
            u, v, h = (sq or self.evaluate_witness_device)(witness_ints)
        pkd = self.pk_device(pk)
        pk_msm = self._pk_permuted(pkd, sq.n1, sq.n2, group) if sq is not None else pkd

        def job(gs, P, s, split=True):
            """(points, scalars) of this device's or rank's lanes."""
            P = gs.map(lambda t: t[..., :s.shape[1]], P)
            return (P, s) if group is None or not split else shard_lanes(gs, P, s, group)

        def msm(gs, jobs):
            if group is None:
                return msm_pippenger_many(gs, jobs, _pick_window(n))
            return sharded_msm_many(gs, jobs, group)

        with phase("groth16.prove.msm_sharded" if group is not None else "groth16.prove.msm", items=4 * n):
            split = sq is None
            jobs = [job(g1, pk_msm["tau1"], u, split), job(g1, pk_msm["tau1"], v, split),
                    job(g1, pk_msm["target1"], h, split)]
            k = len(private_witness)
            if k > 0:
                jobs.append(job(g1, pkd["kdelta1"], self._limbs(private_witness)))
            # the G1 MSMs share one window size, so their reductions run
            # as one batch (msm_pippenger_many)
            g1_out = g1.points_from_device(msm(g1, jobs), point_cls_g1)
            b2 = g2.points_from_device(msm(g2, [job(g2, pk_msm["tau2"], v, split)]),
                                       point_cls_g2)[0]
        msm_k = g1_out[3] if k > 0 else point_cls_g1.identity()
        return [g1_out[0], g1_out[1], b2, g1_out[2], msm_k]
