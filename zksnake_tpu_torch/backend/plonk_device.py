"""Fused device pipeline for the PlonK prover, on torch: all five rounds
resident on the prover's device.

Port of zksnake_tpu/backend/plonk_device.py. The host only sees the nine
commitment points, the six opening evaluations and the rounds' checks:

  R1  batched 4-way iNTT (wires + PI) -> blinding -> batched 4n NTT -> gate
      product G on the extended domain -> 3 commitments
  R2  batched 6-way 4n NTT of (wire + beta*id/sigma + gamma) -> two 3-way
      products -> stride-4 samples -> batched inversion (mont_inv_batch) ->
      prefix-product accumulator (prefix_prod) -> [z]_1
  R3  Z_omega by the cyclic root table -> batched 8n NTT products (nom*Z,
      den*Z_omega) -> (Z-1)*L1 over 4n -> quotient by X^n - 1 as suffix
      block folds -> T split + X^n blinding -> 3 commitments
  R4  one batched evaluation: the zeta-power table by prefix_prod, the
      coefficient dot by sum_mod
  R5  the linearization as one weighted combination of 15 coefficient
      tensors (weights are host scalars from the R4 evaluations), then the
      (X - z) divisions by suffix sums, q_i = z^-(i+1) sum_{j>i} N_j z^j

The JAX package jit-compiles each round; here each round is a plain method
that runs eagerly on torch tensors. The commitments of one round share the
SRS and the window size, so they go through one msm_pippenger_many (one
sort and K2 launch each, one reduction for the round). Proof bytes are
identical to the host prover's under the same blinding draw.

With metrics on (zksnake_tpu_torch.metrics), each round is a span
plonk.prove.round1..5 and each round's commitments plonk.prove.msm; inside
the rounds, plonk.prove.grand_product (R2: the sampled ratios, their
inversion and prefix product, the copy-constraint check),
plonk.prove.quotient (R3: from Z_omega to the remainder check) and
plonk.prove.opening (R5: the linearization and both divisions). The NTTs
count ntt_elements into every open span: 24n in R1, 33n in R2 and 56n in
R3, all of them in the quotient, 113n a proof.
"""

import numpy as np
import torch

from .curve_ops import get_group_spec
from .field import (
    FieldSpec,
    from_mont,
    mod_add,
    mod_sub,
    mont_inv_batch,
    mont_mul,
    prefix_prod,
    prefix_sum_mod,
    sum_mod,
    to_mont,
)
from .msm import _pick_window, msm_pippenger_many
from .ntt import Domain, intt_device, ntt_device


def _pad_last(x, n):
    """Zero-pad the last axis up to length n."""
    pad = n - x.shape[-1]
    if pad <= 0:
        return x
    return torch.constant_pad_nd(x, (0, pad))


class PlonkDeviceProver:
    """Per-proving-key device state for fused PlonK proving on `device`.

    Requires n >= 8 (the quotient block fold needs 4n >= 3n + 6)."""

    def __init__(self, pk, curve, device):
        self.curve = curve
        self.device = torch.device(device)
        self.fr = FieldSpec.get(curve.r)
        self.n = pk.n
        if self.n < 8:
            raise ValueError("device PlonK prover requires domain size >= 8")
        self.dom1 = Domain.get(curve, self.n)
        self.dom4 = Domain.get(curve, 4 * self.n)
        self.dom8 = Domain.get(curve, 8 * self.n)
        fr = self.fr
        n = self.n
        dev = self.device

        def coeff_tensor(poly, length):
            c = poly.coeffs()
            return fr.to_mont_host(c + [0] * (length - len(c)))

        def stacked(arrays):
            return fr.to_device(np.stack(arrays, axis=1), dev)

        # (nl, 5, n): QL, QR, QO, QM, QC coefficient vectors
        self.sel_coeffs = stacked([coeff_tensor(pk.selector_poly[k], n) for k in "LROMC"])
        # (nl, 5, 4n): the extended-domain selector evaluations
        self.sel_evals4 = stacked([fr.to_mont_host(list(pk.selector_eval[k])) for k in "LROMC"])
        # (nl, 6, n): id1..3 then sigma1..3 coefficient vectors
        self.idsig_coeffs = stacked(
            [coeff_tensor(p, n) for p in pk.identity_poly]
            + [coeff_tensor(p, n) for p in pk.permutation_poly]
        )
        # (nl, 4n): L1 on the extended domain
        self.lagrange4 = fr.to_device(fr.to_mont_host(list(pk.lagrange_evals)), dev)
        # (nl, n+3): omega^(i mod n), the Z -> Z(omega X) rotation table
        r = curve.r
        omega = self.dom1.omega
        cyc = []
        w = 1
        for i in range(n + 3):
            cyc.append(w)
            w = w * omega % r
            if (i + 1) % n == 0:
                w = 1
        self.roots_cyc = fr.to_device(fr.to_mont_host(cyc), dev)
        self.one_col = fr.one_mont_dev((1,), dev)

        self.g1 = get_group_spec(curve, 1)
        self.srs_len = len(pk.tau_g1)
        self.window = _pick_window(self.srs_len)
        self._tau1_dev = self.g1.points_to_device(pk.tau_g1, dev)
        self._st = {}

    # -- small host<->device helpers --------------------------------------

    def _m(self, *values):
        """ints -> (nl, k) Montgomery device scalars."""
        fr = self.fr
        return fr.to_device(fr.to_mont_host([int(v) % fr.p for v in values]), self.device)

    def _raw(self, values):
        fr = self.fr
        return fr.to_device(fr.raw_to_host(values), self.device)

    def _commit(self, raw_limbs, point_cls):
        """MSMs of raw coefficient limbs (each (nl, k <= SRS length)) against
        the SRS, zero-padded to its length, in one msm_pippenger_many."""
        from ..metrics import phase

        with phase("plonk.prove.msm", items=len(raw_limbs) * self.srs_len):
            jobs = [(self._tau1_dev, _pad_last(s, self.srs_len)) for s in raw_limbs]
            res = msm_pippenger_many(self.g1, jobs, self.window)
            return self.g1.points_from_device(res, point_cls)

    # -- round 1 -----------------------------------------------------------

    def round1(self, a, b, c, pub_vec, blinds, point_cls):
        """Wire polynomials + gate product; returns ([a]1, [b]1, [c]1)."""
        from ..metrics import phase

        fr, n = self.fr, self.n
        with phase("plonk.prove.round1", items=n):
            wires_raw = torch.stack([self._raw(a), self._raw(b), self._raw(c)], dim=1)
            stacked = to_mont(fr, torch.cat([wires_raw, self._raw(pub_vec)[:, None, :]], dim=1))
            coeffs = intt_device(self.dom1, stacked)  # (nl, 4, n)
            pi = coeffs[:, 3]
            bl = self._m(*blinds).reshape(fr.nl, 3, 2)
            # wire + blind*(X^n - 1): subtract at [0:2], append at [n:n+2]
            low = mod_sub(fr, coeffs[:, :3], _pad_last(bl, n))
            abc = torch.cat([low, bl], dim=-1)  # (nl, 3, n+2)

            ext = ntt_device(
                self.dom4,
                torch.cat([_pad_last(abc, 4 * n), _pad_last(pi[:, None, :], 4 * n)], dim=1),
            )  # (nl, 4, 4n)
            a_e, b_e, c_e, pi_e = ext.unbind(1)
            ab_e = mont_mul(fr, a_e, b_e)
            prods = mont_mul(fr, torch.stack([a_e, b_e, c_e, ab_e], dim=1), self.sel_evals4[:, :4])
            g_e = mod_add(
                fr,
                mod_add(fr, sum_mod(fr, prods, dim=1)[:, 0], self.sel_evals4[:, 4]),
                pi_e,
            )
            g = intt_device(self.dom4, g_e)
            abc_raw = from_mont(fr, abc)
        self._st.update(abc=abc, pi=pi, g=g)
        return self._commit([abc_raw[:, i] for i in range(3)], point_cls)

    # -- round 2 -----------------------------------------------------------

    def round2(self, beta, gamma, blinds, point_cls):
        """Permutation accumulator; returns [z]_1."""
        from ..metrics import phase

        fr, n = self.fr, self.n
        with phase("plonk.prove.round2", items=n):
            abc = self._st["abc"]
            beta_m, gamma_m, bl = self._m(beta), self._m(gamma), self._m(*blinds)
            # (wire + beta*id + gamma) and (wire + beta*sigma + gamma)
            wires6 = torch.cat([abc, abc], dim=1)  # (nl, 6, n+2)
            beta_terms = mont_mul(fr, self.idsig_coeffs, beta_m[:, None])
            shifted = mod_add(fr, wires6, _pad_last(beta_terms, n + 2))
            gamma_col = _pad_last(gamma_m[:, None, :], n + 2)
            shifted = mod_add(fr, shifted, gamma_col.expand(shifted.shape))

            ext = ntt_device(self.dom4, _pad_last(shifted, 4 * n))  # (nl, 6, 4n)
            # nom = e0*e1*e2 (id side), den = e3*e4*e5 (sigma side)
            p1 = mont_mul(fr, torch.stack([ext[:, 0], ext[:, 3]], dim=1),
                          torch.stack([ext[:, 1], ext[:, 4]], dim=1))
            p2 = mont_mul(fr, p1, torch.stack([ext[:, 2], ext[:, 5]], dim=1))
            nomden = intt_device(self.dom4, p2)  # coefficients (nl, 2, 4n)

            with phase("plonk.prove.grand_product", items=n):
                nom_s = p2[:, 0, ::4]
                den_s = p2[:, 1, ::4]
                ratio = mont_mul(fr, nom_s, mont_inv_batch(fr, den_s.contiguous()))
                pref = prefix_prod(fr, ratio)
                acc = torch.cat([self.one_col, pref[:, : n - 1]], dim=-1)
                ok = bool((pref[:, n - 1 : n] == self.one_col).all())

            acc_c = intt_device(self.dom1, acc)
            z_low = mod_sub(fr, acc_c, _pad_last(bl, n))
            z = torch.cat([z_low, bl], dim=-1)  # (nl, n+3)
            z_raw = from_mont(fr, z)
        if not ok:
            raise AssertionError("Copy constraints are not satisfied")
        self._st.update(nomden=nomden, z=z)
        return self._commit([z_raw], point_cls)[0]

    # -- round 3 -----------------------------------------------------------

    def round3(self, alpha, blinds, point_cls):
        """Quotient polynomial; returns ([t_lo]1, [t_mid]1, [t_hi]1)."""
        from ..metrics import phase

        fr, n = self.fr, self.n
        with phase("plonk.prove.round3", items=n):
            nomden, z, g = self._st["nomden"], self._st["z"], self._st["g"]
            alpha_m, bl = self._m(alpha), self._m(*blinds)
            with phase("plonk.prove.quotient", items=n):
                z_omega = mont_mul(fr, z, self.roots_cyc)

                big = ntt_device(
                    self.dom8,
                    torch.cat(
                        [
                            _pad_last(nomden, 8 * n),
                            _pad_last(z[:, None, :], 8 * n),
                            _pad_last(z_omega[:, None, :], 8 * n),
                        ],
                        dim=1,
                    ),
                )  # (nl, 4, 8n): nom, den, Z, Z_omega evaluations
                prod = mont_mul(fr, big[:, 0:2], big[:, 2:4])
                nz_dz = intt_device(self.dom8, prod)  # (nl, 2, 8n)

                # (Z - 1) * L1 over the 4n domain
                zm1 = torch.cat([mod_sub(fr, z[:, :1], self.one_col), z[:, 1:]], dim=-1)
                z1_e = ntt_device(self.dom4, _pad_last(zm1, 4 * n))
                z1l1 = intt_device(self.dom4, mont_mul(fr, z1_e, self.lagrange4))

                alpha2 = mont_mul(fr, alpha_m, alpha_m)
                numer = mod_add(
                    fr,
                    _pad_last(g, 8 * n),
                    mont_mul(fr, mod_sub(fr, nz_dz[:, 0], nz_dz[:, 1]), alpha_m),
                )
                numer = mod_add(fr, numer, mont_mul(fr, _pad_last(z1l1, 8 * n), alpha2))

                # divide by X^n - 1: q block b = sum of numer blocks > b
                blocks = numer.reshape(fr.nl, 8, n)
                suffix = [None] * 8
                suffix[7] = blocks[:, 7]
                for j in range(6, 0, -1):
                    suffix[j] = mod_add(fr, blocks[:, j], suffix[j + 1])
                remainder = mod_add(fr, blocks[:, 0], suffix[1])
                ok = bool((remainder == 0).all())
            t = torch.cat(suffix[1:5], dim=-1)  # (nl, 4n), degree <= 3n+5

            b_lo, b_hi = bl[:, :1], bl[:, 1:2]
            t_lo = torch.cat([t[:, :n], b_lo], dim=-1)
            mid = t[:, n : 2 * n]
            t_mid = torch.cat([mod_sub(fr, mid[:, :1], b_lo), mid[:, 1:], b_hi], dim=-1)
            hi = t[:, 2 * n : 3 * n + 6]
            t_hi = torch.cat([mod_sub(fr, hi[:, :1], b_hi), hi[:, 1:]], dim=-1)
            parts = (t_lo, t_mid, t_hi)
            parts_raw = [from_mont(fr, x) for x in parts]
        if not ok:
            raise AssertionError("quotient remainder is non-zero")
        self._st.update(z_omega=z_omega, t_parts=parts)
        return self._commit(parts_raw, point_cls)

    # -- round 4 -----------------------------------------------------------

    def _powers(self, point_m, length):
        """[1, z, ..., z^(length-1)] of a (nl, 1) Montgomery point."""
        fr = self.fr
        return prefix_prod(
            fr, torch.cat([self.one_col, point_m.expand(fr.nl, length - 1)], dim=-1)
        )

    def round4(self, zeta):
        """Opening evaluations: (zA, zB, zC, zs1, zs2, zZw, PI(zeta))."""
        from ..metrics import phase

        fr, n = self.fr, self.n
        L = n + 3
        with phase("plonk.prove.round4", items=n):
            zp = self._powers(self._m(zeta), L)
            polys = torch.cat(
                [
                    _pad_last(self._st["abc"], L),  # A, B, C
                    _pad_last(self.idsig_coeffs[:, 3:5], L),  # sigma1, sigma2
                    _pad_last(self._st["z_omega"][:, None, :], L),  # Z_omega
                    _pad_last(self._st["pi"][:, None, :], L),  # PI
                ],
                dim=1,
            )  # (nl, 7, L)
            prods = mont_mul(fr, polys, zp[:, None, :])
            evals = sum_mod(fr, prods, dim=-1)[..., 0]  # (nl, 7)
            return fr.raw_from_host(from_mont(fr, evals))

    # -- round 5 -----------------------------------------------------------

    def _divide(self, numer, point, length):
        """(X - point) division of (nl, length) Montgomery coefficients by
        suffix sums; returns (quotient, remainder is zero)."""
        fr = self.fr
        zp = self._powers(self._m(point), length)
        # [z^-1, ..., z^-length]
        zp_inv = prefix_prod(fr, self._m(pow(point, -1, fr.p)).expand(fr.nl, length))
        m = mont_mul(fr, numer, zp)
        incl = torch.flip(prefix_sum_mod(fr, torch.flip(m, dims=[-1])), dims=[-1])
        excl = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], dim=-1)
        q = mont_mul(fr, excl, zp_inv)
        return q, bool((incl[:, :1] == 0).all())

    def round5(self, weights, const1, const2, zeta, zeta_omega, point_cls):
        """Opening quotients; returns ([W_zeta]1, [W_zeta_omega]1)."""
        from ..metrics import phase

        fr, n = self.fr, self.n
        L = n + 6
        with phase("plonk.prove.round5", items=n):
            z = self._st["z"]
            t_lo, t_mid, t_hi = self._st["t_parts"]
            with phase("plonk.prove.opening", items=n):
                # the linearization basis, in the order of the weight vector
                # (Plonk._linearization_weights)
                polys = torch.cat(
                    [
                        _pad_last(self.sel_coeffs, L),  # QL QR QO QM QC
                        _pad_last(z[:, None, :], L),  # Z
                        _pad_last(self.idsig_coeffs[:, 5:6], L),  # sigma3
                        _pad_last(t_lo[:, None, :], L),
                        _pad_last(t_mid[:, None, :], L),
                        _pad_last(t_hi[:, None, :], L),
                        _pad_last(self._st["abc"], L),  # A B C
                        _pad_last(self.idsig_coeffs[:, 3:5], L),  # sigma1 sigma2
                    ],
                    dim=1,
                )  # (nl, 15, L)
                comb = sum_mod(fr, mont_mul(fr, polys, self._m(*weights)[:, :, None]), dim=1)[:, 0]
                numer = torch.cat([mod_add(fr, comb[:, :1], self._m(const1)), comb[:, 1:]], dim=-1)
                w_zeta, ok1 = self._divide(numer, zeta, L)

                numer2 = torch.cat([mod_add(fr, z[:, :1], self._m(const2)), z[:, 1:]], dim=-1)
                w_zw, ok2 = self._divide(_pad_last(numer2, L), zeta_omega, L)
            raws = [from_mont(fr, w_zeta), from_mont(fr, w_zw)]
        if not (ok1 and ok2):
            raise AssertionError("opening quotient remainder is non-zero")
        return self._commit(raws, point_cls)
