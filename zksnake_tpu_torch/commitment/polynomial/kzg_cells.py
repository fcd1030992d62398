"""EIP-7594 blob cells and cell proofs over a batch of blobs, on the card.

What consensus-specs computes for one blob in `blob_to_kzg_commitment`
(deneb, polynomial-commitments.md) and `compute_cells_and_kzg_proofs`
(fulu, polynomial-commitments-sampling.md), for B blobs in one call:

- p, the polynomial with p(w_n^brp(j)) = blob[j]: one iNTT of width n of
  the blob taken out of bit-reversed order;
- the commitment [p(tau)]G1, the MSM of p's n coefficients over the
  monomial SRS (the spec's Lagrange lincomb gives the same point);
- the extension, p over the 2n-th (ext_size-th) roots of unity in
  bit-reversed order, cut into cells of cell_size: cell i holds p over the
  coset h_i mu_s, s = cell_size, h_i = w_ext^brp(s i);
- proof i = [q_i(tau)]G1, q_i the quotient of p by X^s - h_i^s (remainder
  dropped), committed over the first n - s points of the SRS, as
  `compute_kzg_proof_multi_impl` does.

Everything between the blobs' upload and the points' way back runs on the
card, batched over blobs: the two NTTs of backend/ntt.py, the quotients of
every cell by a log-depth scan of backend/field.py ops, and every MSM of
the call, 1 + cells per blob, in one msm_pippenger_many pass over the
fixed-base table of the SRS (backend/msm.py, FixedBaseTable) that set-up
left on the card: one window an MSM. Spans: kzg.cells.extend,
kzg.cells.quotient, kzg.cells.msm.
"""

import torch

from ... import metrics
from ...backend.curve_ops import get_group_spec
from ...backend.field import DTYPE, from_mont, mod_add, mont_mul, to_mont
from ...backend.msm import fixed_base_table, msm_pippenger_many
from ...backend.ntt import Domain, intt_device, ntt_device
from .kzg import KZG


class KZGCells(KZG):
    """EIP-7594 commitments, cells and cell proofs over BLS12-381 of blobs
    of `blob_size` field elements, extended to `ext_size` and cut into
    cells of `cell_size` (the spec's 4096, 8192 and 64 by default; any
    powers of two with cell_size < blob_size <= ext_size)."""

    def __init__(self, blob_size=4096, ext_size=8192, cell_size=64, device="cuda"):
        sizes = (cell_size, blob_size, ext_size)
        if any(v < 1 or v & (v - 1) for v in sizes) or not cell_size < blob_size <= ext_size:
            raise ValueError(f"sizes (cell, blob, extension) {sizes}: powers of two, "
                             "cell < blob <= extension")
        super().__init__(blob_size - 1, "BLS12_381", device)
        self.blob_size, self.ext_size, self.cell_size = blob_size, ext_size, cell_size
        self.cells = ext_size // cell_size
        self.device = self.E.device
        params = self.E.curve._curve
        self.gs = get_group_spec(params, 1)
        self.dom_blob = Domain.get(params, blob_size)
        self.dom_ext = Domain.get(params, ext_size)
        self.fr = self.dom_blob.fs
        self.table = None

    def setup(self):
        """tau and its powers as KZG.setup draws and makes them, then the
        blob_size monomial G1 points onto the card and their fixed-base
        table made there, once."""
        super().setup()
        self.table = fixed_base_table(self.gs, self.gs.points_to_device(self.G1_tau, self.device))
        self._zpow = self._coset_powers()

    def _coset_powers(self):
        """z_i^(2^k) for each cell i, z_i = h_i^s = w_ext^(s brp(s i)), and
        each shift 2^k < blob_size / s of the quotient scan: Montgomery
        limbs (k, nl, 1, cells, 1, 1)."""
        r, s = self.fr.p, self.cell_size
        brp = self.dom_ext.bitrev("cpu").tolist()
        z = [pow(self.dom_ext.omega, s * brp[s * i], r) for i in range(self.cells)]
        rows, sh = [], 1
        while sh < self.blob_size // s:
            rows.append([pow(v, sh, r) for v in z])
            sh *= 2
        limbs = self.fr.to_device(self.fr.to_mont_host(sum(rows, [])), self.device)
        return limbs.view(self.fr.nl, len(rows), 1, self.cells, 1, 1).transpose(0, 1)

    def _blobs_to_device(self, blobs):
        """Blobs -> (nl, B, blob_size) Montgomery limbs on the card. blobs:
        B lists of canonical field elements, or their raw 16-bit limbs as an
        int32 tensor (nl, B, blob_size). Raises on an element >= r."""
        fs = self.fr
        if not isinstance(blobs, torch.Tensor):
            flat = [v for blob in blobs for v in blob]
            if any(len(blob) != self.blob_size for blob in blobs):
                raise ValueError(f"a blob holds {self.blob_size} field elements")
            if any(not 0 <= v < fs.p for v in flat):
                raise ValueError("a blob element is not a canonical field element")
            blobs = fs.to_device(fs.raw_to_host(flat), "cpu").view(fs.nl, len(blobs), -1)
        if blobs.dtype != DTYPE or blobs.ndim != 3 or blobs.shape[0] != fs.nl \
                or blobs.shape[2] != self.blob_size:
            raise ValueError(f"blobs: int32 limbs (nl, B, {self.blob_size}), "
                             f"got {blobs.dtype} {tuple(blobs.shape)}")
        raw = blobs.to(self.device)
        x = to_mont(fs, raw)
        if not torch.equal(from_mont(fs, x), raw):  # only an element >= r changes
            raise ValueError("a blob element is not a canonical field element")
        return x

    def _quotients(self, coeffs):
        """q_i = p div (X^s - z_i) for every cell i of every blob:
        (nl, B, blob_size) Montgomery coefficients -> (nl, B, cells,
        blob_size - s). With p's blocks P_0 .. P_{K-1} of s coefficients
        (K = blob_size / s), q_i's blocks are Q_j = P_{j+1} + z_i Q_{j+1},
        Q_{K-2} = P_{K-1}: the suffix sums S_j = sum_{m >= j} z_i^(m-j) P_m
        shifted by one. On the blocks highest first, a_t = P_{K-1-t}, the
        scan T_t = a_t + z_i T_{t-1} runs in log2 K steps (Hillis-Steele:
        the step of shift sh adds z_i^sh T_{t-sh}), and Q_j = T_{K-2-j}."""
        fs = self.fr
        nl, B, n = coeffs.shape
        s = self.cell_size
        K = n // s
        T = coeffs.reshape(nl, B, 1, K, s).flip(3).expand(nl, B, self.cells, K, s)
        sh = 1
        for zp in self._zpow:
            T = torch.cat([T[:, :, :, :sh],
                           mod_add(fs, T[:, :, :, sh:], mont_mul(fs, T[:, :, :, :-sh], zp))],
                          dim=3)
            sh *= 2
        return T[:, :, :, :K - 1].flip(3).reshape(nl, B, self.cells, n - s)

    @torch.inference_mode()
    def compute_cells_and_kzg_proofs(self, blobs):
        """Commitments, cells and cell proofs of B blobs (see
        _blobs_to_device). Returns (commitments, cells, proofs): B host G1
        points; the cells as canonical field elements, raw 16-bit limbs in
        an int32 host tensor (nl, B, cells, cell_size); B lists of `cells`
        host G1 points."""
        self._require_setup()
        fs, dev = self.fr, self.device
        x = self._blobs_to_device(blobs)
        nl, B, n = x.shape
        with metrics.phase("kzg.cells.extend"):
            coeffs = intt_device(self.dom_blob, x[..., self.dom_blob.bitrev(dev)])
            ext = torch.constant_pad_nd(coeffs, (0, self.ext_size - n))
            evals = ntt_device(self.dom_ext, ext)[..., self.dom_ext.bitrev(dev)]
            cells = from_mont(fs, evals).view(nl, B, self.cells, self.cell_size).cpu()
        with metrics.phase("kzg.cells.quotient"):
            q = from_mont(fs, self._quotients(coeffs))
            p = from_mont(fs, coeffs)
        with metrics.phase("kzg.cells.msm"):
            short = self.table.prefix(n - self.cell_size)
            jobs = []
            for b in range(B):
                jobs.append((self.table, p[:, b]))
                jobs.extend((short, q[:, b, i]) for i in range(self.cells))
            res = msm_pippenger_many(self.gs, jobs)
            points = self.gs.points_from_device(res, self.E.curve.PointG1)
        per = self.cells + 1
        commitments = points[::per]
        proofs = [points[b * per + 1:(b + 1) * per] for b in range(B)]
        return commitments, cells, proofs
