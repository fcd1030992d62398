"""Sparse matrix-vector products over the scalar field, on torch.

Port of zksnake_tpu/backend/spmv.py: gather witness limbs by column,
Montgomery-multiply by the matrix values (K1), sum per row. The per-row sum
runs `index_add_` on int64 limbs: exact for up to 2^47 terms per row, and
in any order (integer atomics on CUDA), so the JAX package's 2^16-term
chunking is not needed. `reduce_wide` brings the wide sums back below p
for any fan-out (the high-fanout case of spmv.py:76-81).
"""

import torch

from .field import DTYPE, FieldSpec, _cond_sub_p, mod_add, mont_mul, sum_mod
from .limbs import MASK, W


class DeviceSparseMatrix:
    """COO triplets on a device: row-sorted indices, Montgomery values."""

    def __init__(self, fs: FieldSpec, rows, cols, vals, n_row, n_col):
        self.fs = fs
        self.n_row = n_row
        self.n_col = n_col
        self.rows = rows  # (nnz,) int64
        self.cols = cols  # (nnz,) int64
        self.vals = vals  # (nl, nnz) int32 Montgomery limbs
        self.nnz = rows.shape[0]

    @classmethod
    def from_triplets(cls, fs, triplets, n_row, n_col, device):
        trip = sorted(triplets, key=lambda t: t[0])
        rows = torch.tensor([t[0] for t in trip], dtype=torch.int64, device=device)
        cols = torch.tensor([t[1] for t in trip], dtype=torch.int64, device=device)
        vals = fs.to_device(fs.to_mont_host([t[2] for t in trip]), device)
        return cls(fs, rows, cols, vals, n_row, n_col)

    @classmethod
    def from_sparse_array(cls, fs, sa, device):
        return cls.from_triplets(fs, sa.triplets, sa.n_row, sa.n_col, device)


def reduce_wide(fs: FieldSpec, cols, col_bits):
    """(ncols, ...) int64 lazy columns, each in [0, 2^col_bits) with
    col_bits <= 62, column j of weight 2^(16 j) -> (nl, ...) canonical int32
    limbs of the value mod p.

    One carry chain turns the columns into 16-bit limbs. The low nl limbs
    (< R) take conditional subtractions of p; each limb h_k above them is a
    field element h_k < 2^16, and one stacked mont_mul by the constants
    (2^(16 (nl + k)) mod p) * R gives h_k * 2^(16 (nl + k)) mod p, canonical.
    Nothing is dropped, whatever the fan-out."""
    nl = fs.nl
    ncols = cols.shape[0]
    value_bits = col_bits + W * (ncols - 1) + 1
    nlimbs = max(-(-value_bits // W), nl)
    limbs = []
    carry = torch.zeros_like(cols[0])
    for j in range(nlimbs):
        v = (cols[j] + carry) if j < ncols else carry
        limbs.append(v & MASK)
        carry = v >> W
    limbs = torch.stack(limbs).to(DTYPE)
    lo = limbs[:nl]
    for _ in range((1 << (W * nl)) // fs.p):
        lo = _cond_sub_p(fs, lo)
    m = nlimbs - nl
    if m == 0:
        return lo
    batch = tuple(cols.shape[1:])
    h = torch.zeros((nl, m) + batch, dtype=DTYPE, device=cols.device)
    h[0] = limbs[nl:]
    consts = torch.cat(
        [fs.const_mont(pow(2, W * (nl + k), fs.p), cols.device, 1 + len(batch)) for k in range(m)],
        dim=1,
    )
    terms = mont_mul(fs, h, consts)  # (nl, m, ...)
    return mod_add(fs, lo, sum_mod(fs, terms, dim=1).squeeze(1))


def segment_sum_field(fs, terms, ids, num_segments):
    """Per-segment field sum of Montgomery terms (nl, k) -> (nl, segments),
    canonical (< p)."""
    k = terms.shape[1]
    acc = torch.zeros((num_segments, fs.nl), dtype=torch.int64, device=terms.device)
    acc.index_add_(0, ids, terms.T.long())
    return reduce_wide(fs, acc.T, W + max(k, 1).bit_length())
