"""Sparse matrix over Z_p, stored as a per-row adjacency map.

Role parity with upstream zksnake: python/zksnake/array.py (the R1CS A/B/C
matrices and their witness dot-products). The reference keeps a flat triplet
list and dots it with a pure-Python bignum loop (its array.py:36-43 — flagged
hot in SURVEY.md §3.3); here the canonical storage is row -> [(col, value)]
so the host dot walks rows once, and the device SpMV (backend.spmv) consumes
the same structure through the `triplets` view.
"""


class SparseArray:
    """COO/adjacency sparse matrix with entries reduced mod p on read."""

    def __init__(self, dense_rows, n_row: int, n_col: int, p: int):
        self.p = p
        self.n_row = n_row
        self.n_col = n_col
        # row index -> list of (col, value); zero values are never stored.
        self.rows = {}
        for r, entries in enumerate(dense_rows):
            for c, v in enumerate(entries):
                if v:
                    self.rows.setdefault(r, []).append((c, v))

    @property
    def triplets(self):
        """Flat (row, col, value) view in row-major order (device SpMV input)."""
        return [
            (r, c, v) for r in sorted(self.rows) for (c, v) in self.rows[r]
        ]

    @property
    def triplets_map(self):
        """row -> [(col, value)] — the native storage."""
        return self.rows

    def append(self, triplets):
        """Insert (row, col, value) entries; zeros are dropped."""
        for r, c, v in triplets:
            if v:
                self.rows.setdefault(r, []).append((c, v))

    def dot(self, vector):
        """Matrix-vector product mod p (host bigint path)."""
        out = []
        for r in range(self.n_row):
            acc = 0
            for c, v in self.rows.get(r, ()):
                acc += v * vector[c]
            out.append(acc % self.p)
        return out
