"""Device folds for multilinear extensions.

Port of zksnake_tpu/backend/mle.py. Replaces the reference's rayon-parallel
MLE fix-variables (upstream zksnake: src/bn254/mle.rs:86 `partial_evaluate`)
with strided tensor folds on the caller's torch device: fixing variable 0
(the LSB of the evaluation index) maps the dense table to

    new[k] = old[2k] + r * (old[2k+1] - old[2k])

which is one mod_sub + mont_mul + mod_add over even/odd stride views,
halving the table each time. The product is kernel K1 on a CUDA tensor (K3
for flat batches of at least field.MXU_MIN_LANES under
ZKSNAKE_MXU_MONTMUL=1) and its plain version on a CPU tensor.

The host sparse dict-walk (polynomial.SparseMultilinearPolynomial) remains
the path for genuinely sparse tables (it is O(nnz)); this module wins when
the table is dense enough that O(2^nv) vector lanes beat O(nnz) host bigint
ops. Dispatch lives in SparseMultilinearPolynomial.partial_evaluate.
Montgomery conversion stays on the host (FieldSpec.to_mont_host /
from_mont_host), as in the JAX package.
"""

from . import config
from .field import FieldSpec, mod_add, mod_sub, mont_mul, sum_mod


def fold(fs, table, rs):
    """Fold the first k variables of an (nl, size) Montgomery table; rs is
    (nl, k), one Montgomery challenge a column."""
    for j in range(rs.shape[1]):
        lo = table[:, 0::2]
        hi = table[:, 1::2]
        table = mod_add(fs, lo, mont_mul(fs, rs[:, j : j + 1], mod_sub(fs, hi, lo)))
    return table


def _dense_table(fs, num_vars, evals_dict, device):
    dense = [0] * (1 << num_vars)
    for idx, v in evals_dict.items():
        dense[idx] = v
    return fs.to_device(fs.to_mont_host(dense), device)


def partial_evaluate_device(p, num_vars, evals_dict, points, device):
    """Fix the first len(points) variables of a sparse MLE on `device`.

    Returns the folded table as a dense list of ints (caller re-sparsifies).
    """
    fs = FieldSpec.get(p)
    table = _dense_table(fs, num_vars, evals_dict, device)
    rs = fs.to_device(fs.to_mont_host([int(r) % p for r in points]), device)
    return fs.from_mont_host(fold(fs, table, rs))


def should_use_device(num_vars, nnz, k, device):
    """Dense fold wins only when the table is big AND reasonably dense:
    the host walk is O(nnz * k) bigint ops, the device path is O(2^nv)
    lanes + transfer. Guard against densifying huge sparse selector MLEs.
    Raises when `device` is CUDA and no CUDA device is present."""
    config.check_device(device)
    if k == 0:
        return False
    size = 1 << num_vars
    if size > (1 << 24):  # never materialize >16M-entry tables
        return False
    return size >= config.MLE_DEVICE_THRESHOLD and nnz * 16 >= size


# ------------------------------------------------------------------
# Device-resident sumcheck round driver
#
# The host sumcheck prover calls partial_evaluate once per domain point per
# round (4 dense-table round trips x num_vars rounds; reference role:
# mle.rs:86 + subprotocol/sumcheck.py:49-58). This driver keeps ONE
# Montgomery table on the device for the whole protocol: each round needs
# only the two half-sums S0 = sum T[0::2], S1 = sum T[1::2] (a plain MLE's
# round polynomial is linear: g(x) = S0 + x*(S1 - S0), so the 4-point
# evaluations the transcript absorbs are derived on host from two scalars),
# and each challenge folds the table with one mul/add.
# ------------------------------------------------------------------

# instrumentation: device rounds executed (tests assert the path ran)
SUMCHECK_DEVICE_ROUNDS = 0


class DeviceSumcheckTable:
    def __init__(self, p, num_vars, evals_dict, device):
        self.fs = FieldSpec.get(p)
        self.p = p
        self.num_vars = num_vars
        self.device = device
        self._table = _dense_table(self.fs, num_vars, evals_dict, device)

    def round_sums(self):
        """Host ints (S0, S1) for the current variable: a pairwise tree of
        mod_adds over each half (modular addition is exact in any order,
        so the limbs are those of any other summation order)."""
        global SUMCHECK_DEVICE_ROUNDS
        SUMCHECK_DEVICE_ROUNDS += 1
        halves = sum_mod(self.fs, self._table.reshape(self.fs.nl, -1, 2), dim=1)  # (nl, 1, 2)
        s0, s1 = self.fs.from_mont_host(halves.reshape(self.fs.nl, 2))
        return s0, s1

    def fold(self, r):
        """Fix the current first variable to challenge r."""
        rs = self.fs.to_device(self.fs.to_mont_host([int(r) % self.p]), self.device)
        self._table = fold(self.fs, self._table, rs)


def sumcheck_driver(p, num_vars, evals_dict, device):
    """DeviceSumcheckTable when the table is device-worthy, else None."""
    if not should_use_device(num_vars, len(evals_dict) or 1, 1, device):
        return None
    return DeviceSumcheckTable(p, num_vars, evals_dict, device)
