"""Mesh-sharded MSM and four-step NTT on torch.distributed.

Port of zksnake_tpu/backend/sharding.py. The JAX package drives every
device of a jax.sharding.Mesh from one process through shard_map; here
every rank runs the same program on its own shard (SPMD), and the
collectives run on the process group of a 1-D DeviceMesh (dim name
"shards"). The functions below are the per-rank bodies: each takes this
rank's slice and the mesh's group.

- MSM: points and scalars split along n; each rank runs the port's
  Pippenger on its slice (double-and-add and a tree sum below 64 lanes),
  then one all_gather of the partial points and a fold in rank order.
- NTT: the distributed four-step algorithm. With coefficients viewed as an
  (n1, n2) matrix (j = i1 + n1 i2) and the rows i1 split over the ranks,
  stage 1 runs local length-n2 NTTs, stage 2 multiplies by twiddles, and
  stage 3's length-n1 NTTs become local after an all_to_all transpose.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from .field import mont_mul
from .msm import _double_and_add, _next_pow2, _pick_window, _tree_reduce, msm_pippenger_many
from .ntt import Domain, _ntt


def make_mesh(device_type="cuda", n_devices=None):
    """1-D DeviceMesh of n_devices ranks (the whole default process group
    when None) with dim name "shards", on `device_type`. Needs an initialized
    default process group, or the variables init_device_mesh reads to
    start one (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as torchrun
    sets them)."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_devices is None:
        n_devices = (dist.get_world_size() if dist.is_initialized()
                     else int(os.environ["WORLD_SIZE"]))
    return init_device_mesh(device_type, (n_devices,), mesh_dim_names=("shards",))


def rank_device(device):
    """This rank's torch device: cuda:(global rank % cards) for a CUDA
    device without an index, `device` itself otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return device


# --------------------------------------------------------- collectives ----


def _all_gather(t, group):
    """[t of rank 0, ..., t of rank D-1]."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def _all_to_all(t, group):
    """Chunk j of dim 0 goes to rank j; chunk i of the result came from
    rank i."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def all_ok(ok, group, device):
    """True on every rank when `ok` holds on every rank (an all_reduce of
    the ranks' failures)."""
    bad = torch.tensor([0 if ok else 1], dtype=torch.int32, device=device)
    dist.all_reduce(bad, group=group)
    return int(bad.item()) == 0


def broadcast_ints(values, group):
    """Rank 0's list of ints, on every rank of `group`."""
    objs = [list(values)]
    dist.broadcast_object_list(objs, src=dist.get_global_rank(group, 0), group=group)
    return objs[0]


# ---------------------------------------------------------------- MSM ----


def pad_msm_to(gs, P, slimbs, n_target):
    """Pad an MSM instance to exactly n_target lanes: identity points
    (Z = 0) with zero scalars add nothing (the Pippenger drops Z = 0 lanes,
    double-and-add never adds them)."""
    rem = n_target - slimbs.shape[1]
    if rem < 0:
        raise ValueError(f"cannot pad {slimbs.shape[1]} lanes to {n_target}")
    if rem == 0:
        return P, slimbs

    def pad(t):
        return torch.cat([t, t.new_zeros(t.shape[:-1] + (rem,))], dim=-1)

    return gs.map(pad, P), pad(slimbs)


def pad_msm_operands(gs, P, slimbs, ndev):
    """Pad an MSM instance so its lane count divides by the mesh size."""
    n = slimbs.shape[1]
    return pad_msm_to(gs, P, slimbs, n + (-n % ndev))


def shard_lanes(gs, P, slimbs, group):
    """This rank's lanes of an MSM instance padded to a multiple of the
    group's size D (pad_msm_operands): rank i takes the i-th of D equal
    slices."""
    D = dist.get_world_size(group)
    P, slimbs = pad_msm_operands(gs, P, slimbs, D)
    w = slimbs.shape[1] // D
    lo = dist.get_rank(group) * w
    return gs.map(lambda t: t[..., lo:lo + w], P), slimbs[:, lo:lo + w]


def local_msm_many(gs, jobs):
    """This rank's partial sums of M MSMs, jobs [(P, slimbs)] of its lanes
    -> leaves (nl, M). From 64 lanes a job (the first job's count), the
    Pippenger of one window and one reduction pass for all of them; below,
    as in the JAX package, double-and-add over nbits = 16 SL and a tree
    sum, every job's lanes in one pass."""
    n_local = jobs[0][1].shape[1]
    if n_local >= 64:
        return msm_pippenger_many(gs, jobs, _pick_window(n_local))
    w = _next_pow2(max(s.shape[1] for _, s in jobs))  # the tree sum halves
    padded = [pad_msm_to(gs, P, s, w) for P, s in jobs]
    P = gs.map(lambda *ts: torch.cat(ts, dim=-1), *[p for p, _ in padded])
    s = torch.cat([s for _, s in padded], dim=-1)
    acc = _double_and_add(gs, P, s, 16 * s.shape[0])
    acc = gs.map(lambda t: t.reshape(t.shape[0], len(jobs), w), acc)
    return _tree_reduce(gs, acc, w)


def fold_partials(gs, partial, group):
    """Every rank's partial points (leaves (nl, ...)), gathered in one
    collective of the stacked coordinates and added up in rank order: the
    same sums on every rank. The adds are complete, so identity partials
    are safe."""
    parts = _all_gather(torch.stack(gs.leaves(partial)), group)
    total = gs.unflatten(list(parts[0]))
    for t in parts[1:]:
        total = gs.add(total, gs.unflatten(list(t)))
    return total


def sharded_msm_many(gs, jobs, group):
    """M full MSMs from this rank's slices of each: leaves (nl, M)."""
    return fold_partials(gs, local_msm_many(gs, jobs), group)


def sharded_msm(gs, P, slimbs, group):
    """The full MSM from this rank's slice (P, slimbs): one projective
    point (leaves (nl,)), the same on every rank."""
    return gs.map(lambda t: t[:, 0], sharded_msm_many(gs, [(P, slimbs)], group))


# ---------------------------------------------------------------- NTT ----


class _SubDomain(Domain):
    """A length-`size` NTT domain of generator `omega`, with Domain's
    device tables (twiddles, stage_index, bitrev)."""

    def __init__(self, fs, r, omega, size):
        self.fs = fs
        self.r = r
        self.n = size
        self.omega = omega
        self.omega_inv = pow(omega, -1, r)
        self.n_inv = pow(size, -1, r)
        self.powers_host = self._powers(omega, max(size // 2, 1))
        self._dev = {}


class FourStepPlan:
    """Static tables of one distributed four-step (i)NTT of size n1 * n2.

    The direction is `omega` (pass omega^-1 and scale = 1/n for the
    inverse). Layouts, rows split over the group's D ranks:

      input:  (nl, n1, n2), index j = i1 + n1 i2 at [:, i1, i2], i1 split
      output: (nl, n2, n1), index k = k2 + n2 k1 at [:, k2, k1], k2 split

    The output is the next transform's input when that one's split starts
    with n1' = n2: the sharded QAP chains three plans with no collective
    between them (backend/groth16_device.py)."""

    def __init__(self, fs, r, n1, n2, omega, scale=1):
        self.fs = fs
        self.n1 = n1
        self.n2 = n2
        self.row_dom = _SubDomain(fs, r, pow(omega, n1, r), n2)
        self.col_dom = _SubDomain(fs, r, pow(omega, n2, r), n1)
        # stage-2 twiddles W[i1, k2] = scale * omega^(i1 k2)
        vals = []
        for i1 in range(n1):
            w = scale % r
            base = pow(omega, i1, r)
            for _ in range(n2):
                vals.append(w)
                w = w * base % r
        self.tw_host = fs.to_mont_host(vals).reshape(fs.nl, n1, n2)

    def tw_local(self, group, device):
        """This rank's rows of the stage-2 twiddles, on `device`."""
        rows = self.n1 // dist.get_world_size(group)
        lo = dist.get_rank(group) * rows
        return self.fs.to_device(self.tw_host[:, lo:lo + rows], device)

    def local(self, x, tw_local, group):
        """One rank's part: x (nl, [B,] n1/D, n2), its rows (a leading batch
        axis B runs B transforms in the same launches) -> (nl, [B,] n2/D,
        n1)."""
        fs = self.fs
        nl = fs.nl
        batched = x.ndim == 4
        if not batched:
            x = x[:, None]
        B, rows = x.shape[1], x.shape[2]
        D = dist.get_world_size(group)
        dev = x.device
        # stage 1: length-n2 NTTs along the last axis
        x1 = _ntt(self.row_dom, x.reshape(nl, B * rows, self.n2), self.row_dom.twiddles(dev))
        # stage 2: twiddle (and scale) multiply
        x2 = mont_mul(fs, x1.reshape(nl, B, rows, self.n2), tw_local[:, None])
        # stage 3: rank j takes column chunk j of every rank's rows, so the
        # chunks arrive in row order; then length-n1 NTTs along the rows
        c = self.n2 // D
        send = x2.reshape(nl, B, rows, D, c).permute(3, 0, 1, 2, 4)
        recv = _all_to_all(send, group)  # (D source ranks, nl, B, rows, c)
        xt = recv.permute(1, 2, 0, 3, 4).reshape(nl, B, self.n1, c).transpose(2, 3)
        x3 = _ntt(self.col_dom, xt.reshape(nl, B * c, self.n1), self.col_dom.twiddles(dev))
        x3 = x3.reshape(nl, B, c, self.n1)
        return x3 if batched else x3[:, 0]


def sharded_ntt(dom, x_local, n1, group):
    """Distributed four-step NTT over `dom` (size n = n1 n2) of this rank's
    rows x_local (nl, n1/D, n2) -> its part (nl, n2/D, n1) of the output
    (layouts: FourStepPlan)."""
    n2 = dom.n // n1
    D = dist.get_world_size(group)
    if n1 * n2 != dom.n or n1 % D or n2 % D:
        raise ValueError(f"n = {dom.n} = {n1} x {n2} does not split over {D} ranks")
    plan = FourStepPlan(dom.fs, dom.r, n1, n2, dom.omega)
    return plan.local(x_local, plan.tw_local(group, x_local.device), group)


def fourstep_input_layout(fs, coeffs_ints, n1, n2):
    """Host: coefficient list -> (nl, n1, n2) Montgomery limbs with
    j = i1 + n1 i2 at [:, i1, i2]."""
    n = n1 * n2
    vals = list(coeffs_ints) + [0] * (n - len(coeffs_ints))
    arr = fs.to_mont_host(vals)  # (nl, n) in index order j
    return np.ascontiguousarray(arr.reshape(fs.nl, n2, n1).swapaxes(1, 2))


def fourstep_output_to_natural(fs, out, n1, n2):
    """Host: (nl, n2, n1) four-step output -> evaluations in natural order
    (A[k2 + n2 k1] is at [:, k2, k1], so the transpose flattens to k1 n2 +
    k2, the natural index)."""
    arr = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return fs.from_mont_host(arr.swapaxes(1, 2).reshape(fs.nl, n1 * n2))
