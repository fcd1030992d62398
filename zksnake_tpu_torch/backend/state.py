"""Carry device state over from the JAX package.

The JAX package keeps (nl, N) uint32 arrays of 16-bit limbs; the port keeps
the same layout as int32, so moving state is a dtype change. The inputs are
numpy arrays (np.asarray of the JAX arrays), so this module imports no JAX.

PlonK keys need no helper here: the JAX package's ProvingKey.to_bytes() and
VerifyingKey.to_bytes() read back with the port's plonk.ProvingKey /
VerifyingKey.from_bytes, and the port's PlonkDeviceProver builds its device
tensors from that key (tests/test_torch_plonk.py proves with one).

The commitments' public parameters are host points: points_from_jax reads
them from compressed point bytes (the arkworks wire format both packages
write with to_bytes()), so a JAX-made SRS commits and opens the same in the
port.
"""

import numpy as np
import torch

from .field import FieldSpec
from .spmv import DeviceSparseMatrix


def limbs_from_jax(arr, device):
    """(nl, N) uint32 16-bit limbs (numpy) -> int32 tensor on `device`."""
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) >= 1 << 16:
        raise ValueError("limb out of range: expected 16-bit limbs")
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def _point(leaves, device):
    """Nested tuple of numpy leaves -> the same structure of tensors."""
    if isinstance(leaves, (tuple, list)):
        return tuple(_point(x, device) for x in leaves)
    return limbs_from_jax(leaves, device)


def prover_state_from_jax(arrays, device, curve="BN254"):
    """State for Groth16DeviceProver.load_state from the JAX
    Groth16DeviceProver's arrays as numpy, for `curve` "BN254" or
    "BLS12_381" (the scalar field of the matrices' values).

    arrays: {"pk": {"tau1" | "tau2" | "target1" | "kdelta1": point leaves
    of _pk_dev (nested (X, Y, Z) tuples, G2 coordinates as pairs; kdelta1
    may be None)}, "A" | "B" | "C": {"rows", "cols", "vals", "n_row",
    "n_col"} of its DeviceSparseMatrix}."""
    from ..curves.params import CURVES

    fr = FieldSpec.get(CURVES[curve].r)
    state = {"pk": {}}
    for name, leaves in arrays.get("pk", {}).items():
        state["pk"][name] = None if leaves is None else _point(leaves, device)
    for name in ("A", "B", "C"):
        if name in arrays:
            m = arrays[name]
            state[name] = DeviceSparseMatrix(
                fr,
                torch.from_numpy(np.asarray(m["rows"]).astype(np.int64)).to(device),
                torch.from_numpy(np.asarray(m["cols"]).astype(np.int64)).to(device),
                limbs_from_jax(m["vals"], device),
                int(m["n_row"]),
                int(m["n_col"]),
            )
    return state


def points_from_jax(curve, blobs):
    """The port's points of `curve` from compressed point bytes, G1 or G2 by
    length, as the JAX package's [p.to_bytes() for p in ...] gives them: a
    KZG SRS (G1_tau + [G2_tau]), the IPA-PCS basis (G + [H]) or a
    Bulletproofs argument's generators (G + H + [B, B_blinding])."""
    from ..curves.point import get_g1_class, get_g2_class
    from ..ecc import curve_spec

    g1_len = curve_spec(curve).point_bytes
    g1, g2 = get_g1_class(curve), get_g2_class(curve)
    out = []
    for raw in blobs:
        raw = bytes(raw)
        if len(raw) not in (g1_len, 2 * g1_len):
            raise ValueError(f"Expected {g1_len} or {2 * g1_len} bytes, got {len(raw)}")
        out.append((g1 if len(raw) == g1_len else g2).from_bytes(raw))
    return out

