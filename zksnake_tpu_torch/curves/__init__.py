"""Curve backends exposing the same surface as the reference's native
`zksnake._algebra.ec_bn254` / `ec_bls12_381` modules
(upstream zksnake: src/lib.rs:6-68): PointG1, PointG2, g1(), g2(), pairing,
multi_pairing, batch_multi_scalar_g{1,2}, multiscalar_mul_g{1,2}.

The MSM / batch scalar-mul entry points dispatch to the torch backend on
the module's device for large inputs and run the host bigint path for small
ones. One module per (curve, device); the point classes are per curve.
"""

import torch

from .params import CURVES
from .point import get_g1_class, get_g2_class, PointG12
from .pairing import get_engine


class CurveModule:
    """One curve's operation namespace (equivalent of the Rust submodule),
    with its bulk ops on the torch `device`."""

    def __init__(self, name, device):
        self._curve = CURVES[name]
        self.name = self._curve.name
        self.device = torch.device(device)
        self.PointG1 = get_g1_class(name)
        self.PointG2 = get_g2_class(name)
        self.PointG12 = PointG12

    def g1(self):
        return self.PointG1.gen()

    def g2(self):
        return self.PointG2.gen()

    def pairing(self, a, b):
        return get_engine(self.name).pairing(a, b)

    def multi_pairing(self, a, b):
        return get_engine(self.name).multi_pairing(a, b)

    # --- bulk kernels (device-backed) ---
    def batch_multi_scalar_g1(self, points, scalars):
        from ..backend import dispatch

        return dispatch.batch_scalar_mul(self, points, scalars, group=1)

    def batch_multi_scalar_g2(self, points, scalars):
        from ..backend import dispatch

        return dispatch.batch_scalar_mul(self, points, scalars, group=2)

    def multiscalar_mul_g1(self, points, scalars):
        from ..backend import dispatch

        return dispatch.msm(self, points, scalars, group=1)

    def multiscalar_mul_g2(self, points, scalars):
        from ..backend import dispatch

        return dispatch.msm(self, points, scalars, group=2)


_MODULES = {}


def get_curve_module(name, device):
    """The curve module of `name` (aliases BN128, ALT_BN128) on `device`."""
    name = CURVES[name].name
    key = (name, str(torch.device(device)))
    if key not in _MODULES:
        _MODULES[key] = CurveModule(name, device)
    return _MODULES[key]
