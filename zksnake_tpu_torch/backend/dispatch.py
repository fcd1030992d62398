"""Size-based dispatch between the torch backend and the host bigint path.

Port of zksnake_tpu/backend/dispatch.py: MSMs and batch scalar muls at or
above their threshold run on the curve module's torch device; smaller ones
run the host path (`_host_msm`, pure Python).
"""

from . import config


def _host_msm(curve_module, points, scalars):
    """Shared-doubling binary MSM on host bigints:
    acc = 2*acc; acc += P_i for each i with current bit set."""
    r = curve_module._curve.r
    ss = [int(s) % r for s in scalars]
    n = len(points)
    if n == 0:
        raise ValueError("Number of points and scalars mismatch")
    maxbits = max((s.bit_length() for s in ss), default=0)
    cls = type(points[0])
    acc = cls.identity()
    if maxbits == 0:
        return acc
    for b in range(maxbits - 1, -1, -1):
        acc = acc + acc
        for i in range(n):
            if (ss[i] >> b) & 1:
                acc = acc + points[i]
    return acc


def msm(curve_module, points, scalars, group):
    if len(points) != len(scalars):
        raise ValueError("Number of points and scalars mismatch")
    if config.use_device(curve_module.device, len(points), config.MSM_DEVICE_THRESHOLD):
        from .msm import msm_device

        cls = curve_module.PointG1 if group == 1 else curve_module.PointG2
        return msm_device(curve_module._curve, group, points, scalars, cls, curve_module.device)
    return _host_msm(curve_module, points, scalars)


def batch_scalar_mul(curve_module, points, scalars, group):
    assert len(points) == len(scalars)
    if config.use_device(curve_module.device, len(points), config.BATCHMUL_DEVICE_THRESHOLD):
        cls = curve_module.PointG1 if group == 1 else curve_module.PointG2
        dev = curve_module.device
        p0 = points[0]
        if all(p is p0 for p in points):
            # one base times many scalars: windowed fixed-base tables
            from .msm import batch_mul_fixed_base

            return batch_mul_fixed_base(curve_module._curve, group, p0, scalars, cls, dev)
        from .msm import batch_mul_device

        return batch_mul_device(curve_module._curve, group, points, scalars, cls, dev)
    return [g * s for g, s in zip(points, scalars)]
