"""Dispatch thresholds and device checks for the torch backend.

Port of zksnake_tpu/backend/config.py. Below a threshold a bulk op runs the
host bigint path (a size rule: small inputs are latency-bound); at or above
it the op runs on the caller's torch device. The device is always the
caller's: nothing here picks the CPU when CUDA is missing.
"""

import os

import torch

MSM_DEVICE_THRESHOLD = int(os.environ.get("ZKSNAKE_MSM_THRESHOLD", "256"))
BATCHMUL_DEVICE_THRESHOLD = int(os.environ.get("ZKSNAKE_BATCHMUL_THRESHOLD", "64"))
NTT_DEVICE_THRESHOLD = int(os.environ.get("ZKSNAKE_NTT_THRESHOLD", "512"))
PLONK_DEVICE_THRESHOLD = int(os.environ.get("ZKSNAKE_PLONK_THRESHOLD", "2048"))
MLE_DEVICE_THRESHOLD = int(os.environ.get("ZKSNAKE_MLE_THRESHOLD", "4096"))


def mxu_montmul():
    """ZKSNAKE_MXU_MONTMUL=1 routes large flat Montgomery products to K3
    and bucket accumulation to K2m, the tensor-core reductions (read at
    call time, as zksnake_tpu/backend/field.py::_mxu_montmul does); K1 and
    K2 are the default."""
    return os.environ.get("ZKSNAKE_MXU_MONTMUL", "0") == "1"


def check_device(device):
    """torch.device for `device`; raises when it is CUDA and no CUDA device
    is present (no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def use_device(device, n, threshold):
    """True when an op of size n runs on `device` rather than the host."""
    check_device(device)
    return n >= threshold
