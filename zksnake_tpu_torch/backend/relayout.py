"""S1-S8: the relayout kernels of the MSM table probes, their plain PyTorch
versions and wrappers.

They replace the Pallas kernels of scripts/bench_sortdma.py (the JAX
package's TPU probe of a gather-free round-major MSM table; the sources are
csrc/relayout.cu). Planes are int32 tensors holding the u32 words' bits.

  S1 expand_rows     stage_dma          out[b] = src[starts[b] : starts[b] + R, :]
  S7 expand_rows_pm  stage_expand_dma_pm  the same function (its own counter)
  S3 expand_cols     stage_expand_dma   out[b] = x[:, starts[b] : starts[b] + R]
  S2 transpose_tile  stage_tkernel      x.T through 32 x 32 shared tiles
  S4 copy_tile       stage_tk_copy      x, tile by tile through shared memory by TMA
  S5 transpose_fat   stage_tk_fat       x.T in 64 x 64 tiles, 16 bytes a thread
  S6 transpose_mma   stage_tk_mxu       x.T on the tensor cores (u8 planes x I)
  S8 transpose_flat  stage_tk_flat      x.T for skinny (rows, M), whole output rows

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for CUDA tensors; any other device, a failed build or a launch error
raises. A bucket whose window does not lie inside the source (a start
below 0 or past n for a source of n + R rows; columns for S3) is zeros, in
the plain versions and the kernel alike.
"""

import torch

from . import kernels


# ------------------------------------------------------------ plain versions


def _windows(starts, R, n_src):
    """Each bucket's R source indices (clamped into the source) and whether
    its window lies inside the n_src rows or columns."""
    s = starts.long()
    inside = (s >= 0) & (s + R <= n_src)
    idx = torch.where(inside, s, 0)[:, None] + torch.arange(R, device=starts.device)
    return idx.clamp_(max=n_src - 1), inside


def expand_rows_plain(src, starts, R):
    """(n + R, w) -> (B2, R, w): bucket b is rows starts[b] .. starts[b] + R."""
    idx, inside = _windows(starts, R, src.shape[0])
    return torch.where(inside[:, None, None], src[idx], 0)


def expand_cols_plain(x, starts, R):
    """(nl, n + R) -> (B2, nl, R): bucket b is columns starts[b] .. + R."""
    idx, inside = _windows(starts, R, x.shape[1])
    return torch.where(inside[:, None, None], x[:, idx].transpose(0, 1), 0).contiguous()


def transpose_plain(x):
    """(rows, cols) -> (cols, rows)."""
    return x.t().contiguous()


def copy_plain(x):
    return x.clone()


# --------------------------------------------------------------- wrappers


def _on_card(name, ts):
    """The tensors' device, or None for the CPU (take the plain version);
    raises for any other device and for what the kernels do not take."""
    dev = kernels._device_of(*ts)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in ts:
        kernels._require(t, name)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte aligned planes")
    return dev


def _launch(name, dev, fn, *args):
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    kernels.LAUNCHES[name] += 1
    kernels._check(rc, name)


def _expand_rows(name, src, starts, R):
    dev = _on_card(name, (src, starts))
    if dev is None:
        return expand_rows_plain(src, starts, R)
    if src.ndim != 2 or starts.ndim != 1 or R < 0:
        raise ValueError(f"{name}: expected src (n + R, w), starts (B2,), R >= 0")
    w = src.shape[1]
    out = torch.empty((starts.shape[0], R, w), dtype=torch.int32, device=dev)
    _launch(name, dev, kernels._lib("relayout").zk_expand, src.data_ptr(), src.numel(), 0, 1,
            w, starts.data_ptr(), starts.shape[0], R * w, out.data_ptr())
    return out


def expand_rows(src, starts, R):
    """S1 (stage_dma) on CUDA, its plain version on the CPU."""
    return _expand_rows("expand_rows", src, starts, R)


def expand_rows_pm(src, starts, R):
    """S7 (stage_expand_dma_pm), the same function as S1 under its own
    counter, on CUDA; its plain version on the CPU."""
    return _expand_rows("expand_rows_pm", src, starts, R)


def expand_cols(x, starts, R):
    """S3 (stage_expand_dma) on CUDA, its plain version on the CPU."""
    dev = _on_card("expand_cols", (x, starts))
    if dev is None:
        return expand_cols_plain(x, starts, R)
    if x.ndim != 2 or starts.ndim != 1 or R < 0:
        raise ValueError("expand_cols: expected x (nl, n + R), starts (B2,), R >= 0")
    nl, ld = x.shape
    out = torch.empty((starts.shape[0], nl, R), dtype=torch.int32, device=dev)
    _launch("expand_cols", dev, kernels._lib("relayout").zk_expand, x.data_ptr(), x.numel(), ld,
            nl, 1, starts.data_ptr(), starts.shape[0], R, out.data_ptr())
    return out


def _relayout2d(name, x, plain, entry, transpose):
    dev = _on_card(name, (x,))
    if dev is None:
        return plain(x)
    if x.ndim != 2:
        raise ValueError(f"{name}: expected a 2-D plane, got {tuple(x.shape)}")
    rows, cols = x.shape
    out = torch.empty((cols, rows) if transpose else (rows, cols), dtype=torch.int32, device=dev)
    _launch(name, dev, getattr(kernels._lib("relayout"), entry), x.data_ptr(), out.data_ptr(),
            rows, cols)
    return out


def transpose_tile(x):
    """S2 (stage_tkernel) on CUDA, its plain version on the CPU."""
    return _relayout2d("transpose_tile", x, transpose_plain, "zk_tile32", True)


def copy_tile(x):
    """S4 (stage_tk_copy) on CUDA, its plain version on the CPU."""
    return _relayout2d("copy_tile", x, copy_plain, "zk_copy_tma", False)


def transpose_fat(x):
    """S5 (stage_tk_fat) on CUDA, its plain version on the CPU."""
    return _relayout2d("transpose_fat", x, transpose_plain, "zk_transpose_fat", True)


def transpose_mma(x):
    """S6 (stage_tk_mxu) on CUDA, its plain version on the CPU."""
    return _relayout2d("transpose_mma", x, transpose_plain, "zk_transpose_mma", True)


def transpose_flat(x):
    """S8 (stage_tk_flat) on CUDA, its plain version on the CPU."""
    return _relayout2d("transpose_flat", x, transpose_plain, "zk_transpose_flat", True)
