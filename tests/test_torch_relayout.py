"""S1-S8 of the PyTorch port against the Pallas kernels they replace.

Each reference is the pallas_call of scripts/bench_sortdma.py (its kernel
body and block specs copied from the cited lines) at small sizes, run on the
CPU with interpret=True. The port's wrappers take their plain versions for
CPU tensors, and those must equal the references bit for bit (the u32 words
are held in int32 tensors: compared through .view(np.uint32)). The changes
to the copied code: S1's store writes `out_ref[0]`, since its (1, R, 2 NL)
output block does not take an (R, 2 NL) value in interpret mode, and
`pl.ANY` stands for its deprecated alias `pltpu.ANY`. The
kernels themselves run only on a card (tests/test_torch_kernels_cuda.py).

The ported script, zksnake_tpu_torch.scripts.bench_sortdma, runs every
stage here at toy sizes, and its kernel stages equal their plain versions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from zksnake_tpu_torch.backend import relayout
from zksnake_tpu_torch.scripts import bench_sortdma

import torch_support  # noqa: F401  (torch on one thread)

NL = 16


def draw(seed, high, shape):
    """The same u32 words for both packages: (numpy u32, torch int32 bits)."""
    a = np.random.default_rng(seed).integers(0, high, size=shape).astype(np.uint32)
    return a, torch.from_numpy(a.view(np.int32))


def sorted_starts(n, b2, seed):
    """b2 sorted starts in [0, n), the last one n - 1 (the source's last window)."""
    st = np.sort(np.random.default_rng(seed).integers(0, n, size=b2)).astype(np.int32)
    st[-1] = n - 1
    return st


def same(got, want):
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


# ------------------------------------------------- the Pallas references --


def pallas_dma(src, starts, B2, R):
    """bench_sortdma.py:103-121 (stage_dma, S1)."""

    def kernel(starts_ref, src_ref, out_ref):
        b = pl.program_id(0)
        s = starts_ref[b]
        out_ref[0] = src_ref[pl.ds(s, R), :]

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(B2,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, R, 2 * NL), lambda b, starts: (b, 0, 0)),
    )
    return pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((B2, R, 2 * NL), jnp.uint32), interpret=True,
    )(jnp.asarray(starts), jnp.asarray(src))


def pallas_tkernel(x, B2, M):
    """bench_sortdma.py:151-162 (stage_tkernel, S2)."""

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...].T

    return pl.pallas_call(
        kernel,
        grid=(B2 // 128, M // 128),
        in_specs=[pl.BlockSpec((128, 128), lambda i, j: (i, j))],
        out_specs=pl.BlockSpec((128, 128), lambda i, j: (j, i)),
        out_shape=jax.ShapeDtypeStruct((M, B2), jnp.uint32), interpret=True,
    )(jnp.asarray(x))


def pallas_expand_dma(x, starts, B2, R):
    """bench_sortdma.py:193-216 (stage_expand_dma, S3)."""

    def kernel(starts_ref, x_ref, o_ref, sem):
        b = pl.program_id(0)
        s = starts_ref[b]
        dma = pltpu.make_async_copy(x_ref.at[:, pl.ds(s, R)], o_ref.at[0], sem)
        dma.start()
        dma.wait()

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(B2,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, NL, R), lambda b, starts: (b, 0, 0)),
        scratch_shapes=[pltpu.SemaphoreType.DMA(())],
    )
    return pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((B2, NL, R), jnp.uint32), interpret=True,
    )(jnp.asarray(starts), jnp.asarray(x))


def pallas_tk_copy(x, B2, M):
    """bench_sortdma.py:291-302 (stage_tk_copy, S4)."""

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    return pl.pallas_call(
        kernel,
        grid=(B2 // 128, M // 128),
        in_specs=[pl.BlockSpec((128, 128), lambda i, j: (i, j))],
        out_specs=pl.BlockSpec((128, 128), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((B2, M), jnp.uint32), interpret=True,
    )(jnp.asarray(x))


def pallas_tk_fat(x, B2, M):
    """bench_sortdma.py:321-335 (stage_tk_fat, S5)."""

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...].T

    return pl.pallas_call(
        kernel,
        grid=(B2 // 512,),
        in_specs=[pl.BlockSpec((512, M), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((M, 512), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((M, B2), jnp.uint32),
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True,
    )(jnp.asarray(x))


def pallas_tk_mxu(x, B2, M):
    """bench_sortdma.py:354-388 (stage_tk_mxu, S6)."""
    TB = 512

    def kernel(x_ref, o_ref):
        xb = x_ref[...]  # (TB, M)
        eye = (
            jax.lax.broadcasted_iota(jnp.int32, (TB, TB), 0)
            == jax.lax.broadcasted_iota(jnp.int32, (TB, TB), 1)
        ).astype(jnp.float32)
        lo = (xb & 0xFFFF).astype(jnp.int32).astype(jnp.float32)
        hi = (xb >> 16).astype(jnp.int32).astype(jnp.float32)
        dn = (((0,), (0,)), ((), ()))
        tlo = jax.lax.dot_general(lo, eye, dn, preferred_element_type=jnp.float32)
        thi = jax.lax.dot_general(hi, eye, dn, preferred_element_type=jnp.float32)
        o_ref[...] = tlo.astype(jnp.int32).astype(jnp.uint32) | (
            thi.astype(jnp.int32).astype(jnp.uint32) << 16
        )

    return pl.pallas_call(
        kernel,
        grid=(B2 // TB,),
        in_specs=[pl.BlockSpec((TB, M), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((M, TB), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((M, B2), jnp.uint32),
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True,
    )(jnp.asarray(x))


def pallas_expand_dma_pm(src, starts, B2, R):
    """bench_sortdma.py:415-438 (stage_expand_dma_pm, S7)."""

    def kernel(starts_ref, x_ref, o_ref, sem):
        b = pl.program_id(0)
        s = starts_ref[b]
        dma = pltpu.make_async_copy(x_ref.at[pl.ds(s, R), :], o_ref.at[0], sem)
        dma.start()
        dma.wait()

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(B2,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, R, 2 * NL), lambda b, starts: (b, 0, 0)),
        scratch_shapes=[pltpu.SemaphoreType.DMA(())],
    )
    return pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((B2, R, 2 * NL), jnp.uint32), interpret=True,
    )(jnp.asarray(starts), jnp.asarray(src))


def pallas_tk_flat(x, M):
    """bench_sortdma.py:464-484 (stage_tk_flat, S8)."""
    BT = 32768

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...].T

    return pl.pallas_call(
        kernel,
        grid=(M // BT,),
        in_specs=[pl.BlockSpec((2 * NL, BT), lambda i: (0, i))],
        out_specs=pl.BlockSpec((BT, 2 * NL), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, 2 * NL), jnp.uint32),
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True,
    )(jnp.asarray(x))


# ---------------------------------------------------------------- S1-S8 --


@pytest.mark.parametrize("name, pallas, R", [
    ("expand_rows", pallas_dma, 17),  # S1
    ("expand_rows_pm", pallas_expand_dma_pm, 19),  # S7
])
def test_expand_rows_match_pallas(name, pallas, R):
    n, B2 = 256, 24
    src, src_t = draw(5, 1 << 30, (n + R, 2 * NL))
    starts = sorted_starts(n, B2, 6)
    got = getattr(relayout, name)(src_t, torch.from_numpy(starts), R)
    same(got, pallas(src, starts, B2, R))


def test_expand_cols_matches_pallas():
    """S3: the async-copy (DMA and semaphore) kernel."""
    n, B2, R = 256, 24, 19
    x, x_t = draw(7, 1 << 30, (NL, n + R))
    starts = sorted_starts(n, B2, 8)
    same(relayout.expand_cols(x_t, torch.from_numpy(starts), R), pallas_expand_dma(x, starts, B2, R))


@pytest.mark.parametrize("name", ["expand_rows", "expand_rows_pm", "expand_cols"])
def test_expand_zeros_windows_outside_the_source(name):
    """A start below 0 or past n (a window not inside the n + R source rows,
    or columns for S3) gives a bucket of zeros, as the kernel does; a start
    of n still gives the last window."""
    n, R = 64, 9
    x, x_t = draw(10, 1 << 30, (n + R, 2 * NL) if name != "expand_cols" else (NL, n + R))
    starts = np.array([3, n, n + 1, -1, 1 << 30], dtype=np.int32)
    got = getattr(relayout, name)(x_t, torch.from_numpy(starts), R).numpy().view(np.uint32)
    assert not got[2:].any()
    want = [x[s:s + R] if name != "expand_cols" else x[:, s:s + R] for s in starts[:2]]
    np.testing.assert_array_equal(got[:2], np.stack(want))


@pytest.mark.parametrize("name, pallas, B2, M", [
    ("transpose_tile", pallas_tkernel, 256, 384),  # S2
    ("copy_tile", pallas_tk_copy, 256, 384),  # S4
    ("transpose_fat", pallas_tk_fat, 1024, 96),  # S5
    ("transpose_mma", pallas_tk_mxu, 1024, 96),  # S6
])
def test_relayout_2d_matches_pallas(name, pallas, B2, M):
    """Words of all 32 bits; row 3 is all 0xFF bytes (S6's byte planes)."""
    x, x_t = draw(6, 1 << 32, (B2, M))
    x[3] = 0xFFFFFFFF
    same(getattr(relayout, name)(x_t), pallas(x, B2, M))


def test_transpose_flat_matches_pallas():
    """S8: the (2 NL, M) -> (M, 2 NL) transpose in its (2 NL, 32768) blocks."""
    M = 2 * 32768
    x, x_t = draw(9, 1 << 30, (2 * NL, M))
    same(relayout.transpose_flat(x_t), pallas_tk_flat(x, M))


# ------------------------------------------------------ the ported script --

TOY = {"b2": 48, "r_dma": 17, "r": 19}


@pytest.mark.parametrize("stage", bench_sortdma.STAGES)
def test_bench_sortdma_stage_runs(stage):
    """Every stage of the ported script at toy sizes: its result line, and
    its spot check (in measure) passes."""
    res = bench_sortdma.measure(stage, 1 << 9, "cpu", TOY)
    assert res["stage"] == stage and res["s"] > 0
    assert ("gb_per_s" in res) == (stage != "sort")


@pytest.mark.parametrize("stage", sorted(bench_sortdma.KERNELS))
def test_bench_sortdma_kernel_stage_equals_plain(stage):
    """A kernel stage's wrapper on its own inputs equals its plain version
    on them (the comparison chip_smoke.py makes on the card)."""
    st = bench_sortdma.make(stage, 1 << 9, torch.device("cpu"), TOY)
    _, plain = bench_sortdma.KERNELS[stage]
    assert torch.equal(st.run(*st.args), plain(*st.args))


def test_bench_sortdma_expand_scan_equals_the_expansion():
    """The torch-only expansion stage computes S3's function."""
    st = bench_sortdma.make("expand_scan", 1 << 9, torch.device("cpu"), TOY)
    assert torch.equal(st.run(*st.args), relayout.expand_cols_plain(*st.args))
