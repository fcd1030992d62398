"""The port's hand-written CUDA kernels, their plain PyTorch versions, and
their launch counters.

K1 `mont_mul` (csrc/montmul.cu) replaces
zksnake_tpu/backend/pallas_field.py::_make_kernel; K2 `bucket_accumulate`
(csrc/bucket.cu) replaces pallas_field.py::bucket_accumulate_pallas; K3
`mont_mul_mma` (csrc/montmul_mma.cu on the warp-level product of
csrc/mma_frag.cuh) replaces pallas_field.py::_make_kernel_mxu (body
mxu_field.py::mont_mul_mxu_cols), the Montgomery product whose two
reduction products run on the matrix unit; K2m `bucket_accumulate_mma`
(csrc/bucket_mma.cu) replaces the same bucket_accumulate_pallas under
ZKSNAKE_MXU_MONTMUL=1, where every product of its body is K3's arithmetic
(on WMMA tiles in shared memory): K2's chunk and fold kernels
(csrc/bucket_chunks.cuh) on the tensor-core product. K4 `bucket_reduce`
(csrc/bucket_reduce.cu) replaces no TPU kernel (the JAX package reduces
its buckets in plain jnp): it runs an MSM pass's bucket reduction, the
point ops of its plain version, in two launches.

S1-S8 (csrc/relayout.cu) replace the Pallas kernels of
scripts/bench_sortdma.py, the relayout probes of the MSM table; their
wrappers and plain versions are in backend/relayout.py. S9 `g2_block`
(csrc/g2_block.cu) replaces the one-block G2 probes of
scripts/debug_g2_mosaic.py. Their launch counters are here with the rest.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor; any other device, a failed build or a launch
error raises. There is no fallback from the kernel to the plain version.

The kernels are built with nvcc into shared libraries with a plain C
interface (loaded with ctypes) at first use, into zksnake_tpu_torch/_build/,
from csrc/ only, and rebuilt when a source is newer than its library.
Nothing here imports a CUDA toolchain at module import.
"""

import ctypes
import functools
import math
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from .. import metrics
from .limbs import MASK, W

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# K2 sums every run in chunks of at most T consecutive points, then folds
# each bucket's chunks (csrc/bucket.cu). The kernel source's Shape fixes,
# per build and group, how many chunks a lane sums at once (k2_members);
# the wrapper passes T (k2_chunk). K2_CHUNK is T where a thread sums one
# chunk in projective coordinates (k2_members 0: BN254's G1), and the
# chunk length msm.fixed_base_window's cost model assumes.
K2_CHUNK = 8
# library -> (source, extra nvcc flags); K2, K2m and K4 are built once per
# limb count
_SOURCES = {
    "montmul": ("montmul.cu", []),
    "montmul_mma": ("montmul_mma.cu", []),
    "bucket16": ("bucket.cu", ["-DZK_NL=16"]),
    "bucket24": ("bucket.cu", ["-DZK_NL=24"]),
    "bucket_mma16": ("bucket_mma.cu", ["-DZK_NL=16"]),
    "bucket_mma24": ("bucket_mma.cu", ["-DZK_NL=24"]),
    "bucket_reduce16": ("bucket_reduce.cu", ["-DZK_NL=16"]),
    "bucket_reduce24": ("bucket_reduce.cu", ["-DZK_NL=24"]),
    "relayout": ("relayout.cu", []),
    "g2_block": ("g2_block.cu", []),
}

# launches of each kernel since the last reset_launches()
LAUNCHES = {"mont_mul": 0, "bucket_accumulate": 0, "mont_mul_mma": 0,
            "bucket_accumulate_mma": 0, "bucket_reduce": 0, "expand_rows": 0,
            "transpose_tile": 0, "expand_cols": 0, "copy_tile": 0, "transpose_fat": 0,
            "transpose_mma": 0, "expand_rows_pm": 0, "transpose_flat": 0, "g2_block": 0}

_LIBS = {}
_LOCK = threading.Lock()

# K2's C interface (csrc/bucket.cu), and K2m's (csrc/bucket_mma.cu): the
# same with K3's tile bytes before the stream
_VP, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
_K2_ARGTYPES = [_VP] * 6 + [_I] * 4 + [_LL, _LL, _I, _VP, _U32, _VP, _VP, _VP, _I, _VP]
BUCKET_ARGTYPES = {False: _K2_ARGTYPES + [_VP], True: _K2_ARGTYPES + [_VP, _VP]}
# K4's two entry points (csrc/bucket_reduce.cu): the field constants and 3b
# as K2 takes them, then the stream
_K4_CONSTS = [_VP, _U32, _VP, _VP, _I, _VP]
REDUCE_ARGTYPES = {"zk_bucket_reduce_windows": [_VP] * 3 + [_I] * 7 + _K4_CONSTS,
                   "zk_bucket_reduce_horner": [_VP] * 2 + [_I] * 5 + _K4_CONSTS}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ build --


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name):
    return os.path.join(BUILD_DIR, f"libzk_{name}.so")


def _stale(name):
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(
        os.path.getmtime(os.path.join(CSRC, f)) > t for f in os.listdir(CSRC)
    )


def build(names=None):
    """Compile the stale kernel libraries (in parallel, one nvcc each), K4's
    with K2's or K2m's of its limb count, since every MSM that runs one runs
    the other. Returns {name: seconds}; raises with nvcc's output on
    failure. nvcc's -Xptxas -v report (registers, spills) lands in
    _build/<name>.ptxas.txt."""
    names = list(names or _SOURCES)
    k4 = {f"bucket_reduce{n[-2:]}" for n in names if n.startswith("bucket")}
    names += sorted(k4 - set(names))
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _lib_path(name) + f".tmp{os.getpid()}"
        src, extra = _SOURCES[name]
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    times, errors = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {_SOURCES[name][0]} ({name}) failed:\n{log}")
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def ptxas_report(name):
    """[(kernel, registers, spill store bytes)] of library `name`, from its
    nvcc -Xptxas -v log; a kernel is named by its identifier and, for the
    field templates, Fp or Fp2 (G1 or G2), and "normal" for the fold's
    normal-form instance (its template's one bool set)."""
    import re

    path = os.path.join(BUILD_DIR, f"{name}.ptxas.txt")
    if not os.path.exists(path):
        return []
    rows, kernel, spills = [], None, 0
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                mangled = m.group(1)  # _Z[N] then length-prefixed names
                i, idents = 3 if mangled.startswith("_ZN") else 2, []
                while (j := re.match(r"\d+", mangled[i:])):
                    i += j.end()
                    idents.append(mangled[i:i + int(j.group())])
                    i += int(j.group())
                ident = idents[-1] if idents else mangled
                field = "Fp2" if "Fp2I" in mangled else "Fp" if "FpI" in mangled else ""
                words = re.match(r"ILi(\d+)E", mangled[i:])  # a template's <int>
                if ident.startswith("montmul") and words:
                    field = f"NW={words.group(1)}"
                elif ident.startswith("g2_"):  # S9's kernels: <variant> where templated
                    field = f"V={words.group(1)}" if words else ""
                tags = [field] * bool(field) + ["normal"] * ("Lb1E" in mangled)
                kernel = ident + (f"<{', '.join(tags)}>" if tags else "")
                spills = 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                rows.append((kernel, int(m.group(1)), spills))
                kernel = None
    return rows


def _lib(name):
    with _LOCK:
        if name not in _LIBS:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            vp, i, ll, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
            if name == "montmul":
                lib.zk_mont_mul.argtypes = [vp, vp, vp, ll, i, vp, u32, vp]
                lib.zk_mont_mul.restype = i
                lib.zk_error_string.argtypes = [i]
                lib.zk_error_string.restype = ctypes.c_char_p
            elif name == "montmul_mma":
                lib.zk_mont_mul_mma.argtypes = [vp, vp, vp, ll, i, vp, vp, vp]
                lib.zk_mont_mul_mma.restype = i
            elif name == "relayout":
                lib.zk_expand.argtypes = [vp, ll, ll, i, i, vp, i, ll, vp, vp]
                for fn in (lib.zk_expand, lib.zk_tile32, lib.zk_copy_tma, lib.zk_transpose_fat,
                           lib.zk_transpose_flat, lib.zk_transpose_mma):
                    fn.restype = i
                for fn in (lib.zk_tile32, lib.zk_copy_tma, lib.zk_transpose_fat,
                           lib.zk_transpose_flat, lib.zk_transpose_mma):
                    fn.argtypes = [vp, vp, i, i, vp]
            elif name == "g2_block":
                lib.zk_g2_block.argtypes = [i, vp, i, vp, i, ll, i, vp, u32, vp, vp, vp]
                lib.zk_g2_block.restype = i
            elif name.startswith("bucket_reduce"):
                for fn, argtypes in REDUCE_ARGTYPES.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = i
            else:
                bucket_lib(lib, name.startswith("bucket_mma"))
            _LIBS[name] = lib
        return _LIBS[name]


def bucket_lib(lib, mma):
    """K2's (mma=False) or K2m's library `lib` (ctypes.CDLL), its entry
    points typed: zk_bucket_accumulate[_mma] and zk_bucket_members."""
    fn = lib.zk_bucket_accumulate_mma if mma else lib.zk_bucket_accumulate
    fn.argtypes = BUCKET_ARGTYPES[mma]
    fn.restype = ctypes.c_int
    lib.zk_bucket_members.argtypes = [ctypes.c_int]
    lib.zk_bucket_members.restype = ctypes.c_int
    return lib


def _check(rc, what):
    if rc != 0:
        msg = _lib("montmul").zk_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _require(t, name, shape=None):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _device_of(*ts):
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {dev} vs {t.device}")
    return dev


# -------------------------------------------------------------------- K1 --


def mont_mul_plain(fs, a, b):
    """Plain version of K1 on any device: a, b (nl, N) int32 16-bit limbs in
    Montgomery form -> a*b*R^-1 mod p, canonical, same layout. Exact int64
    arithmetic on lazy 16-bit columns (limb products < 2^32)."""
    from .field import _cond_sub_p, _normalize

    nl = fs.nl
    c = fs.plain_consts(a.device)
    a = a.long()
    b = b.long()
    n = a.shape[1]
    if n <= 256:
        # few lanes, so few tensor ops: separated reduction. T = a*b,
        # m = (T mod R) * (-p^-1) mod R, (T + m*p) / R; each product is an
        # outer product of limbs, row i shifted right by i and summed
        # (columns: T < 2^37, m < 2^57 before normalizing)
        def conv(x, y):
            prod = torch.constant_pad_nd(x[:, None, :] * y[None, :, :], (0, 0, 0, nl))
            skew = prod.expand(nl, 2 * nl, n).reshape(2 * nl * nl, n)[: nl * (2 * nl - 1)]
            return torch.constant_pad_nd(skew.reshape(nl, 2 * nl - 1, n).sum(0), (0, 0, 0, 1))

        t = conv(a, b)
        m = _normalize(conv(t[:nl], c["pprime"])[:nl], 4)  # m mod R, 16-bit limbs
        u = _normalize(t + conv(m, c["p"]), 3)  # T + m p; its low half is zero
        return _cond_sub_p(fs, u[nl:].to(torch.int32))
    # many lanes, so least work: the interleaved 16-bit CIOS of
    # zksnake_tpu/backend/field.py::_mont_mul_cols, columns < 2^38
    t = torch.zeros((2 * nl + 1, n), dtype=torch.int64, device=a.device)
    for i in range(nl):
        t[i : i + nl] += a[i] * b
    p = c["p"]
    for i in range(nl):
        m = ((t[i] & MASK) * fs.pinv) & MASK
        t[i : i + nl] += m * p
        t[i + 1] += t[i] >> W
    out = []
    carry = torch.zeros_like(t[0])
    for j in range(nl, 2 * nl):
        v = t[j] + carry
        out.append(v & MASK)
        carry = v >> W
    return _cond_sub_p(fs, torch.stack(out).to(torch.int32))


def mont_mul(fs, a, b):
    """K1 on CUDA, its plain version on the CPU. a, b: (nl, N) int32."""
    dev = _device_of(a, b)
    if dev.type == "cpu":
        return mont_mul_plain(fs, a, b)
    if dev.type != "cuda":
        raise ValueError(f"mont_mul: unsupported device {dev}")
    _require(a, "a")
    _require(b, "b", a.shape)
    if a.ndim != 2 or a.shape[0] != fs.nl:
        raise ValueError(f"mont_mul: expected ({fs.nl}, N), got {tuple(a.shape)}")
    lib = _lib("montmul")
    out = torch.empty_like(a)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zk_mont_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1], fs.nl,
            ctypes.addressof(fs.words("p")), fs.pinv32, stream,
        )
    LAUNCHES["mont_mul"] += 1
    _check(rc, "mont_mul")
    return out


# -------------------------------------------------------------------- K3 --


@functools.lru_cache(maxsize=None)
def _reduction_mats(p: int, nl: int):
    """(PMAT, PPMAT) numpy f32 constant matrices for modulus p, as
    zksnake_tpu/backend/mxu_field.py::_reduction_mats builds them.

    PMAT  (NB x NB+1): row k = byte k of m_conv: m[k] = sum_i T8[i]*P'[k-i]
    PPMAT (2NB+1 x NB): row k = byte k of (m*p) conv (full, both halves)
    where NB = 2*nl bytes per R-sized value and P' = -p^-1 mod R. Column NB
    of PMAT and row 2NB of PPMAT are zero: the kernel and the plain version
    use the NB x NB and 2NB x NB blocks."""
    NB = 2 * nl
    R = 1 << (W * nl)
    pprime = (-pow(p, -1, R)) % R
    pb = [(pprime >> (8 * i)) & 0xFF for i in range(NB)]
    pbyte = [(p >> (8 * i)) & 0xFF for i in range(NB)]
    PMAT = np.zeros((NB, NB + 1), dtype=np.float32)
    for k in range(NB):
        for i in range(NB + 1):
            j = k - i
            if 0 <= j < NB:
                PMAT[k, i] = pb[j]
    PPMAT = np.zeros((2 * NB + 1, NB), dtype=np.float32)
    for k in range(2 * NB + 1):
        for i in range(NB):
            j = k - i
            if 0 <= j < NB:
                PPMAT[k, i] = pbyte[j]
    return PMAT, PPMAT


def mma_frag_tiles(nl):
    """[(product, nt, ks)]: the tiles of K3's constant B fragments in the
    order of its table (csrc/mma_frag.cuh). Product 0 is PMAT's NB x NB
    block, 1 PPMAT's 2NB x NB block, as B = the block's transpose: n8 tile
    nt is output bytes 8nt..8nt+7, k32 step ks input bytes 32ks..32ks+31
    (NB = 48 padded to 64). A tile that holds no byte of the band
    0 <= k - i < NB (above PMAT's diagonal, PPMAT's corners) has no entry:
    12 tiles for nl = 16, 26 for nl = 24."""
    nb = 2 * nl

    def live(nt, ks):
        return 32 * ks < nb and 32 * ks <= 8 * nt + 7 and 8 * nt - min(32 * ks + 31, nb - 1) < nb

    return [(prod, nt, ks) for prod, ntiles in ((0, nb // 8), (1, nb // 4))
            for nt in range(ntiles) for ks in range((nb + 31) // 32) if live(nt, ks)]


def mont_mul_mma_plain(fs, a, b):
    """Plain version of K3 on any device: the SOS Montgomery product of
    zksnake_tpu/backend/mxu_field.py::mont_mul_mxu_cols. a, b (nl, N) int32
    16-bit limbs in Montgomery form -> a*b*R^-1 mod p, canonical.

    T = a*b in lazy 16-bit int64 columns; its low half normalized to exact
    limbs and cut into NB = 2 nl byte planes; m = (T mod R) P' mod R and
    m p as float64 products against the byte-Toeplitz matrices (exact: every
    sum is below 255^2 NB < 2^53; float64 because torch has no integer
    matmul on CUDA, and TF32 never touches float64); one carry chain, then a
    conditional subtract of p."""
    from .field import _cond_sub_p

    nl = fs.nl
    NB = 2 * nl
    pmat, ppmat = fs.mma_mats(a.device)
    a = a.long()
    b = b.long()
    n = a.shape[1]
    t = torch.zeros((2 * nl, n), dtype=torch.int64, device=a.device)
    for i in range(nl):
        t[i : i + nl] += a[i] * b  # columns < 2 nl 2^32
    # exact 16-bit limbs of T mod R; the carry out moves into column nl
    carry = torch.zeros_like(t[0])
    for j in range(nl):
        v = t[j] + carry
        t[j] = v & MASK
        carry = v >> W
    t[nl] += carry
    t8 = torch.stack([t[:nl] & 0xFF, t[:nl] >> 8], dim=1).reshape(NB, n)
    m_conv = torch.matmul(pmat, t8.double()).long()  # (NB, n) < 255^2 NB
    m8 = torch.empty_like(m_conv)
    mc = torch.zeros_like(m_conv[0])
    for k in range(NB):  # bytes of m mod R (the last carry is dropped)
        v = m_conv[k] + mc
        m8[k] = v & 0xFF
        mc = v >> 8
    mp = torch.matmul(ppmat, m8.double()).long()  # (2 NB, n) byte columns of m p
    t += mp[0::2] + (mp[1::2] << 8)
    out = []
    c = torch.zeros_like(t[0])
    for j in range(2 * nl):  # (T + m p) / R: the low half is zero
        v = t[j] + c
        if j >= nl:
            out.append(v & MASK)
        c = v >> W
    return _cond_sub_p(fs, torch.stack(out).to(torch.int32), c)


def mont_mul_mma(fs, a, b):
    """K3 on CUDA, its plain version on the CPU. a, b: (nl, N) int32."""
    dev = _device_of(a, b)
    if dev.type == "cpu":
        return mont_mul_mma_plain(fs, a, b)
    if dev.type != "cuda":
        raise ValueError(f"mont_mul_mma: unsupported device {dev}")
    _require(a, "a")
    _require(b, "b", a.shape)
    if a.ndim != 2 or a.shape[0] != fs.nl:
        raise ValueError(f"mont_mul_mma: expected ({fs.nl}, N), got {tuple(a.shape)}")
    lib = _lib("montmul_mma")
    frags = fs.mma_frags(dev)
    out = torch.empty_like(a)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zk_mont_mul_mma(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1], fs.nl,
            ctypes.addressof(fs.words("p")), frags.data_ptr(), stream,
        )
    LAUNCHES["mont_mul_mma"] += 1
    _check(rc, "mont_mul_mma")
    return out


# -------------------------------------------------------------------- K2 --


def _run_sums(gs, rows, base, lens):
    """Sum each run of points of `rows` (L, nl, W n) from the identity, in
    rank order: run i is slots base[i] .. base[i] + lens[i] - 1. Round k
    adds the rank-k point of every run that still has one, which is the
    JAX loop's mask (zksnake_tpu/backend/msm.py:370-390) applied by
    gathering the live lanes. Returns (3|6, nl, len(base))."""
    acc = torch.stack(gs.leaves(gs.identity((base.numel(),), rows.device)))
    maxrun = int(lens.max()) if lens.numel() else 0
    for k in range(maxrun):
        live = torch.nonzero(lens > k).squeeze(1)
        Q = gs.unflatten(list(rows[:, :, base[live] + k]))
        P = gs.unflatten(list(acc[:, :, live]))
        acc[:, :, live] = torch.stack(gs.leaves(gs.add_affine(P, Q)))
    return acc


def affine_normal_form(gs, sums):
    """Projective points (3|6, nl, ...) -> the same points as (X, Y, 1), or
    (0, 1, 0) for the identity, Montgomery form: K2's output form, the one
    representative of each point. 1 / Z (conj(Z) / norm for G2) comes from
    one batched inversion on the host (utils.batch_modinv); the products
    are gs's."""
    from ..utils import batch_modinv

    fs, F, dev = gs.fs, gs.F, sums.device
    shape = sums.shape
    X, Y, Z = gs.unflatten([t.reshape(shape[1], -1) for t in sums])
    p = fs.p
    if gs.group == 1:
        z = fs.from_mont_host(Z)
        norms = z
    else:
        z = list(zip(fs.from_mont_host(Z[0]), fs.from_mont_host(Z[1])))
        norms = [(a * a + b * b) % p for a, b in z]
    live = [i for i, v in enumerate(norms) if v]
    inv = [0] * len(norms)
    for i, v in zip(live, batch_modinv([norms[i] for i in live], p)):
        inv[i] = v

    def mont(vals):
        return fs.to_device(fs.to_mont_host(vals), dev)

    if gs.group == 1:
        zi = mont(inv)
    else:
        zi = (mont([a * v % p for (a, _), v in zip(z, inv)]),
              mont([-b * v % p for (_, b), v in zip(z, inv)]))
    ax, ay = F.mul_many([(X, zi), (Y, zi)])
    inf = torch.tensor([not v for v in norms], device=dev)
    zero, one = F.zeros(inf.shape, dev), F.one(inf.shape, dev)
    out = (F.select(inf, zero, ax), F.select(inf, one, ay), F.select(inf, zero, one))
    return torch.stack(gs.leaves(out)).reshape(shape)


def bucket_accumulate_plain(gs, pts, starts, lens, mode=True, affine=False):
    """Plain version of K2 on any device: every run summed from the identity
    in rank order (the JAX package's per-round loop, zksnake_tpu/backend/
    msm.py:370-390), with the complete mixed add. `affine=True` brings the
    sums to affine normal form (affine_normal_form: one batched inversion a
    call, on the host), which is K2's output where it sums in affine
    coordinates (k2_members > 0): unique, so the kernel, which sums in its
    own order (csrc/bucket.cu), equals it limb for limb; the projective
    order's sums equal it once brought to that form. `mode`
    picks the field product (GroupSpec.plain): True K1's plain version,
    "mma" K3's; `mode="mma", affine=True` is K2m's plain version, the same
    limbs.

    pts: (L, nl, W, n) sorted planes (K2's input layout); starts, lens:
    (W, B2) int32. Returns the (3 or 6, nl, W, B2) bucket sums."""
    gs = gs.plain(mode)
    L, nl, Wn, n = pts.shape
    B2 = starts.shape[1]
    nb = Wn * B2
    rows = pts.reshape(L, nl, Wn * n)
    base = (torch.arange(nb, device=pts.device) // B2) * n + starts.reshape(-1).long()
    sums = _run_sums(gs, rows, base, lens.reshape(-1).long()).reshape(-1, nl, Wn, B2)
    return affine_normal_form(gs, sums) if affine else sums


def k2_members(gs, mma=False):
    """The chunks a lane of K2's (K2m's) chunk kernel sums at once for
    gs's group, read from the build (its Shape's K): K > 0 sums in affine
    coordinates and returns the affine normal form; 0 sums one chunk a
    thread in projective coordinates and returns projective sums."""
    lib = _lib(f"bucket_mma{gs.fs.nl}" if mma else f"bucket{gs.fs.nl}")
    return lib.zk_bucket_members(gs.group)


def k2_chunk(slots, members):
    """The chunk length K2 and K2m take for a call of `slots` = W n sorted
    slots, where a lane sums `members` chunks at once (k2_members). In the
    projective order (members 0), K2_CHUNK. In the affine order,
    round(sqrt(slots / 90,000)), within 2 .. 16: the longer the chunk, the
    fewer partials the fold adds (at three times the chunk kernel's time a
    point) but the fewer lanes the chunk kernel has to fill the card; on
    the H100 this lands on the fastest T measured at 1.55M slots (a Groth16
    MSM at 2^16: 4), 3.1M (two of them: 4 to 6) and 5.5M (the EIP-7594
    request's call: 8)."""
    if members == 0:
        return K2_CHUNK
    return max(2, min(16, round(math.sqrt(slots / 90_000))))


def chunk_table(lens, chunk):
    """K2's and K2m's chunk table for the runs `lens` (any shape; in (w, b)
    order): the int64 inclusive prefix sum of ceil(len / chunk), on lens's
    device. Nothing is read back: the kernels size their scratch by
    chunk_scratch."""
    nch = torch.empty(lens.numel(), dtype=torch.int64, device=lens.device)
    torch.add(lens.reshape(-1), chunk - 1, out=nch)  # stored as int64: no launch to cast
    return torch.cumsum(nch.div_(chunk, rounding_mode="floor"), 0)


def chunk_scratch(W, B2, n, chunk):
    """The chunk partials K2's and K2m's scratch holds for W windows of B2
    runs over rows of n points: max(1, (W n + (chunk - 1) W B2) // chunk).
    That is every chunk where each window's runs total at most n points,
    as sort_by_digit's do (a window's sum of ceil(len / chunk) is then at
    most (n + (chunk - 1) B2) / chunk). Runs that overlap can have more;
    the fold kernel sums a bucket with a chunk past the scratch from its
    points (csrc/bucket_chunks.cuh), so the kernels compute the same
    function of any runs and the host never waits for the chunk count."""
    return max(1, (W * n + (chunk - 1) * W * B2) // chunk)


def _bucket_launch(gs, pts, starts, lens, mma, build=None):
    """Launch K2 (mma=False) or K2m on the CUDA tensors' device. `build`, a
    (library, chunk length) pair (the library typed by bucket_lib), stands
    in another build of the same C interface or another chunk length
    (scripts/k2_chunk_sweep.py); only the port's own launches count. With
    metrics on, the kernels count their exceptional members (a doubling, a
    cancellation, an identity) into a device counter read after the call:
    `bucket_exceptional`."""
    dev = pts.device
    fs = gs.fs
    nl = fs.nl
    L = 2 * gs.group
    name = "bucket_accumulate_mma" if mma else "bucket_accumulate"
    if pts.ndim != 4 or pts.shape[0] != L or pts.shape[1] != nl:
        raise ValueError(f"{name}: pts shape {tuple(pts.shape)}")
    _, _, Wn, n = pts.shape
    _require(pts, "pts")
    _require(starts, "starts")
    _require(lens, "lens", starts.shape)
    if starts.ndim != 2 or starts.shape[0] != Wn:
        raise ValueError(f"{name}: starts shape {tuple(starts.shape)}")
    B2 = starts.shape[1]
    out = torch.empty((3 * gs.group, nl, Wn, B2), dtype=torch.int32, device=dev)
    own = build is None
    lib, chunk = (_lib(f"bucket_mma{nl}" if mma else f"bucket{nl}"), None) if own else build
    fn = lib.zk_bucket_accumulate_mma if mma else lib.zk_bucket_accumulate
    members = lib.zk_bucket_members(gs.group)
    chunk = chunk or k2_chunk(Wn * n, members)
    cap = chunk_scratch(Wn, B2, n, chunk)
    if cap >= 1 << 31:
        raise ValueError(f"{name}: {cap} chunks of scratch, more than the kernels index")
    coff = chunk_table(lens, chunk)
    # affine partials and an identity flag a chunk, or projective ones
    planes = L * nl + 1 if members else 3 * gs.group * nl
    part = torch.empty((planes, cap), dtype=torch.int32, device=dev)
    exc = torch.zeros(1, dtype=torch.int64, device=dev) if metrics.enabled() else None
    args = [pts.data_ptr(), starts.data_ptr(), lens.data_ptr(), coff.data_ptr(),
            part.data_ptr(), out.data_ptr(), nl, gs.group, Wn, B2, n, cap, chunk,
            ctypes.addressof(fs.words("p")), fs.pinv32, ctypes.addressof(fs.words("one")),
            ctypes.addressof(fs.words("r3")), ctypes.addressof(gs.b3_words()), gs.b3_small(),
            None if exc is None else exc.data_ptr()]
    if mma:
        args.append(fs.mma_tiles(dev).data_ptr())
    if own:
        LAUNCHES[name] += 1
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, name)
    if exc is not None:
        metrics.count("bucket_exceptional", int(exc.item()))
    return out


def bucket_accumulate(gs, pts, starts, lens):
    """K2 on CUDA, its plain version in affine normal form on the CPU
    (bucket_accumulate_plain(..., affine=True); layouts as above). On CUDA
    the sums are in affine normal form where the build sums in affine
    coordinates (k2_members > 0); in the projective order (BN254's G1)
    they are projective: the same points, the same limbs as K2m's."""
    dev = _device_of(pts, starts, lens)
    if dev.type == "cpu":
        return bucket_accumulate_plain(gs, pts, starts, lens, affine=True)
    if dev.type != "cuda":
        raise ValueError(f"bucket_accumulate: unsupported device {dev}")
    return _bucket_launch(gs, pts, starts, lens, mma=False)


def bucket_accumulate_mma(gs, pts, starts, lens):
    """K2m on CUDA, its plain version on the CPU: K2's with every field
    product through K3's plain version (bucket_accumulate_plain(...,
    mode="mma", affine=True)); K2's layouts."""
    dev = _device_of(pts, starts, lens)
    if dev.type == "cpu":
        return bucket_accumulate_plain(gs, pts, starts, lens, mode="mma", affine=True)
    if dev.type != "cuda":
        raise ValueError(f"bucket_accumulate_mma: unsupported device {dev}")
    return _bucket_launch(gs, pts, starts, lens, mma=True)


# -------------------------------------------------------------------- K4 --


def bucket_reduce_plain(gs, buckets, c, S_top, V_cap):
    """Plain version of K4 on any device: the bucket sums of M MSMs
    (3|6, nl, M, W, B2), high window first (K2's outputs stacked), -> the
    M MSMs (3|6, nl, M): collapse the top window's sub-buckets, the weighted
    sum of every window by suffix scans, then Horner across windows. Every
    step runs on all M MSMs at once, so M MSMs take the launches of one."""
    from .msm import _tree_reduce

    buckets = gs.unflatten(list(buckets))
    B2 = 1 << (c - 1)
    lead = gs.leaves(buckets)[0]
    dev = lead.device
    M, Wn = lead.shape[1], lead.shape[2]
    with metrics.phase("msm.reduce.top"):
        if S_top > 1:
            # lane j*V_cap + (b-1) holds a partial sum of top bucket b: fold
            # the S_top slots, then pad with identity back to B2 lanes
            top = gs.map(
                lambda t: t[:, :, 0].reshape(t.shape[0], M, S_top, V_cap).transpose(2, 3),
                buckets,
            )
            top = _tree_reduce(gs, top, S_top)  # (nl, M, V_cap) leaves
            ident = gs.identity((M, B2 - V_cap), dev)
            padded = gs.map(lambda a, b: torch.cat([a, b], dim=-1), top, ident)
            buckets = gs.map(
                lambda t, pw: torch.cat([pw[:, :, None], t[:, :, 1:]], dim=2), buckets, padded
            )

    # sum_b (b+1) S_b = sum_{b>=0} T_b with T_b = sum_{j>=b} S_j: suffix sums
    # by a log-depth roll scan on the bucket axis, all windows at once
    with metrics.phase("msm.reduce.scan"):
        iota_b = torch.arange(B2, device=dev)
        T = buckets
        for i in range(c - 1):
            sh = 1 << i
            Q = gs.map(lambda t: torch.roll(t, -sh, dims=-1), T)
            T = gs.select(iota_b < B2 - sh, gs.add(T, Q), T)
    with metrics.phase("msm.reduce.tree"):
        wsums = _tree_reduce(gs, T, B2)  # (nl, M, W) leaves

    # Horner across windows (high window first): R <- R * 2^c + w_j
    with metrics.phase("msm.reduce.horner"):
        Rpt = gs.identity((M,), dev)
        for j in range(Wn):
            for _ in range(c):
                Rpt = gs.double(Rpt)
            Rpt = gs.add(Rpt, gs.map(lambda t: t[:, :, j], wsums))
    return torch.stack(gs.leaves(Rpt))


def bucket_reduce(gs, buckets, c, S_top, V_cap):
    """K4 on CUDA (two launches: the windows, then Horner), its plain
    version on the CPU. buckets: (3|6, nl, M, W, 2^(c - 1)) int32 bucket
    sums, high window first; S_top, V_cap: the top window's spreading
    (msm.sort_by_digit). Returns the M projective results (3|6, nl, M).

    On the card the pass runs inside the spans msm.reduce.window (the top
    fold, the suffix scan and the window tree) and msm.reduce.horner, and
    counts reduce_kernel_passes and, by the plain version's rule (one a
    level of point ops), the same point_ops as the plain version's spans."""
    dev = buckets.device
    if dev.type == "cpu":
        return bucket_reduce_plain(gs, buckets, c, S_top, V_cap)
    if dev.type != "cuda":
        raise ValueError(f"bucket_reduce: unsupported device {dev}")
    fs = gs.fs
    nl = fs.nl
    L = 3 * gs.group
    B2 = 1 << (c - 1)
    _require(buckets, "buckets")
    if buckets.ndim != 5 or buckets.shape[:2] != (L, nl) or buckets.shape[4] != B2 \
            or buckets.shape[2] < 1 or buckets.shape[3] < 1:
        raise ValueError(f"bucket_reduce: buckets shape {tuple(buckets.shape)}, expected "
                         f"({L}, {nl}, M, W, {B2})")
    if S_top > 1 and S_top * V_cap != B2:
        raise ValueError(f"bucket_reduce: {S_top} sub-buckets of {V_cap} lanes in {B2}")
    _, _, M, Wn, _ = buckets.shape
    pw = L * nl // 2  # 32-bit words a point
    win = torch.empty(M * Wn * pw * B2, dtype=torch.int32, device=dev)
    sums = torch.empty(pw * M * Wn, dtype=torch.int32, device=dev)
    out = torch.empty((L, nl, M), dtype=torch.int32, device=dev)
    consts = [ctypes.addressof(fs.words("p")), fs.pinv32, ctypes.addressof(fs.words("one")),
              ctypes.addressof(gs.b3_words()), gs.b3_small()]
    lib = _lib(f"bucket_reduce{nl}")
    LAUNCHES["bucket_reduce"] += 1
    metrics.count("reduce_kernel_passes")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with metrics.phase("msm.reduce.window"):
            metrics.count("point_ops", S_top.bit_length() - 1 + 2 * (c - 1))
            _check(lib.zk_bucket_reduce_windows(
                buckets.data_ptr(), win.data_ptr(), sums.data_ptr(), nl, gs.group, M, Wn, B2,
                S_top, V_cap, *consts, stream), "bucket_reduce")
        with metrics.phase("msm.reduce.horner"):
            metrics.count("point_ops", Wn * (c + 1))
            _check(lib.zk_bucket_reduce_horner(
                sums.data_ptr(), out.data_ptr(), nl, gs.group, M, Wn, c, *consts, stream),
                "bucket_reduce")
    return out


# -------------------------------------------------------------------- S9 --

# variant -> (kernel variant id, stack width k, inputs, outputs); the names
# and the in/out counts of scripts/debug_g2_mosaic.py. addaff1 (the script's
# add with DevFq2.mul_many patched to per-pair Karatsuba products) is
# addaff's arithmetic and kernel: the kernel spreads each level of the add's
# products over a lane group, in whatever order the script issued them.
# fq2mul1 (the script's single-pair DevFq2.mul) is fq2mul's product and
# kernel.
G2_BLOCK_VARIANTS = {
    "addaff": (0, 1, 10, 6), "addaff1": (0, 1, 10, 6),
    "fq2mul": (1, 1, 4, 2), "fq2mul1": (1, 1, 4, 2),
    "fqmul3d": (2, 3, 2, 2), "fqstack5": (2, 5, 2, 2), "fqstack6": (2, 6, 2, 2),
    "fqstack15": (2, 15, 2, 2), "fqstack18": (2, 18, 2, 2),
    "select": (3, 1, 4, 2),
}


# S9's add as levels of independent Fq operations: the complete mixed add of
# GroupSpec.add_affine (RCB15 Algorithm 8, a = 0), each Fq2 product the
# Karatsuba product of DevFq2.mul_many: a0 b0, a1 b1, (a0 + a1)(b0 + b1),
# then (t0 - t1, t2 - t0 - t1). A level is ("mul", ops) or ("lin", ops), an
# op (dst, A, B) over named Fq elements: in a "mul" level one Montgomery
# product sum(A) sum(B) of one or two terms each, in a "lin" level
# sum(A) - sum(B) of at most three terms, A first. Every op gives a
# canonical element, so the order of independent ops cannot change a limb.
# Three product levels: X1 X2, Y1 Y2, (X1 + Y1)(X2 + Y2), Y2 Z1, X2 Z1 (15
# Fq products); 3b t5 and 3b Z1 (6); the six products of the output (18).
def _kara(d, a, b):
    """The Fq2 product a b as its three Fq products d0, d1, d2."""
    return [(d + "0", (a + "a",), (b + "a",)), (d + "1", (a + "b",), (b + "b",)),
            (d + "2", (a + "a", a + "b"), (b + "a", b + "b"))]


def _recombine(d, k):
    """d = (k0 - k1, k2 - k0 - k1): an Fq2 product from its three."""
    return [(d + "a", (k + "0",), (k + "1",)), (d + "b", (k + "2",), (k + "0", k + "1"))]


def _fq2(d, plus, minus=()):
    """d = sum(plus) - sum(minus) over Fq2, part by part."""
    return [(d + c, tuple(t + c for t in plus), tuple(t + c for t in minus)) for c in "ab"]


G2_ADD_INPUTS = ("X1a", "X1b", "Y1a", "Y1b", "Z1a", "Z1b", "X2a", "X2b", "Y2a", "Y2b")
G2_ADD_OUTPUTS = ("X3a", "X3b", "Y3a", "Y3b", "Z3a", "Z3b")
G2_ADD_LEVELS = (
    ("lin", _fq2("xy1", ("X1", "Y1")) + _fq2("xy2", ("X2", "Y2"))),
    ("mul", _kara("p", "X1", "X2") + _kara("r", "Y1", "Y2") + _kara("q", "xy1", "xy2")
     + _kara("u", "Y2", "Z1") + _kara("v", "X2", "Z1")),
    ("lin", _recombine("t0", "p") + _recombine("t1", "r") + _recombine("s3", "q")
     + _recombine("y2z1", "u") + _recombine("x2z1", "v")),
    ("lin", _fq2("t5", ("x2z1", "X1")) + _fq2("t4", ("y2z1", "Y1"))  # X1 + X2 Z1, Y1 + Y2 Z1
     + _fq2("t3", ("s3",), ("t0", "t1"))  # X1 Y2 + X2 Y1
     + _fq2("t03", ("t0", "t0", "t0"))),
    ("mul", _kara("m", "b3", "t5") + _kara("n", "b3", "Z1")),
    ("lin", _recombine("y3p", "m") + _recombine("t2b", "n")),
    ("lin", _fq2("z3s", ("t1", "t2b")) + _fq2("t1m", ("t1",), ("t2b",))),
    ("mul", _kara("xl", "t3", "t1m") + _kara("xr", "t4", "y3p") + _kara("yl", "y3p", "t03")
     + _kara("yr", "t1m", "z3s") + _kara("zl", "z3s", "t4") + _kara("zr", "t03", "t3")),
    ("lin", _recombine("xl", "xl") + _recombine("xr", "xr") + _recombine("yl", "yl")
     + _recombine("yr", "yr") + _recombine("zl", "zl") + _recombine("zr", "zr")),
    ("lin", _fq2("X3", ("xl",), ("xr",)) + _fq2("Y3", ("yl", "yr")) + _fq2("Z3", ("zl", "zr"))),
)


@functools.lru_cache(maxsize=None)
def g2_add_schedule():
    """S9's add schedule with its Fq slots assigned. A dict: "levels", per
    level ("mul" or "lin", [(dst, a0, a1, a2, b0, b1, neg)]); "slots", the
    slab's length in Fq elements; "b3", the slots of 3b (real, u part);
    "zero", a slot that holds 0 and stands for every absent term; "outputs",
    the slots of G2_ADD_OUTPUTS. The inputs (G2_ADD_INPUTS) are slots 0-9.
    A mul op is dst = (a0 + a1)(b0 + b1); a lin op dst = a0 +- a1 +- a2,
    bit i of neg set where term i + 1 is subtracted. A slot is given again
    once the last level that reads its value has run."""
    fixed = list(G2_ADD_INPUTS) + ["b3a", "b3b", "0"]
    last = {name: len(G2_ADD_LEVELS) for name in G2_ADD_OUTPUTS}
    for i, (_, ops) in enumerate(G2_ADD_LEVELS):
        for _, a, b in ops:
            last.update((t, i) for t in a + b)
    slot = {name: i for i, name in enumerate(fixed)}
    z = slot["0"]
    free, n_slots, out = [], len(fixed), []
    for i, (kind, lv) in enumerate(G2_ADD_LEVELS):
        free = sorted(free + [s for name, s in slot.items()
                              if last.get(name) == i - 1 and name not in fixed[10:]])
        ops = []
        for dst, a, b in lv:
            if kind == "mul":
                assert 1 <= len(a) <= 2 and 1 <= len(b) <= 2, dst
                a0, a1 = ([slot[t] for t in a] + [z])[:2]
                b0, b1 = ([slot[t] for t in b] + [z])[:2]
                op = [a0, a1, z, b0, b1, 0]
            else:
                assert a and len(a) + len(b) <= 3, dst
                terms = ([slot[t] for t in a + b] + [z, z])[:3]
                neg = sum(1 << (j - 1) for j in range(len(a), len(a) + len(b)))
                op = terms + [z, z, neg]
            if free:
                slot[dst] = free.pop(0)
            else:
                slot[dst], n_slots = n_slots, n_slots + 1
            ops.append((slot[dst], *op))
        out.append((kind, ops))
    return {"levels": out, "slots": n_slots, "b3": (slot["b3a"], slot["b3b"]),
            "zero": z, "outputs": [slot[n] for n in G2_ADD_OUTPUTS]}


def g2_add_schedule_header():
    """The text of csrc/g2_add_schedule.cuh, g2_add_schedule() for the
    kernel (tests/test_torch_g2_block.py holds the file to it). Rewrite the
    file after a change to the schedule with
    python -c "from zksnake_tpu_torch.backend import kernels as k; k.write_g2_add_schedule()"."""
    sch = g2_add_schedule()
    ops, runs = [], []
    for kind, lv in sch["levels"]:
        runs.append(f"  LEVEL({int(kind == 'mul')}, {len(ops)}, {len(ops) + len(lv)})")
        ops += lv
    return "\n".join([
        "// S9's add (csrc/g2_block.cu) as levels of independent Fq operations over",
        "// a slab of Fq slots, from zksnake_tpu_torch/backend/kernels.py",
        "// (G2_ADD_LEVELS, g2_add_schedule): written by write_g2_add_schedule(),",
        "// not by hand.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace g2add {",
        "",
        "// mul: dst = (a0 + a1)(b0 + b1); lin: dst = a0 +- a1 +- a2, bit i of neg",
        "// set where term i + 1 is subtracted",
        "struct alignas(8) Op {",
        "  uint8_t dst, a0, a1, a2, b0, b1, neg, pad;",
        "};",
        "",
        "// the inputs X1, Y1, Z1, X2, Y2 (real part, then u part) are slots 0-9",
        f"constexpr int kSlots = {sch['slots']};",
        f"constexpr int kB3 = {sch['b3'][0]};  // 3b's real part; its u part is kB3 + 1",
        f"constexpr int kZero = {sch['zero']};",
        f"constexpr int kOps = {len(ops)};",
        "",
        "// X3, Y3, Z3 (real part, then u part)",
        "__constant__ const uint8_t kOutputs[6] = {" + ", ".join(map(str, sch["outputs"])) + "};",
        "",
        "__constant__ const Op kOp[kOps] = {",
        *[f"    {{{', '.join(map(str, op))}, 0}}," for op in ops],
        "};",
        "",
        "// LEVEL(mul, first op, end op) for each level, in order",
        "#define ZK_G2_ADD_LEVELS(LEVEL) \\",
        *[r + " \\" for r in runs[:-1]],
        runs[-1],
        "",
        "}  // namespace g2add",
        "",
    ])


def write_g2_add_schedule():
    with open(os.path.join(CSRC, "g2_add_schedule.cuh"), "w") as f:
        f.write(g2_add_schedule_header())


def g2_add_model(fs, ins, b3):
    """S9's add as its kernel runs it, on any device: g2_add_schedule()
    level by level through the plain field ops (mont_mul(plain=True),
    mod_add, mod_sub), every op of a level reading the slab as the level
    found it. ins: the ten (nl, B) planes of G2_ADD_INPUTS; b3: 3b's two
    (nl,) Montgomery limb columns. Returns the six output planes."""
    from .field import mod_add, mod_sub, mont_mul

    sch = g2_add_schedule()
    slab = [None] * sch["slots"]
    slab[:10] = ins
    for s, col in zip(sch["b3"], b3):
        slab[s] = col[:, None].expand(ins[0].shape)
    slab[sch["zero"]] = torch.zeros_like(ins[0])
    for kind, ops in sch["levels"]:
        before = list(slab)

        def get(i):
            if before[i] is None:
                raise AssertionError(f"g2_add_model: slot {i} read before it was written")
            return before[i]

        for dst, a0, a1, a2, b0, b1, neg in ops:
            if kind == "mul":
                v = mont_mul(fs, mod_add(fs, get(a0), get(a1)), mod_add(fs, get(b0), get(b1)),
                             plain=True)
            else:
                v = get(a0)
                for bit, s in enumerate((a1, a2)):
                    v = (mod_sub if neg >> bit & 1 else mod_add)(fs, v, get(s))
            slab[dst] = v
    return [slab[s] for s in sch["outputs"]]


def _g2_block_spec():
    from ..curves.params import CURVES
    from .curve_ops import get_group_spec

    return get_group_spec(CURVES["BN254"], 2, plain=True)


def _g2_block_pairwise_spec():
    """The BN254 G2 spec with DevFq2.mul_many issued one pair at a time,
    as scripts/debug_g2_mosaic.py:46-56 patches it for addaff1."""
    import copy

    from .curve_ops import DevFq2

    class PairwiseFq2(DevFq2):
        def mul_many(self, pairs):
            return [DevFq2.mul_many(self, [pr])[0] for pr in pairs]

    gs = copy.copy(_g2_block_spec())
    gs.F = PairwiseFq2(gs.fs, plain=True)
    return gs


def g2_block_plain(variant, ins):
    """Plain version of S9 on any device: the BN254 G2 probe `variant` of
    scripts/debug_g2_mosaic.py on (16, B) int32 limb planes `ins`, through
    the port's curve_ops and field (K1's plain product). Returns the list
    of output planes. addaff1 issues the add's Karatsuba products pair by
    pair, as the script's patched DevFq2.mul_many does; the same elements
    as addaff."""
    from .field import mont_mul as mul

    gs = _g2_block_spec()
    F = gs.F
    v = list(ins)
    if variant in ("addaff", "addaff1"):
        if variant == "addaff1":
            gs = _g2_block_pairwise_spec()
        P = ((v[0], v[1]), (v[2], v[3]), (v[4], v[5]))
        x3, y3, z3 = gs.add_affine(P, ((v[6], v[7]), (v[8], v[9])))
        return [x3[0], x3[1], y3[0], y3[1], z3[0], z3[1]]
    if variant == "fq2mul":
        (c0, c1), = F.mul_many([((v[0], v[1]), (v[2], v[3]))])
        return [c0, c1]
    if variant == "fq2mul1":
        return list(F.mul((v[0], v[1]), (v[2], v[3])))
    if variant == "select":
        s = F.select(v[0][0] > 0, (v[0], v[1]), (v[2], v[3]))
        return [s[0], torch.where(F.is_zero(s)[None], s[1], v[0])]
    _, k, _, _ = G2_BLOCK_VARIANTS[variant]
    a = torch.stack([v[i % 2] for i in range(k)], dim=1)
    b = torch.stack([v[(i + 1) % 2] for i in range(k)], dim=1)
    p = mul(gs.fs, a, b, plain=True)
    return [p[:, 0], p[:, k - 1]]


def g2_block(variant, ins):
    """S9 on CUDA (one launch), its plain version on the CPU. ins: the
    variant's (16, B) int32 planes (G2_BLOCK_VARIANTS)."""
    if variant not in G2_BLOCK_VARIANTS:
        raise ValueError(f"g2_block: unknown variant {variant!r}")
    vid, k, n_in, n_out = G2_BLOCK_VARIANTS[variant]
    if len(ins) != n_in:
        raise ValueError(f"g2_block {variant}: expected {n_in} inputs, got {len(ins)}")
    dev = _device_of(*ins)
    if dev.type == "cpu":
        return g2_block_plain(variant, ins)
    if dev.type != "cuda":
        raise ValueError(f"g2_block: unsupported device {dev}")
    gs = _g2_block_spec()
    fs = gs.fs
    if ins[0].ndim != 2 or ins[0].shape[0] != fs.nl:
        raise ValueError(f"g2_block: expected ({fs.nl}, B) planes, got {tuple(ins[0].shape)}")
    for j, t in enumerate(ins):
        _require(t, f"ins[{j}]", ins[0].shape)
    B = ins[0].shape[1]
    if vid == 2:
        outs = [torch.empty((fs.nl, k, B), dtype=torch.int32, device=dev)]
    else:
        outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    in_ptrs = (ctypes.c_void_p * n_in)(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    lib = _lib("g2_block")
    with torch.cuda.device(dev):
        rc = lib.zk_g2_block(
            vid, ctypes.addressof(in_ptrs), n_in, ctypes.addressof(out_ptrs), len(outs), B, k,
            ctypes.addressof(fs.words("p")), fs.pinv32, ctypes.addressof(fs.words("one")),
            ctypes.addressof(gs.b3_words()), torch.cuda.current_stream(dev).cuda_stream,
        )
    LAUNCHES["g2_block"] += 1
    _check(rc, "g2_block")
    if vid == 2:
        return [outs[0][:, 0], outs[0][:, k - 1]]
    return outs
