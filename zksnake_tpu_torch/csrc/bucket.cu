// K2: Pippenger bucket accumulation for every window of one MSM, as chunked
// runs and a fixed fold.
//
// Replaces zksnake_tpu/backend/pallas_field.py::bucket_accumulate_pallas.
// The Pallas kernel streamed a padded round-major table through R grid steps
// of one masked mixed add over all B bucket lanes (Mosaic's grid is fixed, so
// the table, its gather, the static round budget and a remainder loop existed
// to fit it). Here the sorted runs are read where they lie.
//
// Input  pts:    (L, nl, W, n) int32 planes, L = 2 (G1: X, Y) or 4 (G2: X.a,
//                X.b, Y.a, Y.b); row w holds the n points sorted by window w's
//                |digit|, with Y already negated for negative digits.
//        starts, lens: (W, B2) int32, the run of |digit| = b + 1 in row w.
//        coff:   (W B2,) int32, the inclusive prefix sum over the buckets (in
//                (w, b) order) of ceil(len / T): the chunk table.
// Scratch part:  (3 or 6, nl, cmax) chunk partial sums, cmax >= coff[-1].
// Output out:    (3 or 6, nl, W, B2) projective bucket sums X, Y, Z (leaves in
//                the same order as the input's), identity (0 : 1 : 0) for an
//                empty run.
//
// The order, fixed. Every run is cut into chunks of T consecutive
// points from its start, the last one shorter: ceil(len / T) chunks, chunk k
// holding ranks kT .. min(len, (k + 1) T) - 1. Chunks are numbered bucket by
// bucket in (w, b) order, so chunk g belongs to the first bucket with
// coff[b] > g, and its points lie in slot order.
//  1. chunk_kernel: one thread sums one chunk from the identity, in rank
//     order, with the complete mixed add (field.cuh add_affine).
//  2. fold_kernel: G neighbouring lanes a bucket of m
//     chunks. Lane j folds chunks j s .. min(m, (j + 1) s) - 1, s =
//     ceil(m / G), from left to right; then for d = 1, 2, .., G / 2 lane j
//     (j a multiple of 2d) adds lane j + d's sum if that lane had chunks
//     (shuffles), with the complete projective add (field.cuh add_proj,
//     GroupSpec.add's formula). No chunk: the identity; one chunk: its
//     partial, untouched.
// So a bucket whose run is at most T long comes out limb for limb as a
// rank-order walk of its run would give it, and every bucket is the same
// point as that walk's. kernels.bucket_accumulate_plain(..., chunk=T)
// follows these steps and equals the kernel limb for limb.
//
// What bounds it, and the design. The work is the mixed adds the data
// needs (13 CIOS products each, 39 for G2; 11 and 33 where 3b is a small
// integer, see below): operations. One thread per (window, bucket) walking
// its whole run gave 24 x 1024 threads at the prove shape, about 1.5 warps
// an SM, each waiting on scattered loads and on the longest run of its
// warp. Chunks give about W n / T threads (400k at the prove shape with
// T = 8), a warp waits on at most T adds, and the card fills to what the
// registers allow. The fold is latency-bound (one chain of adds a bucket),
// so its G lanes cut a bucket's chain from m - 1 adds to about m / G +
// log2 G; T and G are the fastest pair measured on the H100
// (scripts/k2_chunk_sweep.py). Where 3b is a small integer (G1 of both
// curves, BLS12-381's G2) its two products an add are additions (field.cuh
// SmallB3).
//
// The points' loads. A lane reads its own chunk's points: at every step a
// warp's 32 points lie about T slots apart, so one step's points are not a
// contiguous range, and a contiguous, coalesced staging of a warp's whole
// slot range would hold T points a lane, beyond shared memory at the
// occupancy the registers allow; so no such staging is built. Where it
// measured faster (every build but BN254's G1, Shape below), a lane
// prefetches its next points, limb plane by limb plane, with 4-byte
// cp.async into its column of a ring of STAGES steps in shared memory
// ([step][plane][lane], so the adds read it without bank conflicts), while
// it adds the current step's point: the same scattered loads, issued ahead
// of their use.

#include <cuda_runtime.h>

#include "field.cuh"

// One library per limb count (ZK_NL = 16: BN254, 24: BLS12-381), built in
// parallel: the fully unrolled Fq2 variants dominate the build time.
#ifndef ZK_NL
#define ZK_NL 16
#endif

namespace {

// The chunk length T and the fold's lanes a bucket G (a power of two up to
// 32); backend/kernels.py K2_CHUNK and K2_FOLD_LANES hold the same values.
constexpr int T = 8, G = 4;
static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G divides a warp");

// Threads a block and steps of the prefetch ring (0: no ring), per group.
// BN254's G1 reads its points straight from device memory: with the ring
// its chunk kernel took 4% longer (121 against 108 registers, 4 blocks an
// SM either way), while the ring cut the other three builds' by 8-16%
// (scripts/k2_chunk_sweep.py). A ring of 3 steps is 48 KB a block for
// BN254's G2 (4 blocks an SM at 255 registers) and 72 KB for BLS12-381's
// G1 (2 blocks at 180); its G2 takes 2 steps (48 KB) to keep 4 blocks.
template <class F>
struct Shape;
template <int NW>
struct Shape<zk::Fp<NW>> {
  static constexpr int BT = 128, STAGES = NW == 8 ? 0 : 3;
};
template <int NW>
struct Shape<zk::Fp2<NW>> {
  static constexpr int BT = 64, STAGES = NW == 8 ? 3 : 2;
};

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <class F, int NW, class B>
__global__ void __launch_bounds__(Shape<F>::BT)
chunk_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ starts,
             const int32_t* __restrict__ lens, const int32_t* __restrict__ coff,
             int32_t* __restrict__ part, int W, int B2, int64_t n, int64_t cmax,
             zk::FieldParams<NW> P, B b3) {
  constexpr int BT = Shape<F>::BT, S = Shape<F>::STAGES;
  constexpr int PL = (int)(sizeof(F) / sizeof(zk::Fp<NW>)) * 4 * NW;  // planes of X and Y
  extern __shared__ int32_t ring[];  // [S][PL][BT]
  const int nb = W * B2;
  const int64_t g = (int64_t)blockIdx.x * BT + threadIdx.x;
  if (g >= coff[nb - 1]) return;
  int lo = 0, hi = nb - 1;  // the first bucket with coff[b] > g
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (coff[mid] > g) hi = mid;
    else lo = mid + 1;
  }
  const int len = lens[lo];
  const int64_t rank = (g - (coff[lo] - (len + T - 1) / T)) * T;
  const int m = min(T, len - (int)rank);
  // point k of the chunk, plane q: pts[(q W + w) n + starts + rank + k]
  const int32_t* src = pts + (int64_t)(lo / B2) * n + starts[lo] + rank;
  const int64_t stride = (int64_t)W * n;
  F X, Y, Z;
  zk::set_zero<NW>(X);
  zk::set_one<NW>(Y, P);
  zk::set_zero<NW>(Z);
  if constexpr (S == 0) {
    for (int k = 0; k < m; ++k) {
      const F qx = zk::load_leaf<NW>(src, 0, stride, k, (F*)nullptr);
      const F qy = zk::load_leaf<NW>(src, 1, stride, k, (F*)nullptr);
      zk::add_affine<F, NW>(X, Y, Z, qx, qy, b3, P);
    }
  } else {
    int32_t* col = ring + threadIdx.x;
    auto issue = [&](int k) {
      int32_t* dst = col + (k % S) * PL * BT;
#pragma unroll 8
      for (int q = 0; q < PL; ++q) cp_async4(dst + q * BT, src + q * stride + k);
    };
#pragma unroll
    for (int k = 0; k < S - 1; ++k) {
      if (k < m) issue(k);
      cp_async_commit();
    }
    for (int k = 0; k < m; ++k) {
      if (k + S - 1 < m) issue(k + S - 1);
      cp_async_commit();
      cp_async_wait<S - 1>();  // step k's copies have landed
      const int32_t* cur = ring + (k % S) * PL * BT;
      const F qx = zk::load_leaf<NW>(cur, 0, BT, threadIdx.x, (F*)nullptr);
      const F qy = zk::load_leaf<NW>(cur, 1, BT, threadIdx.x, (F*)nullptr);
      zk::add_affine<F, NW>(X, Y, Z, qx, qy, b3, P);
    }
  }
  zk::store_leaf<NW>(part, 0, cmax, g, X);
  zk::store_leaf<NW>(part, 1, cmax, g, Y);
  zk::store_leaf<NW>(part, 2, cmax, g, Z);
}

template <int NW>
__device__ __forceinline__ void shfl_down(zk::Fp<NW>& v, int d) {
#pragma unroll
  for (int j = 0; j < NW; ++j) v.c[j] = __shfl_down_sync(0xffffffffu, v.c[j], d);
}
template <int NW>
__device__ __forceinline__ void shfl_down(zk::Fp2<NW>& v, int d) {
  shfl_down<NW>(v.a, d);
  shfl_down<NW>(v.b, d);
}

// G neighbouring lanes a bucket (see the header comment).
template <class F, int NW, class B>
__global__ void __launch_bounds__(Shape<F>::BT)
fold_kernel(const int32_t* __restrict__ part, const int32_t* __restrict__ lens,
            const int32_t* __restrict__ coff, int32_t* __restrict__ out, int nb,
            int64_t cmax, zk::FieldParams<NW> P, B b3) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = t / G;
  const int j = (int)(t % G);
  // every lane takes part in the shuffles; lanes past the last bucket hold
  // no chunks
  const int nch = b < nb ? (lens[b] + T - 1) / T : 0;
  const int s = (nch + G - 1) / G;  // lane j folds chunks [j s, min(nch, (j + 1) s))
  const int lo = j * s, hi = min(nch, lo + s);
  const int64_t first = b < nb ? coff[b] - nch : 0;
  F X, Y, Z;
  zk::set_zero<NW>(X);
  zk::set_one<NW>(Y, P);
  zk::set_zero<NW>(Z);
  if (lo < hi) {
    X = zk::load_leaf<NW>(part, 0, cmax, first + lo, (F*)nullptr);
    Y = zk::load_leaf<NW>(part, 1, cmax, first + lo, (F*)nullptr);
    Z = zk::load_leaf<NW>(part, 2, cmax, first + lo, (F*)nullptr);
    for (int k = lo + 1; k < hi; ++k) {
      const F x2 = zk::load_leaf<NW>(part, 0, cmax, first + k, (F*)nullptr);
      const F y2 = zk::load_leaf<NW>(part, 1, cmax, first + k, (F*)nullptr);
      const F z2 = zk::load_leaf<NW>(part, 2, cmax, first + k, (F*)nullptr);
      zk::add_proj<F, NW>(X, Y, Z, x2, y2, z2, b3, P);
    }
  }
#pragma unroll
  for (int d = 1; d < G; d *= 2) {
    F x2 = X, y2 = Y, z2 = Z;
    shfl_down<NW>(x2, d);
    shfl_down<NW>(y2, d);
    shfl_down<NW>(z2, d);
    if (j % (2 * d) == 0 && (j + d) * s < nch) zk::add_proj<F, NW>(X, Y, Z, x2, y2, z2, b3, P);
  }
  if (j == 0 && b < nb) {
    zk::store_leaf<NW>(out, 0, nb, b, X);
    zk::store_leaf<NW>(out, 1, nb, b, Y);
    zk::store_leaf<NW>(out, 2, nb, b, Z);
  }
}

template <class F, int NW, class B>
int launch_group(const int32_t* pts, const int32_t* starts, const int32_t* lens,
                 const int32_t* coff, int32_t* part, int32_t* out, int W, int B2,
                 int64_t n, int64_t cmax, const zk::FieldParams<NW>& P, const B& b3,
                 cudaStream_t stream) {
  constexpr int BT = Shape<F>::BT, S = Shape<F>::STAGES;
  constexpr int PL = (int)(sizeof(F) / sizeof(zk::Fp<NW>)) * 4 * NW;
  constexpr int smem = S * PL * BT * 4;
  static bool attr = false;  // one attribute call per process and kernel
  if (!attr && smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_kernel<F, NW, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int nb = W * B2;
  const unsigned cblocks = (unsigned)((cmax + BT - 1) / BT);
  if (cblocks > 0)
    chunk_kernel<F, NW, B><<<cblocks, BT, smem, stream>>>(pts, starts, lens, coff, part, W,
                                                          B2, n, cmax, P, b3);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned fblocks = (unsigned)(((int64_t)nb * G + BT - 1) / BT);
  fold_kernel<F, NW, B><<<fblocks, BT, 0, stream>>>(part, lens, coff, out, nb, cmax, P, b3);
  return (int)cudaGetLastError();
}

// 3b of each group as a small integer where it is one (field.cuh SmallB3),
// else 0 (a product with 3b): BN254 3b = 9, and 3b' = 3 / (9 + u) is none;
// BLS12-381 3b = 12 and 3b' = 12 + 12 u.
#if ZK_NL == 24
constexpr int B3_G1 = 12, B3_G2 = 12;
#else
constexpr int B3_G1 = 9, B3_G2 = 0;
#endif

template <int NW>
int launch(const void* pts, const void* starts, const void* lens, const void* coff,
           void* part, void* out, int group, int W, int B2, int64_t n, int64_t cmax,
           const uint32_t* p, uint32_t pinv, const uint32_t* one, const uint32_t* b3, int b3k,
           cudaStream_t stream) {
  const zk::FieldParams<NW> P = zk::field_params<NW>(p, pinv, one);
  if ((int64_t)W * B2 == 0) return (int)cudaGetLastError();
  const int32_t *ip = (const int32_t*)pts, *is = (const int32_t*)starts,
                *il = (const int32_t*)lens, *ic = (const int32_t*)coff;
  int32_t *pp = (int32_t*)part, *po = (int32_t*)out;
  if (group == 1 && b3k == B3_G1) {
    return launch_group<zk::Fp<NW>, NW>(ip, is, il, ic, pp, po, W, B2, n, cmax, P,
                                        zk::SmallB3<B3_G1>{}, stream);
  }
  if (group == 2 && b3k == B3_G2) {
    if constexpr (B3_G2 > 0) {
      return launch_group<zk::Fp2<NW>, NW>(ip, is, il, ic, pp, po, W, B2, n, cmax, P,
                                           zk::SmallB3<B3_G2>{}, stream);
    } else {
      zk::Fp2<NW> c;
      zk::load_b3<NW>(c, b3);
      return launch_group<zk::Fp2<NW>, NW>(ip, is, il, ic, pp, po, W, B2, n, cmax, P, c,
                                           stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// See the header comment for the layouts. p, one: nl/2 words; b3: nl/2 words
// (G1) or nl words (G2: real part then u part), all Montgomery form except p;
// b3k: 3b as a small integer (GroupSpec.b3_small), which must be this
// build's. W B2 < 2^31 and cmax < 2^31.
int zk_bucket_accumulate(const void* pts, const void* starts, const void* lens,
                         const void* coff, void* part, void* out, int nl, int group, int W,
                         int B2, long long n, long long cmax, const uint32_t* p, uint32_t pinv, const uint32_t* one,
                         const uint32_t* b3, int b3k, void* stream) {
  if (nl != ZK_NL || cmax < 0 || cmax >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return launch<ZK_NL / 2>(pts, starts, lens, coff, part, out, group, W, B2, n, cmax, p, pinv,
                           one, b3, b3k, (cudaStream_t)stream);
}

}  // extern "C"
