// The chunk and fold kernels of K2 (bucket.cu) and K2m (bucket_mma.cu), on
// any field product: K2 instantiates them with the CIOS product
// (CiosProduct below), K2m with its tensor-core product. bucket.cu's header
// comment describes what they compute and in which order. The output is
// every bucket sum in affine normal form, which is unique, so K2 and K2m
// are equal limb for limb to each other and to the plain version; in the
// projective order (Sh::K = 0) both sum in one order with canonical
// products, so they are equal limb for limb there too.
//
// A product is a policy class Prod<NW>:
//   Prod<NW>::kWarp          true where a product is collective over the warp
//                            (every lane calls it at the same point);
//   Prod<NW>::smem_bytes(bt) the shared memory a block of bt threads needs;
//   Prod<NW>::make(P, smem, aux) -> mul, the functor mul(a, b) -> Fp<NW>,
//                            called by every thread of the block first (it
//                            may stage aux into smem and __syncthreads).
// Where the product is collective no lane leaves early: every lane runs the
// warp's longest trip count (__reduce_max_sync), computes past its end on a
// point it may read (its first one; a lane with none reads slot 0) and on
// members with nothing to add, and keeps and stores nothing there.
//
// A shape class Sh gives the block's threads (BT), the chunks a lane sums
// at once (K) and the blocks an SM should hold (MINB, __launch_bounds__'s
// second bound: it caps the registers), per build. K = 0 picks the
// projective order instead (bucket.cu's header comment): one chunk a
// thread, summed with the complete mixed add into projective partials,
// folded with the complete projective add, the sums left projective.
//
// The scratch. part holds the affine partials of chunks 0 .. cap - 1 and
// an identity flag a chunk (K = 0: projective partials), cap from the
// rows' length and the chunk length (kernels.chunk_scratch): every chunk where each window's runs total at
// most its n points, as sort_by_digit's do. Runs that overlap can have more
// chunks than that; the fold sums a bucket with a chunk past the scratch
// from its points, so the output is the same function of any runs and the
// host never waits for the chunk count.
#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace zk {
namespace bucket {

// The fold's lanes a bucket G (a power of two up to 32).
constexpr int G = 4;
static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G divides a warp");

// K2's product: CIOS in each thread, no shared memory.
template <int NW>
struct CiosProduct {
  static constexpr bool kWarp = false;
  __host__ __device__ static constexpr int smem_bytes(int) { return 0; }
  __device__ static CiosMul<NW> make(const FieldParams<NW>& P, unsigned char*, const void*) {
    return CiosMul<NW>{P};
  }
};

// planes of X and Y of one point of F
template <class F, int NW>
__host__ __device__ constexpr int point_planes() {
  return (int)(sizeof(F) / sizeof(Fp<NW>)) * 4 * NW;
}

template <class F, int NW>
__device__ __forceinline__ F times3(const F& x, const FieldParams<NW>& P) {
  return fadd(fadd(x, x, P), x, P);
}

// Sum the m <= T points of a chunk from the identity into X, Y, Z (the
// projective order), reading device memory: point k, plane q at src[q
// stride + k]. Where the product is collective every lane runs its warp's
// longest chunk, and past its own end adds its chunk's first point again
// (a lane with no chunk passes a src it may read) and keeps nothing.
template <class F, int NW, bool WARP, class B, class Mul>
__device__ __forceinline__ void sum_chunk(const int32_t* src, int64_t stride, int m, F& X,
                                          F& Y, F& Z, const B& b3, const FieldParams<NW>& P,
                                          const Mul& mul) {
  set_zero<NW>(X);
  set_one<NW>(Y, P);
  set_zero<NW>(Z);
  const int steps = WARP ? __reduce_max_sync(0xffffffffu, m) : m;
  for (int k = 0; k < steps; ++k) {
    const int kk = k < m ? k : 0;
    const F qx = load_leaf<NW>(src, 0, stride, kk, (F*)nullptr);
    const F qy = load_leaf<NW>(src, 1, stride, kk, (F*)nullptr);
    if constexpr (WARP) {
      F x = X, y = Y, z = Z;
      add_affine_with<F, NW>(x, y, z, qx, qy, b3, P, mul);
      if (k < m) {
        X = x;
        Y = y;
        Z = z;
      }
    } else {
      add_affine_with<F, NW>(X, Y, Z, qx, qy, b3, P, mul);
    }
  }
}

// Chunk g (< coff[-1]): its length (at most T) and, in src, its first
// point's plane 0 in pts (plane q lies q W n further on).
__device__ __forceinline__ int chunk_at(int64_t g, const int32_t* pts, const int32_t* starts,
                                        const int32_t* lens, const int64_t* coff, int nb,
                                        int B2, int64_t n, int T, const int32_t*& src) {
  int lo = 0, hi = nb - 1;  // the first bucket with coff[b] > g
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (coff[mid] > g) hi = mid;
    else lo = mid + 1;
  }
  const int64_t rank = (g - (coff[lo] - (lens[lo] + T - 1) / T)) * T;
  src = pts + (int64_t)(lo / B2) * n + starts[lo] + rank;
  return (int)min((int64_t)T, lens[lo] - rank);
}

// The projective order (Sh::K = 0): thread g of the grid sums chunk g <
// live_end from the identity, its projective partial into part[g].
template <class F, int NW, bool WARP, class B, class M>
__device__ __forceinline__ void chunk_projective(
    const int32_t* pts, const int32_t* starts, const int32_t* lens, const int64_t* coff,
    int32_t* part, int W, int B2, int64_t n, int64_t cap, int T, int64_t live_end,
    const FieldParams<NW>& P, const B& b3, const M& mul) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < live_end;
  if (!WARP && !live) return;
  const int32_t* src = pts;  // a lane past the last chunk reads slot 0 of row 0
  const int m = live ? chunk_at(g, pts, starts, lens, coff, W * B2, B2, n, T, src) : 0;
  F X, Y, Z;
  sum_chunk<F, NW, WARP>(src, (int64_t)W * n, m, X, Y, Z, b3, P, mul);
  if (live) {
    store_leaf<NW>(part, 0, cap, g, X);
    store_leaf<NW>(part, 1, cap, g, Y);
    store_leaf<NW>(part, 2, cap, g, Z);
  }
}

// The affine order (Sh::K = K > 0): every lane sums K chunks at once, one
// step a point (bucket.cu's header comment): chunk g = (blockIdx.x K + k)
// BT + threadIdx.x, for g < live_end, its partial and identity flag into
// part[g]. Counts the members that met a doubling, a cancellation or an
// identity into *exc, where exc is not null.
template <class F, int NW, int BT, int K, bool WARP, class M>
__device__ __forceinline__ void chunk_affine(const int32_t* pts, const int32_t* starts,
                                             const int32_t* lens, const int64_t* coff,
                                             int32_t* part, int W, int B2, int64_t n,
                                             int64_t cap, int T, int64_t live_end,
                                             const FieldParams<NW>& P, const InvParams<NW>& I,
                                             unsigned long long* exc, const M& mul) {
  constexpr int PL = point_planes<F, NW>();
  static_assert(K <= 32, "two bits a member in one 64-bit word");
  const int64_t base = (int64_t)blockIdx.x * BT * K + threadIdx.x;
  const int64_t stride = (int64_t)W * n;
  F one, zero;
  set_one<NW>(one, P);
  set_zero<NW>(zero);

  // each member's points (point k, plane q: src[q stride + k]) and count;
  // its running sum X, Y (affine; bit k of inf: the identity); the step's
  // point QX, QY and the product of the denominators before it, PRE
  const int32_t* src[K];
  int len[K];
  F X[K], Y[K], QX[K], QY[K], PRE[K];
  uint64_t inf = 0;
  int most = 0;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const int64_t g = base + (int64_t)k * BT;
    src[k] = pts;  // a member with no chunk reads slot 0 of row 0
    len[k] = g < live_end ? chunk_at(g, pts, starts, lens, coff, W * B2, B2, n, T, src[k]) : 0;
    most = max(most, len[k]);
    X[k] = load_leaf<NW>(src[k], 0, stride, 0, (F*)nullptr);
    Y[k] = load_leaf<NW>(src[k], 1, stride, 0, (F*)nullptr);
  }
  const int steps = WARP ? __reduce_max_sync(0xffffffffu, most) : most;
  unsigned long long odd = 0;

  for (int s = 1; s < steps; ++s) {
    // forward: each member's denominator (1 where it adds nothing) and
    // the running product of those before it
    F acc = one;
    uint64_t kind = 0;  // two bits a member: 0 nothing to finish, 1 add, 2 double
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const bool on = s < len[k];
      if constexpr (!WARP) {
        if (!on) continue;
      }
      const int32_t* at = src[k] + (on ? s : 0);
      const F qx = load_leaf<NW>(at, 0, stride, 0, (F*)nullptr);
      const F qy = load_leaf<NW>(at, 1, stride, 0, (F*)nullptr);
      F d = one;
      uint64_t c = 0;
      if (on) {
        if ((inf >> k) & 1) {  // the identity takes the point
          X[k] = qx;
          Y[k] = qy;
          inf &= ~(1ull << k);
          ++odd;
        } else {
          const F x1 = X[k];
          if (!feq(x1, qx)) {
            d = fsub(qx, x1, P);
            c = 1;
          } else {
            const F y1 = Y[k];
            ++odd;
            if (feq(fadd(y1, qy, P), zero)) {
              inf |= 1ull << k;  // P + (-P), and 2P where y = 0
            } else {
              d = fadd(y1, y1, P);
              c = 2;
            }
          }
        }
      }
      if (!WARP && c == 0) continue;
      QX[k] = qx;
      QY[k] = qy;
      PRE[k] = acc;
      acc = fmul_with(acc, d, P, mul);
      kind |= c << (2 * k);
    }
    // one inversion for the lane's members, then backward: each member's
    // inverse and its affine add
    F inv = finv_with<WARP>(acc, P, I, mul);
#pragma unroll 1
    for (int k = K - 1; k >= 0; --k) {
      const uint32_t c = (uint32_t)(kind >> (2 * k)) & 3;
      if constexpr (!WARP) {
        if (c == 0) continue;
      }
      const F x1 = X[k], y1 = Y[k];
      F x2 = QX[k];
      const F y2 = QY[k];
      const F d = c == 2 ? fadd(y1, y1, P) : c == 1 ? fsub(x2, x1, P) : one;
      const F dinv = fmul_with(inv, PRE[k], P, mul);
      inv = fmul_with(inv, d, P, mul);
      F num = fsub(y2, y1, P);
      bool dbl = c == 2;
      if constexpr (WARP) dbl = __any_sync(0xffffffffu, dbl);
      if (dbl) {  // rare: lambda = 3 x^2 / 2y
        const F sq = times3(fmul_with(x1, x1, P, mul), P);
        if (c == 2) {
          num = sq;
          x2 = x1;
        }
      }
      const F lam = fmul_with(num, dinv, P, mul);
      const F x3 = fsub(fsub(fmul_with(lam, lam, P, mul), x1, P), x2, P);
      const F y3 = fsub(fmul_with(lam, fsub(x1, x3, P), P, mul), y1, P);
      if (c != 0) {
        X[k] = x3;
        Y[k] = y3;
      }
    }
  }
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const int64_t g = base + (int64_t)k * BT;
    if (g < live_end) {
      store_leaf<NW>(part, 0, cap, g, X[k]);
      store_leaf<NW>(part, 1, cap, g, Y[k]);
      part[PL * cap + g] = (int32_t)((inf >> k) & 1);
    }
  }
  if (exc != nullptr && odd != 0) atomicAdd(exc, odd);
}

// The chunk kernel: the order Sh::K picks (chunk_projective, chunk_affine)
// over the chunks g < min(coff[-1], cap).
template <class F, int NW, class B, class Prod, class Sh>
__global__ void __launch_bounds__(Sh::BT, Sh::MINB)
chunk_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ starts,
             const int32_t* __restrict__ lens, const int64_t* __restrict__ coff,
             int32_t* __restrict__ part, int W, int B2, int64_t n, int64_t cap, int T,
             FieldParams<NW> P, InvParams<NW> I, B b3, unsigned long long* exc,
             const void* __restrict__ aux) {
  constexpr int BT = Sh::BT, K = Sh::K;
  constexpr bool WARP = Prod::kWarp;
  const int nb = W * B2;
  const int64_t live_end = coff[nb - 1] < cap ? coff[nb - 1] : cap;
  if ((int64_t)blockIdx.x * BT * (K > 0 ? K : 1) >= live_end)
    return;  // the whole block: before make's barrier
  extern __shared__ __align__(128) int32_t zk_smem[];  // the product's tiles
  const auto mul = Prod::make(P, reinterpret_cast<unsigned char*>(zk_smem), aux);
  if constexpr (K == 0) {
    chunk_projective<F, NW, WARP>(pts, starts, lens, coff, part, W, B2, n, cap, T, live_end, P,
                                  b3, mul);
  } else {
    chunk_affine<F, NW, BT, K, WARP>(pts, starts, lens, coff, part, W, B2, n, cap, T, live_end,
                                     P, I, exc, mul);
  }
}

template <int NW>
__device__ __forceinline__ void shfl_down(Fp<NW>& v, int d) {
#pragma unroll
  for (int j = 0; j < NW; ++j) v.c[j] = __shfl_down_sync(0xffffffffu, v.c[j], d);
}
template <int NW>
__device__ __forceinline__ void shfl_down(Fp2<NW>& v, int d) {
  shfl_down<NW>(v.a, d);
  shfl_down<NW>(v.b, d);
}

// The fold (NORMAL = false): G neighbouring lanes a bucket (see bucket.cu's
// header comment), adding affine inputs with the complete mixed add: the
// chunk partials of a bucket whose chunks all lie in the scratch (skipping
// those flagged the identity), or, for a bucket with a chunk past it, which
// only overlapping runs have, the points of its run; projective sums into
// out. In the projective order (Sh::K = 0) a lane starts from its first
// input and adds the rest with the complete projective add, a point as
// (x, y, 1). Then (NORMAL = true, affine order only) every sum to affine
// normal form, KN buckets a lane sharing one inversion.
constexpr int KN = 4;

template <class F, int NW, bool WARP, class M>
__device__ __forceinline__ void normal_form(int32_t* __restrict__ out, int nb,
                                            const FieldParams<NW>& P, const InvParams<NW>& I,
                                            const M& mul) {
  const int64_t base = (int64_t)blockIdx.x * blockDim.x * KN + threadIdx.x;
  F one, zero;
  set_one<NW>(one, P);
  set_zero<NW>(zero);
  F Z[KN], PRE[KN];
  uint32_t inf = 0;
  F acc = one;
#pragma unroll 1
  for (int k = 0; k < KN; ++k) {
    const int64_t b = base + (int64_t)k * blockDim.x;
    F z = b < nb ? load_leaf<NW>(out, 2, nb, b, (F*)nullptr) : one;
    if (feq(z, zero)) {
      z = one;
      inf |= 1u << k;
    }
    Z[k] = z;
    PRE[k] = acc;
    acc = fmul_with(acc, z, P, mul);
  }
  F inv = finv_with<WARP>(acc, P, I, mul);
#pragma unroll 1
  for (int k = KN - 1; k >= 0; --k) {
    const int64_t b = base + (int64_t)k * blockDim.x;
    const int64_t at = b < nb ? b : 0;
    const F zi = fmul_with(inv, PRE[k], P, mul);
    inv = fmul_with(inv, Z[k], P, mul);
    F x = fmul_with(load_leaf<NW>(out, 0, nb, at, (F*)nullptr), zi, P, mul);
    F y = fmul_with(load_leaf<NW>(out, 1, nb, at, (F*)nullptr), zi, P, mul);
    if (b < nb) {
      const bool at_inf = (inf >> k) & 1;
      store_leaf<NW>(out, 0, nb, b, at_inf ? zero : x);
      store_leaf<NW>(out, 1, nb, b, at_inf ? one : y);
      store_leaf<NW>(out, 2, nb, b, at_inf ? zero : one);
    }
  }
}

template <class F, int NW, class B, class Prod, class Sh, bool NORMAL>
__global__ void __launch_bounds__(Sh::BT, Sh::MINB)
fold_kernel(const int32_t* __restrict__ part, const int32_t* __restrict__ pts,
            const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
            const int64_t* __restrict__ coff, int32_t* __restrict__ out, int W, int B2,
            int64_t n, int64_t cap, int T, FieldParams<NW> P, InvParams<NW> I, B b3,
            unsigned long long* exc, const void* __restrict__ aux) {
  constexpr int PL = point_planes<F, NW>();
  constexpr bool WARP = Prod::kWarp, PROJ = Sh::K == 0;
  const int nb = W * B2;
  extern __shared__ __align__(128) int32_t zk_smem[];  // the product's tiles
  const auto mul = Prod::make(P, reinterpret_cast<unsigned char*>(zk_smem), aux);
  if constexpr (NORMAL) {
    normal_form<F, NW, WARP>(out, nb, P, I, mul);
    return;
  }
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = t / G;
  const int j = (int)(t % G);
  // every lane takes part in the shuffles; lanes past the last bucket hold
  // nothing
  const bool live = b < nb;
  const bool cold = live && coff[b] > cap;
  const int len = live ? lens[b] : 0;
  const int nch = (len + T - 1) / T;
  const int s = (nch + G - 1) / G;  // lane j folds chunks [j s, min(nch, (j + 1) s))
  const int lo = j * s, hi = min(nch, lo + s);
  // its inputs: the chunk partials lo .. hi - 1 (affine with their flags,
  // or projective), or the points of ranks lo T .. min(len, hi T) - 1
  const int64_t stride = cold ? (int64_t)W * n : cap;
  const int32_t* src = part;
  int first = 0, count = 0;
  if (lo < hi) {
    if (cold) {
      src = pts + (b / B2) * n + starts[b];
      first = lo * T;
      count = min(len, hi * T) - first;
    } else {
      first = (int)(coff[b] - nch) + lo;
      count = hi - lo;
    }
  }
  F X, Y, Z;
  set_zero<NW>(X);
  set_one<NW>(Y, P);
  set_zero<NW>(Z);
  unsigned long long odd = 0;
  const int steps = WARP ? __reduce_max_sync(0xffffffffu, count) : count;
  for (int k = 0; k < steps; ++k) {
    const int64_t idx = first + (k < count ? k : 0);
    const F x2 = load_leaf<NW>(src, 0, stride, idx, (F*)nullptr);
    const F y2 = load_leaf<NW>(src, 1, stride, idx, (F*)nullptr);
    bool take = k < count;
    if constexpr (PROJ) {
      F z2;
      if (cold) set_one<NW>(z2, P);
      else z2 = load_leaf<NW>(src, 2, stride, idx, (F*)nullptr);
      if (k == 0) {  // the first input as it is
        if (take) {
          X = x2;
          Y = y2;
          Z = z2;
        }
      } else if constexpr (WARP) {
        F x = X, y = Y, z = Z;
        add_proj_with<F, NW>(x, y, z, x2, y2, z2, b3, P, mul);
        if (take) {
          X = x;
          Y = y;
          Z = z;
        }
      } else if (take) {
        add_proj_with<F, NW>(X, Y, Z, x2, y2, z2, b3, P, mul);
      }
    } else {
      if (take && !cold && part[PL * cap + idx] != 0) {  // a chunk that summed to the identity
        take = false;
        ++odd;
      }
      if constexpr (WARP) {
        F x = X, y = Y, z = Z;
        add_affine_with<F, NW>(x, y, z, x2, y2, b3, P, mul);
        if (take) {
          X = x;
          Y = y;
          Z = z;
        }
      } else if (take) {
        add_affine_with<F, NW>(X, Y, Z, x2, y2, b3, P, mul);
      }
    }
  }
#pragma unroll
  for (int d = 1; d < G; d *= 2) {
    F x2 = X, y2 = Y, z2 = Z;
    shfl_down<NW>(x2, d);
    shfl_down<NW>(y2, d);
    shfl_down<NW>(z2, d);
    const bool take = j % (2 * d) == 0 && (j + d) * s < nch;
    if constexpr (WARP) {
      F x = X, y = Y, z = Z;
      add_proj_with<F, NW>(x, y, z, x2, y2, z2, b3, P, mul);
      if (take) {
        X = x;
        Y = y;
        Z = z;
      }
    } else if (take) {
      add_proj_with<F, NW>(X, Y, Z, x2, y2, z2, b3, P, mul);
    }
  }
  if (j == 0 && live) {
    store_leaf<NW>(out, 0, nb, b, X);
    store_leaf<NW>(out, 1, nb, b, Y);
    store_leaf<NW>(out, 2, nb, b, Z);
  }
  if (exc != nullptr && odd != 0) atomicAdd(exc, odd);
}

// One group's launches: the chunk kernel over the scratch's cap chunks,
// the fold over the buckets' G lanes, then, in the affine order, the sums
// to normal form.
template <class F, int NW, class B, template <int> class Prod, class Sh>
int launch_group(const int32_t* pts, const int32_t* starts, const int32_t* lens,
                 const int64_t* coff, int32_t* part, int32_t* out, int W, int B2, int64_t n,
                 int64_t cap, int T, const FieldParams<NW>& P, const InvParams<NW>& I,
                 const B& b3, unsigned long long* exc, const void* aux, cudaStream_t stream) {
  constexpr int BT = Sh::BT, K = Sh::K > 0 ? Sh::K : 1;
  constexpr int smem = Prod<NW>::smem_bytes(BT);
  auto chunk = chunk_kernel<F, NW, B, Prod<NW>, Sh>;
  auto fold = fold_kernel<F, NW, B, Prod<NW>, Sh, false>;
  auto normal = fold_kernel<F, NW, B, Prod<NW>, Sh, true>;
  static bool attr = false;  // one attribute call per process and kernel
  if (!attr && smem > 0) {
    for (const void* k : {(const void*)chunk, (const void*)fold, (const void*)normal}) {
      const cudaError_t e =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  attr = true;
  const int64_t nb = (int64_t)W * B2;
  const unsigned cblocks = (unsigned)((cap + (int64_t)BT * K - 1) / ((int64_t)BT * K));
  chunk<<<cblocks, BT, smem, stream>>>(pts, starts, lens, coff, part, W, B2, n, cap, T, P, I,
                                       b3, exc, aux);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned fblocks = (unsigned)((nb * G + BT - 1) / BT);
  fold<<<fblocks, BT, smem, stream>>>(part, pts, starts, lens, coff, out, W, B2, n, cap, T, P, I,
                                      b3, exc, aux);
  e = cudaGetLastError();
  if (e != cudaSuccess || Sh::K == 0) return (int)e;
  const unsigned nblocks = (unsigned)((nb + (int64_t)BT * KN - 1) / ((int64_t)BT * KN));
  normal<<<nblocks, BT, smem, stream>>>(part, pts, starts, lens, coff, out, W, B2, n, cap, T, P,
                                        I, b3, exc, aux);
  return (int)cudaGetLastError();
}

// The chunks a lane sums at once in group's build (Sh's K; 0: the
// projective order), which the wrapper reads to size the scratch, pick the
// chunk length and know the output's form.
template <int NW, template <class> class Sh>
int members(int group) {
  return group == 1 ? Sh<Fp<NW>>::K : group == 2 ? Sh<Fp2<NW>>::K : -1;
}

// K2's and K2m's C interface behind the entry points: p, one, r3 (R^3 mod
// p): NW words; b3: NW words (G1) or 2 NW (G2: real part then u part), all
// Montgomery form but p and r3; b3k: 3b as a small integer
// (GroupSpec.b3_small), which must be this build's; T: the chunk length;
// exc: the exceptional members' counter (uint64; null: none counted); aux:
// the product's operand (Prod::make); coff: int64; cap: the chunks part
// holds (at least 1).
template <int NW, template <int> class Prod, template <class> class Sh>
int launch(const void* pts, const void* starts, const void* lens, const void* coff, void* part,
           void* out, int group, int W, int B2, int64_t n, int64_t cap, int T,
           const uint32_t* p, uint32_t pinv, const uint32_t* one, const uint32_t* r3,
           const uint32_t* b3, int b3k, void* exc, const void* aux, cudaStream_t stream) {
  constexpr int B3_G1 = SmallB3Of<NW>::G1, B3_G2 = SmallB3Of<NW>::G2;
  if (T < 1) return (int)cudaErrorInvalidValue;
  const FieldParams<NW> P = field_params<NW>(p, pinv, one);
  const InvParams<NW> I = inv_params<NW>(p, pinv, r3);
  if ((int64_t)W * B2 == 0) return (int)cudaGetLastError();
  const int32_t *ip = (const int32_t*)pts, *is = (const int32_t*)starts,
                *il = (const int32_t*)lens;
  const int64_t* ic = (const int64_t*)coff;
  int32_t *pp = (int32_t*)part, *po = (int32_t*)out;
  auto* ex = (unsigned long long*)exc;
  if (group == 1 && b3k == B3_G1) {
    return launch_group<Fp<NW>, NW, SmallB3<B3_G1>, Prod, Sh<Fp<NW>>>(
        ip, is, il, ic, pp, po, W, B2, n, cap, T, P, I, SmallB3<B3_G1>{}, ex, aux, stream);
  }
  if (group == 2 && b3k == B3_G2) {
    if constexpr (B3_G2 > 0) {
      return launch_group<Fp2<NW>, NW, SmallB3<B3_G2>, Prod, Sh<Fp2<NW>>>(
          ip, is, il, ic, pp, po, W, B2, n, cap, T, P, I, SmallB3<B3_G2>{}, ex, aux, stream);
    } else {
      Fp2<NW> c;
      load_b3<NW>(c, b3);
      return launch_group<Fp2<NW>, NW, Fp2<NW>, Prod, Sh<Fp2<NW>>>(
          ip, is, il, ic, pp, po, W, B2, n, cap, T, P, I, c, ex, aux, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace bucket
}  // namespace zk
