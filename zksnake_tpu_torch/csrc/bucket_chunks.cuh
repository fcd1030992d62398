// The chunk and fold kernels of K2 (bucket.cu) and K2m (bucket_mma.cu), on
// any field product: K2 instantiates them with the CIOS product
// (CiosProduct below), K2m with its tensor-core product. bucket.cu's header
// comment describes the order they sum in; both kernels sum in it, with
// canonical products, so K2 and K2m are equal limb for limb.
//
// A product is a policy class Prod<NW>:
//   Prod<NW>::kWarp          true where a product is collective over the warp
//                            (every lane calls it at the same point);
//   Prod<NW>::smem_bytes(bt) the shared memory a block of bt threads needs;
//   Prod<NW>::make(P, smem, aux) -> mul, the functor mul(a, b) -> Fp<NW>,
//                            called by every thread of the block first (it
//                            may stage aux into smem and __syncthreads).
// Where the product is collective no lane leaves early: every lane runs the
// warp's longest trip count (__reduce_max_sync), adds a point it may read
// (its chunk's or segment's first one; a lane with none reads slot 0) past
// its end, and keeps and stores nothing there.
//
// A shape class Sh gives the block's threads (BT) and the steps of the
// chunk kernel's cp.async point ring (STAGES; 0: no ring), per build. Only
// a per-thread product takes a ring.
//
// The scratch. part holds the partials of chunks 0 .. cap - 1, cap from
// the rows' length (kernels.chunk_scratch): every chunk where each
// window's runs total at most its n points, as sort_by_digit's do. Runs
// that overlap can have more chunks than that; a bucket with a chunk past
// the scratch is folded by the fold's cold instance, which sums its chunks
// from their points in the chunk kernel's order, so the output is the
// same function of any runs and the host never waits for the chunk count.
#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace zk {
namespace bucket {

// The chunk length T and the fold's lanes a bucket G (a power of two up to
// 32); backend/kernels.py K2_CHUNK and K2_FOLD_LANES hold the same values.
constexpr int T = 8, G = 4;
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

// The fold's cold instance's product: CIOS out of line. Only overlapping
// runs reach that instance, and with its products inlined its G2 builds
// would about double each library's build.
template <int NW>
__device__ __noinline__ Fp<NW> fmul_cold(const Fp<NW> a, const Fp<NW> b,
                                         const FieldParams<NW>& P) {
  return fmul(a, b, P);
}
template <int NW>
struct ColdProduct {
  struct Mul {
    const FieldParams<NW>& P;
    __device__ __forceinline__ Fp<NW> operator()(const Fp<NW>& a, const Fp<NW>& b) const {
      return fmul_cold<NW>(a, b, P);
    }
  };
  static constexpr bool kWarp = false;
  __host__ __device__ static constexpr int smem_bytes(int) { return 0; }
  __device__ static Mul make(const FieldParams<NW>& P, unsigned char*, const void*) {
    return Mul{P};
  }
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

// planes of X and Y of one point of F
template <class F, int NW>
__host__ __device__ constexpr int point_planes() {
  return (int)(sizeof(F) / sizeof(Fp<NW>)) * 4 * NW;
}

// Sum the m <= T points of a chunk from the identity into X, Y, Z, reading
// device memory: point k, plane q at src[q stride + k]. Where the product
// is collective every lane runs its warp's longest chunk, and past its own
// end adds its chunk's first point again (a lane with no chunk passes a
// src it may read) and keeps nothing.
template <class F, int NW, bool WARP, class B, class Mul>
__device__ __forceinline__ void sum_chunk(const int32_t* src, int64_t stride, int m, F& X,
                                          F& Y, F& Z, const B& b3, const FieldParams<NW>& P,
                                          const Mul& mul) {
  set_zero<NW>(X);
  set_one<NW>(Y, P);
  set_zero<NW>(Z);
  if constexpr (!WARP) {
    for (int k = 0; k < m; ++k) {
      const F qx = load_leaf<NW>(src, 0, stride, k, (F*)nullptr);
      const F qy = load_leaf<NW>(src, 1, stride, k, (F*)nullptr);
      add_affine_with<F, NW>(X, Y, Z, qx, qy, b3, P, mul);
    }
  } else {
    const int steps = __reduce_max_sync(0xffffffffu, m);
    for (int k = 0; k < steps; ++k) {
      const int kk = k < m ? k : 0;
      const F qx = load_leaf<NW>(src, 0, stride, kk, (F*)nullptr);
      const F qy = load_leaf<NW>(src, 1, stride, kk, (F*)nullptr);
      F x = X, y = Y, z = Z;
      add_affine_with<F, NW>(x, y, z, qx, qy, b3, P, mul);
      if (k < m) {
        X = x;
        Y = y;
        Z = z;
      }
    }
  }
}

// One thread a chunk g < min(coff[-1], cap): its partial into part[g].
template <class F, int NW, class B, class Prod, class Sh>
__global__ void __launch_bounds__(Sh::BT)
chunk_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ starts,
             const int32_t* __restrict__ lens, const int64_t* __restrict__ coff,
             int32_t* __restrict__ part, int W, int B2, int64_t n, int64_t cap,
             FieldParams<NW> P, B b3, const void* __restrict__ aux) {
  constexpr int BT = Sh::BT, S = Sh::STAGES;
  constexpr int PL = point_planes<F, NW>();
  constexpr bool WARP = Prod::kWarp;
  static_assert(!WARP || S == 0, "a warp-collective product reads its points directly");
  const int nb = W * B2;
  const int64_t live_end = coff[nb - 1] < cap ? coff[nb - 1] : cap;
  if ((int64_t)blockIdx.x * BT >= live_end) return;  // the whole block: before make's barrier
  extern __shared__ __align__(128) int32_t zk_smem[];  // the product's tiles, then the ring
  const auto mul = Prod::make(P, reinterpret_cast<unsigned char*>(zk_smem), aux);
  const int64_t g = (int64_t)blockIdx.x * BT + threadIdx.x;
  const bool live = g < live_end;
  if (!WARP && !live) return;
  int lo = 0, hi = nb - 1;  // the first bucket with coff[b] > g
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (coff[mid] > g) hi = mid;
    else lo = mid + 1;
  }
  const int len = lens[lo];
  const int64_t rank = (g - (coff[lo] - (len + T - 1) / T)) * T;
  // a lane past the last chunk (only where the product is collective) has
  // no points and reads slot 0 of row 0
  const int m = live ? min(T, len - (int)rank) : 0;
  // point k of the chunk, plane q: pts[(q W + w) n + starts + rank + k]
  const int32_t* src = live ? pts + (int64_t)(lo / B2) * n + starts[lo] + rank : pts;
  const int64_t stride = (int64_t)W * n;
  F X, Y, Z;
  if constexpr (S == 0) {
    sum_chunk<F, NW, WARP>(src, stride, m, X, Y, Z, b3, P, mul);
  } else {
    set_zero<NW>(X);
    set_one<NW>(Y, P);
    set_zero<NW>(Z);
    int32_t* const ring = zk_smem + Prod::smem_bytes(BT) / 4;  // [S][PL][BT]
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
      const F qx = load_leaf<NW>(cur, 0, BT, threadIdx.x, (F*)nullptr);
      const F qy = load_leaf<NW>(cur, 1, BT, threadIdx.x, (F*)nullptr);
      add_affine_with<F, NW>(X, Y, Z, qx, qy, b3, P, mul);
    }
  }
  if (live) {
    store_leaf<NW>(part, 0, cap, g, X);
    store_leaf<NW>(part, 1, cap, g, Y);
    store_leaf<NW>(part, 2, cap, g, Z);
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

// G neighbouring lanes a bucket (see bucket.cu's header comment). The
// main instance (COLD = false) folds the buckets whose chunks all lie in
// the scratch, reading their partials. The cold one folds the others, which
// only overlapping runs have, summing each chunk from its points
// (sum_chunk) in the same order; it takes the CIOS product (ColdProduct)
// whatever the main instance's (products are canonical, so the limbs are
// the same), and a block with no such bucket leaves at once (coff rises,
// so its last bucket tells).
template <class F, int NW, class B, class Prod, class Sh, bool COLD>
__global__ void __launch_bounds__(Sh::BT)
fold_kernel(const int32_t* __restrict__ part, const int32_t* __restrict__ pts,
            const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
            const int64_t* __restrict__ coff, int32_t* __restrict__ out, int W, int B2,
            int64_t n, int64_t cap, FieldParams<NW> P, B b3, const void* __restrict__ aux) {
  constexpr bool WARP = Prod::kWarp;
  static_assert(!(COLD && WARP), "the cold instance takes a per-thread product");
  const int nb = W * B2;
  if constexpr (COLD) {
    const int64_t last = ((int64_t)blockIdx.x * Sh::BT + Sh::BT - 1) / G;
    if (coff[last < nb ? last : nb - 1] <= cap) return;
  }
  extern __shared__ __align__(128) int32_t zk_smem[];  // the product's tiles
  const auto mul = Prod::make(P, reinterpret_cast<unsigned char*>(zk_smem), aux);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = t / G;
  const int j = (int)(t % G);
  // every lane takes part in the shuffles; lanes past the last bucket, or
  // on a bucket of the other instance, hold no chunks
  const bool mine = b < nb && (coff[b] > cap) == COLD;
  const int nch = mine ? (lens[b] + T - 1) / T : 0;
  const int s = (nch + G - 1) / G;  // lane j folds chunks [j s, min(nch, (j + 1) s))
  const int lo = j * s, hi = min(nch, lo + s);
  const int64_t first = mine ? coff[b] - nch : 0;
  F X, Y, Z;
  set_zero<NW>(X);
  set_one<NW>(Y, P);
  set_zero<NW>(Z);
  if constexpr (WARP) {
    const int seg = max(hi - lo, 0);
    const int steps = __reduce_max_sync(0xffffffffu, seg);
    const int64_t base = seg > 0 ? first + lo : 0;  // past its segment: its first partial
    if (seg > 0) {
      X = load_leaf<NW>(part, 0, cap, base, (F*)nullptr);
      Y = load_leaf<NW>(part, 1, cap, base, (F*)nullptr);
      Z = load_leaf<NW>(part, 2, cap, base, (F*)nullptr);
    }
    for (int k = 1; k < steps; ++k) {
      const int64_t idx = k < seg ? base + k : base;
      const F x2 = load_leaf<NW>(part, 0, cap, idx, (F*)nullptr);
      const F y2 = load_leaf<NW>(part, 1, cap, idx, (F*)nullptr);
      const F z2 = load_leaf<NW>(part, 2, cap, idx, (F*)nullptr);
      F x = X, y = Y, z = Z;
      add_proj_with<F, NW>(x, y, z, x2, y2, z2, b3, P, mul);
      if (k < seg) {
        X = x;
        Y = y;
        Z = z;
      }
    }
  } else if (lo < hi) {
    if constexpr (COLD) {
      // chunk k: the points of ranks k T .. of the bucket's run
      const int32_t* row = pts + (b / B2) * n + starts[b];
      const int len = lens[b];
      for (int k = lo; k < hi; ++k) {
        F x2, y2, z2;
        sum_chunk<F, NW, false>(row + k * T, (int64_t)W * n, min(T, len - k * T), x2, y2, z2,
                                b3, P, mul);
        if (k == lo) {
          X = x2;
          Y = y2;
          Z = z2;
        } else {
          add_proj_with<F, NW>(X, Y, Z, x2, y2, z2, b3, P, mul);
        }
      }
    } else {
      X = load_leaf<NW>(part, 0, cap, first + lo, (F*)nullptr);
      Y = load_leaf<NW>(part, 1, cap, first + lo, (F*)nullptr);
      Z = load_leaf<NW>(part, 2, cap, first + lo, (F*)nullptr);
      for (int k = lo + 1; k < hi; ++k) {
        const F x2 = load_leaf<NW>(part, 0, cap, first + k, (F*)nullptr);
        const F y2 = load_leaf<NW>(part, 1, cap, first + k, (F*)nullptr);
        const F z2 = load_leaf<NW>(part, 2, cap, first + k, (F*)nullptr);
        add_proj_with<F, NW>(X, Y, Z, x2, y2, z2, b3, P, mul);
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
  if (j == 0 && mine) {
    store_leaf<NW>(out, 0, nb, b, X);
    store_leaf<NW>(out, 1, nb, b, Y);
    store_leaf<NW>(out, 2, nb, b, Z);
  }
}

// One group's launches: the chunk kernel over the scratch's cap chunks,
// then the fold over the buckets' G lanes, main and cold instances.
template <class F, int NW, class B, template <int> class Prod, class Sh>
int launch_group(const int32_t* pts, const int32_t* starts, const int32_t* lens,
                 const int64_t* coff, int32_t* part, int32_t* out, int W, int B2, int64_t n,
                 int64_t cap, const FieldParams<NW>& P, const B& b3, const void* aux,
                 cudaStream_t stream) {
  constexpr int BT = Sh::BT, S = Sh::STAGES;
  constexpr int fsmem = Prod<NW>::smem_bytes(BT);
  constexpr int csmem = fsmem + S * point_planes<F, NW>() * BT * 4;
  auto chunk = chunk_kernel<F, NW, B, Prod<NW>, Sh>;
  auto fold = fold_kernel<F, NW, B, Prod<NW>, Sh, false>;
  auto fold_cold = fold_kernel<F, NW, B, ColdProduct<NW>, Sh, true>;
  static bool attr = false;  // one attribute call per process and kernel
  if (!attr) {
    cudaError_t e = cudaSuccess;
    if (csmem > 0)
      e = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, csmem);
    if (e == cudaSuccess && fsmem > 0)
      e = cudaFuncSetAttribute(fold, cudaFuncAttributeMaxDynamicSharedMemorySize, fsmem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int nb = W * B2;
  const unsigned cblocks = (unsigned)((cap + BT - 1) / BT);
  chunk<<<cblocks, BT, csmem, stream>>>(pts, starts, lens, coff, part, W, B2, n, cap, P, b3,
                                        aux);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned fblocks = (unsigned)(((int64_t)nb * G + BT - 1) / BT);
  fold<<<fblocks, BT, fsmem, stream>>>(part, pts, starts, lens, coff, out, W, B2, n, cap, P, b3,
                                       aux);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fold_cold<<<fblocks, BT, 0, stream>>>(part, pts, starts, lens, coff, out, W, B2, n, cap, P,
                                        b3, nullptr);
  return (int)cudaGetLastError();
}

// K2's and K2m's C interface behind the entry points: p, one: NW words;
// b3: NW words (G1) or 2 NW (G2: real part then u part), all Montgomery
// form except p; b3k: 3b as a small integer (GroupSpec.b3_small), which
// must be this build's; aux: the product's operand (Prod::make); coff:
// int64; cap: the chunks part holds (at least 1).
template <int NW, template <int> class Prod, template <class> class Sh>
int launch(const void* pts, const void* starts, const void* lens, const void* coff, void* part,
           void* out, int group, int W, int B2, int64_t n, int64_t cap, const uint32_t* p,
           uint32_t pinv, const uint32_t* one, const uint32_t* b3, int b3k, const void* aux,
           cudaStream_t stream) {
  constexpr int B3_G1 = SmallB3Of<NW>::G1, B3_G2 = SmallB3Of<NW>::G2;
  const FieldParams<NW> P = field_params<NW>(p, pinv, one);
  if ((int64_t)W * B2 == 0) return (int)cudaGetLastError();
  const int32_t *ip = (const int32_t*)pts, *is = (const int32_t*)starts,
                *il = (const int32_t*)lens;
  const int64_t* ic = (const int64_t*)coff;
  int32_t *pp = (int32_t*)part, *po = (int32_t*)out;
  if (group == 1 && b3k == B3_G1) {
    return launch_group<Fp<NW>, NW, SmallB3<B3_G1>, Prod, Sh<Fp<NW>>>(
        ip, is, il, ic, pp, po, W, B2, n, cap, P, SmallB3<B3_G1>{}, aux, stream);
  }
  if (group == 2 && b3k == B3_G2) {
    if constexpr (B3_G2 > 0) {
      return launch_group<Fp2<NW>, NW, SmallB3<B3_G2>, Prod, Sh<Fp2<NW>>>(
          ip, is, il, ic, pp, po, W, B2, n, cap, P, SmallB3<B3_G2>{}, aux, stream);
    } else {
      Fp2<NW> c;
      load_b3<NW>(c, b3);
      return launch_group<Fp2<NW>, NW, Fp2<NW>, Prod, Sh<Fp2<NW>>>(
          ip, is, il, ic, pp, po, W, B2, n, cap, P, c, aux, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace bucket
}  // namespace zk
