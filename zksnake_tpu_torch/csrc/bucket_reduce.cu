// K4: the bucket reduction of one MSM pass, every MSM's bucket sums to its
// result, in two launches.
//
// Replaces no TPU kernel: the JAX package reduces its buckets in plain jnp
// (zksnake_tpu/backend/msm.py), and the port did the same with torch point
// ops launched from the host, a few hundred launches each, 316 point ops a
// pass at the Groth16 prove's shape whatever the number of points
// (kernels.bucket_reduce_plain, K4's plain version). K4 runs that body's
// point ops in its order, and every field element is canonical, so the two
// are equal limb for limb.
//
// Input  buckets: (L, nl, M, W, B2) int32 16-bit limbs, L = 3 (G1: X, Y, Z)
//                 or 6 (G2: X.a, X.b, Y.a, ...): the bucket sums of M
//                 independent MSMs (K2's outputs stacked), window 0 the top
//                 one, lane b the bucket of |digit| = b + 1.
// Scratch win:    the M W windows as packed 32-bit words, PW = 3 sizeof(F)
//                 / 4 words a point: word q of lane b of window i = m W + w
//                 at win[(i PW + q) B2 + b].
//         sums:   the M W window sums, word q of window i at sums[q M W + i].
// Output out:     (L, nl, M) the M results, projective.
//
// The order, that of kernels.bucket_reduce_plain:
//  1. window_kernel, one cluster of blocks a window (w, m), lane b of
//     B2 = 2^(c - 1):
//     a. in window 0 where the top window's buckets are spread over S_top > 1
//        sub-buckets of V_cap lanes (sort_by_digit): for H = B2 / 2, B2 / 4,
//        .., V_cap, lane b < H adds lane b + H; then lanes V_cap .. B2 - 1
//        become the identity;
//     b. the suffix scan: for d = 1, 2, .., B2 / 2, lane b < B2 - d adds
//        lane b + d, every add reading the level's input;
//     c. the window tree: for H = B2 / 2, .., 1, lane b < H adds lane b + H.
//     Lane 0 is then sum_b (b + 1) S_b. Every add is the complete projective
//     add (field.cuh add_proj, GroupSpec.add's formula).
//  2. horner_kernel, one warp an MSM: R = identity; for w = 0 .. W - 1,
//     c doublings (RCB15 Algorithm 9, GroupSpec.double's formula), then R
//     adds window w's sum (add_proj's formula).
//
// What bounds it. The window launch is operations: about (c - 1) B2 adds a
// window, all M W windows at once (987k adds of 12 products for the Groth16
// prove's G1 pass, c = 11, M = 4, W = 24). The Horner launch is latency: a
// chain of c W doublings and W adds an MSM, on one SM each.
//
// The design. A level needs every lane of the level before, so a window's
// threads step through its levels together, with barriers. They are one
// block, or where M W windows leave multiprocessors idle (the G2 pass's 24)
// a cluster of K blocks, up to 8, on as many multiprocessors, whose barrier
// is the cluster's. The lanes live in global memory, read from L2 (9.4 MB
// for that G1 pass): it holds a window at any c, where shared memory would
// not (BN254's G1 window at c = 13 is 384 KB, BLS12-381's G2 window at
// c = 11 288 KB), and every block of a cluster reads it. A level runs in
// rounds of the window's threads: every thread reads its two operands, they
// wait, then each adds and writes, so the lanes update in place. The
// Horner chain is serial by definition, and one thread walking it waits on
// each product in turn; so a warp walks it, and the independent products
// of each of a point op's levels (two or three a doubling or an add, of up
// to 18 Fp products) run on its lanes at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

// One library per limb count (ZK_NL = 16: BN254, 24: BLS12-381).
#ifndef ZK_NL
#define ZK_NL 16
#endif

namespace {

using namespace zk;
namespace cg = cooperative_groups;

// the window kernel's threads a block (at most; fewer where B2 is smaller)
constexpr int BT = 256;

template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* base, int64_t stride, int64_t idx,
                                           Fp<NW>& v) {
#pragma unroll
  for (int j = 0; j < NW; ++j) v.c[j] = __ldcg(base + j * stride + idx);  // from L2
}
template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* base, int64_t stride, int64_t idx,
                                           Fp2<NW>& v) {
  load_words<NW>(base, stride, idx, v.a);
  load_words<NW>(base + NW * stride, stride, idx, v.b);
}
template <int NW>
__device__ __forceinline__ void store_words(uint32_t* base, int64_t stride, int64_t idx,
                                            const Fp<NW>& v) {
#pragma unroll
  for (int j = 0; j < NW; ++j) base[j * stride + idx] = v.c[j];
}
template <int NW>
__device__ __forceinline__ void store_words(uint32_t* base, int64_t stride, int64_t idx,
                                            const Fp2<NW>& v) {
  store_words<NW>(base, stride, idx, v.a);
  store_words<NW>(base + NW * stride, stride, idx, v.b);
}

// A point as packed words: X, then Y, then Z, sizeof(F) / 4 words each.
template <class F, int NW>
__device__ __forceinline__ void load_point(const uint32_t* base, int64_t stride, int64_t idx,
                                           F& X, F& Y, F& Z) {
  constexpr int WF = sizeof(F) / 4;
  load_words<NW>(base, stride, idx, X);
  load_words<NW>(base + WF * stride, stride, idx, Y);
  load_words<NW>(base + 2 * WF * stride, stride, idx, Z);
}
template <class F, int NW>
__device__ __forceinline__ void store_point(uint32_t* base, int64_t stride, int64_t idx,
                                            const F& X, const F& Y, const F& Z) {
  constexpr int WF = sizeof(F) / 4;
  store_words<NW>(base, stride, idx, X);
  store_words<NW>(base + WF * stride, stride, idx, Y);
  store_words<NW>(base + 2 * WF * stride, stride, idx, Z);
}

// The threads of one window: its cluster of K blocks. tid is this thread's
// index among them, nt their count; sync() is the cluster's barrier, which
// makes each thread's writes before it visible to the others after it.
struct Team {
  int tid, nt;
  __device__ __forceinline__ void sync() const { cg::this_cluster().sync(); }
};

// One level of a window: lane b < n adds lane b + d, every add reading the
// level's input. Every thread of the window's team calls it.
template <class F, int NW, class B>
__device__ __forceinline__ void add_level(uint32_t* lanes, int B2, int n, int d, const Team& team,
                                          const B& b3, const FieldParams<NW>& P) {
  for (int r = 0; r < n; r += team.nt) {
    const int b = r + team.tid;
    F X, Y, Z, X2, Y2, Z2;
    if (b < n) {
      load_point<F, NW>(lanes, B2, b, X, Y, Z);
      load_point<F, NW>(lanes, B2, b + d, X2, Y2, Z2);
    }
    // later rounds read lanes past this one's, which this round leaves as
    // they were; this round's operands are in registers before any write
    team.sync();
    if (b < n) {
      add_proj<F, NW>(X, Y, Z, X2, Y2, Z2, b3, P);
      store_point<F, NW>(lanes, B2, b, X, Y, Z);
    }
  }
  team.sync();
}

// Window blockIdx.x / K of MSM blockIdx.y, on a cluster of K blocks.
template <class F, int NW, class B>
__global__ void __launch_bounds__(BT, 1)
window_kernel(const int32_t* __restrict__ buckets, uint32_t* __restrict__ win,
              uint32_t* __restrict__ sums, int M, int W, int B2, int S_top, int V_cap, int K,
              FieldParams<NW> P, B b3) {
  constexpr int WF = sizeof(F) / 4;
  const int w = blockIdx.x / K;
  const Team team{(int)(blockIdx.x % K) * (int)blockDim.x + (int)threadIdx.x,
                  K * (int)blockDim.x};
  const int64_t i = (int64_t)blockIdx.y * W + w;
  const int64_t planes = (int64_t)M * W * B2;  // between the input's limb planes
  uint32_t* const lanes = win + i * 3 * WF * B2;
  for (int b = team.tid; b < B2; b += team.nt) {
    const int64_t idx = i * B2 + b;
    store_point<F, NW>(lanes, B2, b, load_leaf<NW>(buckets, 0, planes, idx, (F*)nullptr),
                       load_leaf<NW>(buckets, 1, planes, idx, (F*)nullptr),
                       load_leaf<NW>(buckets, 2, planes, idx, (F*)nullptr));
  }
  team.sync();
  if (w == 0 && S_top > 1) {
    for (int h = B2 / 2; h >= V_cap; h /= 2) add_level<F, NW>(lanes, B2, h, h, team, b3, P);
    F X, Y, Z;
    set_zero<NW>(X);
    set_one<NW>(Y, P);
    set_zero<NW>(Z);
    for (int b = V_cap + team.tid; b < B2; b += team.nt) store_point<F, NW>(lanes, B2, b, X, Y, Z);
    team.sync();
  }
  for (int d = 1; d < B2; d *= 2) add_level<F, NW>(lanes, B2, B2 - d, d, team, b3, P);
  for (int h = B2 / 2; h >= 1; h /= 2) add_level<F, NW>(lanes, B2, h, h, team, b3, P);
  if (team.tid == 0) {
    F X, Y, Z;
    load_point<F, NW>(lanes, B2, 0, X, Y, Z);
    store_point<F, NW>(sums, (int64_t)M * W, i, X, Y, Z);
  }
}

// ---- Horner: one warp an MSM, each level of a point op's products spread
// over its lanes. An F product is one Fp product (G1) or Karatsuba's three
// (G2, fmul_with's); every lane keeps the whole point, computes the linear
// ops itself, and gets the level's products through the warp's slab in
// shared memory (slot j, word w at slab[w * 32 + j]).

template <class F>
struct Parts {
  static constexpr int n = 1;
};
template <int NW>
struct Parts<Fp2<NW>> {
  static constexpr int n = 3;
};

template <int NW>
__device__ __forceinline__ void put_slot(uint32_t* slab, int j, const Fp<NW>& v) {
#pragma unroll
  for (int w = 0; w < NW; ++w) slab[w * 32 + j] = v.c[w];
}
template <int NW>
__device__ __forceinline__ Fp<NW> get_slot(const uint32_t* slab, int j) {
  Fp<NW> v;
#pragma unroll
  for (int w = 0; w < NW; ++w) v.c[w] = slab[w * 32 + j];
  return v;
}

// Part r of the F product a b as one Fp product's operands x y.
template <int NW>
__device__ __forceinline__ void part(const Fp<NW>& a, const Fp<NW>& b, int, Fp<NW>& x,
                                     Fp<NW>& y, const FieldParams<NW>&) {
  x = a;
  y = b;
}
template <int NW>
__device__ __forceinline__ void part(const Fp2<NW>& a, const Fp2<NW>& b, int r, Fp<NW>& x,
                                     Fp<NW>& y, const FieldParams<NW>& P) {
  if (r == 0) {
    x = a.a;
    y = b.a;
  } else if (r == 1) {
    x = a.b;
    y = b.b;
  } else {
    x = fadd(a.a, a.b, P);
    y = fadd(b.a, b.b, P);
  }
}

// F product q of the level from the slab.
template <int NW>
__device__ __forceinline__ void join(const uint32_t* slab, int q, Fp<NW>& c,
                                     const FieldParams<NW>&) {
  c = get_slot<NW>(slab, q);
}
template <int NW>
__device__ __forceinline__ void join(const uint32_t* slab, int q, Fp2<NW>& c,
                                     const FieldParams<NW>& P) {
  const Fp<NW> t0 = get_slot<NW>(slab, 3 * q), t1 = get_slot<NW>(slab, 3 * q + 1);
  c.a = fsub(t0, t1, P);
  c.b = fsub(fsub(get_slot<NW>(slab, 3 * q + 2), t0, P), t1, P);
}

// The K independent F products of one level: pick(q, a, b) sets product
// q's operands; lane j computes Fp product j of the K R, and every lane
// gets all K in c. Every lane of the warp calls it.
template <class F, int NW, int K, class Pick>
__device__ __forceinline__ void warp_products(const Pick& pick, F (&c)[K], uint32_t* slab,
                                              const FieldParams<NW>& P) {
  constexpr int R = Parts<F>::n;
  static_assert(K * R <= 32, "a level's products fit a warp");
  const int lane = threadIdx.x & 31;
  F a, b;
  pick(lane / R < K ? lane / R : K - 1, a, b);
  Fp<NW> x, y;
  part<NW>(a, b, lane % R, x, y, P);
  const Fp<NW> t = fmul(x, y, P);
  __syncwarp();  // every lane has read the slab's last level
  if (lane < K * R) put_slot<NW>(slab, lane, t);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < K; ++i) join<NW>(slab, i, c[i], P);
}

// b3 x for each x: additions where b3 is a SmallB3, else one level.
template <class F, int NW, int K, class B>
__device__ __forceinline__ void warp_mul_b3(const B& b3, const F (&x)[K], F (&c)[K],
                                            uint32_t* slab, const FieldParams<NW>& P) {
  if constexpr (std::is_same<B, F>::value) {
    warp_products<F, NW, K>([&](int q, F& a, F& b) { a = b3; b = x[q]; }, c, slab, P);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = fmul_with(b3, x[i], P, CiosMul<NW>{P});
  }
}

// Complete doubling over a warp, RCB15 Algorithm 9 with a = 0: the formula
// of GroupSpec.double, so every output coordinate is the same field element.
template <class F, int NW, class B>
__device__ __forceinline__ void warp_dbl(F& X, F& Y, F& Z, const B& b3, uint32_t* slab,
                                         const FieldParams<NW>& P) {
  F u[4];  // Y^2, Y Z, Z^2, X Y
  warp_products<F, NW, 4>(
      [&](int q, F& a, F& b) {
        a = q == 2 ? Z : q == 3 ? X : Y;
        b = q == 0 || q == 3 ? Y : Z;
      },
      u, slab, P);
  F z3 = fadd(u[0], u[0], P);
  z3 = fadd(z3, z3, P);
  z3 = fadd(z3, z3, P);  // 8 Y^2
  F t2b[1];
  {
    const F t2[1] = {u[2]};
    warp_mul_b3<F, NW, 1>(b3, t2, t2b, slab, P);
  }
  const F y3 = fadd(u[0], t2b[0], P);
  const F t0m = fsub(u[0], fadd(fadd(t2b[0], t2b[0], P), t2b[0], P), P);  // Y^2 - 3 b3 Z^2
  F v[4];  // t2b z3, Y Z z3, t0m X Y, t0m y3
  warp_products<F, NW, 4>(
      [&](int q, F& a, F& b) {
        a = q == 0 ? t2b[0] : q == 1 ? u[1] : t0m;
        b = q == 0 || q == 1 ? z3 : q == 2 ? u[3] : y3;
      },
      v, slab, P);
  X = fadd(v[2], v[2], P);
  Y = fadd(v[0], v[3], P);
  Z = v[1];
}

// Complete projective addition over a warp: field.cuh add_proj's formula
// (GroupSpec.add's).
template <class F, int NW, class B>
__device__ __forceinline__ void warp_add(F& X1, F& Y1, F& Z1, const F& X2, const F& Y2,
                                         const F& Z2, const B& b3, uint32_t* slab,
                                         const FieldParams<NW>& P) {
  F u[6];  // X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
  warp_products<F, NW, 6>(
      [&](int q, F& a, F& b) {
        if (q < 3) {
          a = q == 0 ? X1 : q == 1 ? Y1 : Z1;
          b = q == 0 ? X2 : q == 1 ? Y2 : Z2;
        } else {
          a = fadd(q == 5 ? X1 : q == 3 ? X1 : Y1, q == 3 ? Y1 : Z1, P);
          b = fadd(q == 5 ? X2 : q == 3 ? X2 : Y2, q == 3 ? Y2 : Z2, P);
        }
      },
      u, slab, P);
  const F t3 = fsub(u[3], fadd(u[0], u[1], P), P);  // X1 Y2 + X2 Y1
  const F t4 = fsub(u[4], fadd(u[1], u[2], P), P);
  const F t5 = fsub(u[5], fadd(u[0], u[2], P), P);
  const F t0_3 = fadd(fadd(u[0], u[0], P), u[0], P);
  F m[2];  // b3 Z1 Z2, b3 t5
  {
    const F x[2] = {u[2], t5};
    warp_mul_b3<F, NW, 2>(b3, x, m, slab, P);
  }
  const F z3s = fadd(u[1], m[0], P);
  const F t1m = fsub(u[1], m[0], P);
  F v[6];  // t3 t1m, t4 y3p, y3p t0_3, t1m z3s, z3s t4, t0_3 t3
  warp_products<F, NW, 6>(
      [&](int q, F& a, F& b) {
        switch (q) {
          case 0: a = t3; b = t1m; break;
          case 1: a = t4; b = m[1]; break;
          case 2: a = m[1]; b = t0_3; break;
          case 3: a = t1m; b = z3s; break;
          case 4: a = z3s; b = t4; break;
          default: a = t0_3; b = t3; break;
        }
      },
      v, slab, P);
  X1 = fsub(v[0], v[1], P);
  Y1 = fadd(v[2], v[3], P);
  Z1 = fadd(v[4], v[5], P);
}

// One warp an MSM: R = identity; for each window, c doublings and the add of
// its sum. Lane 0 writes the result.
template <class F, int NW, class B>
__global__ void __launch_bounds__(32)
horner_kernel(const uint32_t* __restrict__ sums, int32_t* __restrict__ out, int M, int W, int c,
              FieldParams<NW> P, B b3) {
  __shared__ uint32_t slab[NW * 32];
  const int m = blockIdx.x;
  F X, Y, Z;
  set_zero<NW>(X);
  set_one<NW>(Y, P);
  set_zero<NW>(Z);
  for (int w = 0; w < W; ++w) {
    for (int k = 0; k < c; ++k) warp_dbl<F, NW>(X, Y, Z, b3, slab, P);
    F X2, Y2, Z2;
    load_point<F, NW>(sums, (int64_t)M * W, (int64_t)m * W + w, X2, Y2, Z2);
    warp_add<F, NW>(X, Y, Z, X2, Y2, Z2, b3, slab, P);
  }
  if (threadIdx.x == 0) {
    store_leaf<NW>(out, 0, M, m, X);
    store_leaf<NW>(out, 1, M, m, Y);
    store_leaf<NW>(out, 2, M, m, Z);
  }
}

// fn(F{}, b3) with the group's field and 3b: a SmallB3 where 3b is a small
// integer (b3k, GroupSpec.b3_small, must be this build's), else 3b's
// Montgomery words (G2: real part then u part).
template <int NW, class Fn>
int with_group(int group, int b3k, const uint32_t* b3, Fn&& fn) {
  constexpr int K1 = SmallB3Of<NW>::G1, K2 = SmallB3Of<NW>::G2;
  if (group == 1 && b3k == K1) return fn(Fp<NW>{}, SmallB3<K1>{});
  if (group == 2 && b3k == K2) {
    if constexpr (K2 > 0) {
      return fn(Fp2<NW>{}, SmallB3<K2>{});
    } else {
      Fp2<NW> k;
      load_b3<NW>(k, b3);
      return fn(Fp2<NW>{}, k);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Steps 1a-c of every window (the header comment's layouts). p, one: NW
// words; b3 and b3k as with_group takes them. B2 a power of two, S_top = 1
// or S_top V_cap = B2 with S_top a power of two, 1 <= M <= 65535.
int zk_bucket_reduce_windows(const void* buckets, void* win, void* sums, int nl, int group,
                             int M, int W, int B2, int S_top, int V_cap, const uint32_t* p,
                             uint32_t pinv, const uint32_t* one, const uint32_t* b3, int b3k,
                             void* stream) {
  if (nl != ZK_NL || M < 1 || M > 65535 || W < 1 || B2 < 1 || (B2 & (B2 - 1)) != 0 ||
      S_top < 1 || (S_top & (S_top - 1)) != 0 || (S_top > 1 && (int64_t)S_top * V_cap != B2))
    return (int)cudaErrorInvalidValue;
  const FieldParams<ZK_NL / 2> P = field_params<ZK_NL / 2>(p, pinv, one);
  const int threads = B2 < BT ? (B2 + 31) / 32 * 32 : BT;
  // K blocks a window, a power of two up to 8 (a portable cluster), while
  // the M W windows' K blocks still fit one a multiprocessor and each
  // block has a thread a lane
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int K = 1;
  while (K < 8 && (int64_t)2 * K * M * W <= sms && 2 * K * threads <= B2) K *= 2;
  return with_group<ZK_NL / 2>(group, b3k, b3, [&](auto f, auto k) {
    using F = decltype(f);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(W * K, M);
    cfg.blockDim = dim3(threads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = K;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, window_kernel<F, ZK_NL / 2, decltype(k)>,
                                   (const int32_t*)buckets, (uint32_t*)win, (uint32_t*)sums, M,
                                   W, B2, S_top, V_cap, K, P, k);
  });
}

// Step 2: sums (from zk_bucket_reduce_windows) -> out, c doublings a window.
int zk_bucket_reduce_horner(const void* sums, void* out, int nl, int group, int M, int W, int c,
                            const uint32_t* p, uint32_t pinv, const uint32_t* one,
                            const uint32_t* b3, int b3k, void* stream) {
  if (nl != ZK_NL || M < 1 || W < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const FieldParams<ZK_NL / 2> P = field_params<ZK_NL / 2>(p, pinv, one);
  return with_group<ZK_NL / 2>(group, b3k, b3, [&](auto f, auto k) {
    using F = decltype(f);
    horner_kernel<F, ZK_NL / 2, decltype(k)><<<M, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)sums, (int32_t*)out, M, W, c, P, k);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
