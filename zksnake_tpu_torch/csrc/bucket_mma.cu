// K2m: K2 (bucket.cu) with every Montgomery product's two reductions on the
// tensor cores.
//
// Replaces zksnake_tpu/backend/pallas_field.py::bucket_accumulate_pallas
// under ZKSNAKE_MXU_MONTMUL=1: there the same pallas_call takes the
// reduction matrices PMAT and PPMAT as leading inputs (_mxu_mats,
// pallas_field.py:201-218, 274-278) and every field product of the bucket
// body becomes mxu_field.py::mont_mul_mxu_cols, the SOS product whose
// reductions m = (T mod R) P' mod R and m p are matmuls of constant
// byte-Toeplitz matrices against byte planes.
//
// Input and output are K2's: pts (L, nl, W, n) sorted planes, starts/lens
// (W, B2), out (3 or 6, nl, W, B2) projective bucket sums, G1 and G2.
// Canonical Montgomery products are equal limb for limb whatever the
// reduction, so the output is bit-identical to K2's.
//
// Design. A tensor-core product needs the whole warp, and K2 lets each
// thread leave its run at its own length. Here one thread still owns one
// (window, bucket), but a warp runs as many rounds as the longest run among
// its 32 lanes (__reduce_max_sync); a lane past its run computes the add on
// its run's first point and keeps its bucket (the Pallas kernel's `valid`
// mask). Each product (13 per mixed add for G1, 39 for G2's Karatsuba Fq2)
// is collective over the warp:
//   1. each lane forms T = a b in 32-bit words (the schoolbook of K3) and
//      writes the NB = 2 nl bytes of T mod R into the warp's (NB x 32) byte
//      tile in shared memory;
//   2. the warp runs PMAT @ bytes as exact u8 x u8 -> s32 WMMA products
//      (m16n16k16, two 16-lane tiles) into its (2NB x 32) int32 tile;
//   3. each lane carries its column into the bytes of m mod R;
//   4. the warp runs PPMAT @ bytes(m), 2 NB rows;
//   5. each lane folds T + m p word by word and subtracts p once.
// The PMAT/PPMAT tiles (FieldSpec.mma_tiles, K3's) are copied into shared
// memory once per block. A block is two warps: 21.5 KB of shared memory
// for BN254, 34.5 KB for BLS12-381.
//
// What bounds it: the operations, as K2; each product adds two warp
// barriers and 3 NB x 32 int32 words through shared memory. The product is
// a __noinline__ function so the G2 variants (39 products per add) build
// in reasonable time. This first version is right and simple; mma.sync
// with the accumulators kept in registers, and load balancing the runs,
// are later work.

#include <cuda_runtime.h>
#include <mma.h>

#include "field.cuh"

// One library per limb count (ZK_NL = 16: BN254, 24: BLS12-381).
#ifndef ZK_NL
#define ZK_NL 16
#endif

namespace {

using namespace nvcuda;

constexpr int LB = 64;  // threads per block: two warps
constexpr int WARPS = LB / 32;

// acc[(mt * 16 + r) * 32 + lane] = sum_k A[mt * 16 + r][k] * B[k][lane] for
// every row tile of A and both 16-lane tiles of the warp. A: (MT x KT) row-
// major 16x16 tiles, tile (mt, kt) at (mt * KT + kt) * 256; B: (KT x 2)
// tiles, tile (kt, nt) at (kt * 2 + nt) * 256.
template <int MT, int KT>
__device__ __forceinline__ void warp_tile_product(const unsigned char* A,
                                                  const unsigned char* B, int* acc) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> c;
      wmma::fill_fragment(c, 0);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, A + (mt * KT + kt) * 256, 16);
        wmma::load_matrix_sync(fb, B + (kt * 2 + nt) * 256, 16);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(acc + (mt * 16) * 32 + nt * 16, c, 32, wmma::mem_row_major);
    }
  }
}

// The Montgomery product x y R^-1 mod p, canonical, collective over the
// warp (every lane calls it at the same point). planes: the warp's NB x 32
// byte tile; acc: its 2NB x 32 int32 tile.
template <int NW>
__device__ __noinline__ zk::Fp<NW> mma_mul(const zk::Fp<NW> x, const zk::Fp<NW> y,
                                           const zk::FieldParams<NW>& P,
                                           const unsigned char* pmat,
                                           const unsigned char* ppmat,
                                           unsigned char* planes, int* acc, int lane) {
  constexpr int NB = 4 * NW;   // bytes of an R-sized value (2 nl)
  constexpr int KT = NB / 16;  // k tiles: bytes of T mod R, or of m
  uint32_t T[2 * NW];
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) T[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t cs = (uint64_t)T[i + j] + (uint64_t)x.c[i] * y.c[j] + c;
      T[i + j] = (uint32_t)cs;
      c = cs >> 32;
    }
    T[i + NW] = (uint32_t)c;
  }

  // byte k of T mod R -> tile (k / 16, lane / 16), row k % 16, column lane % 16
  unsigned char* mine = planes + (lane >> 4) * 256 + (lane & 15);
#pragma unroll
  for (int k = 0; k < NB; ++k)
    mine[(k >> 4) * 2 * 256 + (k & 15) * 16] = (unsigned char)((T[k >> 2] >> (8 * (k & 3))) & 0xFFu);
  __syncwarp();

  // m_conv = PMAT @ bytes(T mod R): rows 0..NB-1 of acc
  warp_tile_product<KT, KT>(pmat, planes, acc);
  __syncwarp();

  // m = m_conv mod R as bytes (the carry out of byte NB-1 is dropped)
  int mc = 0;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int v = acc[k * 32 + lane] + mc;
    mine[(k >> 4) * 2 * 256 + (k & 15) * 16] = (unsigned char)(v & 0xFF);
    mc = v >> 8;
  }
  __syncwarp();

  // mp_conv = PPMAT @ bytes(m): 2 NB byte columns of m p
  warp_tile_product<2 * KT, KT>(ppmat, planes, acc);
  __syncwarp();

  // (T + m p) / R: word w of m p is sum_q mp_conv[4w + q] 2^(8q)
  uint32_t r[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < 2 * NW; ++w) {
    uint64_t s = (uint64_t)T[w] + carry;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += (uint64_t)(uint32_t)acc[(4 * w + q) * 32 + lane] << (8 * q);
    if (w >= NW) r[w - NW] = (uint32_t)s;
    carry = s >> 32;
  }
  return zk::cond_sub_p<NW>(r, (uint32_t)carry, P);
}

template <int NW>
struct MmaMul {
  const zk::FieldParams<NW>& P;
  const unsigned char* pmat;
  const unsigned char* ppmat;
  unsigned char* planes;
  int* acc;
  int lane;
  __device__ __forceinline__ zk::Fp<NW> operator()(const zk::Fp<NW>& a,
                                                   const zk::Fp<NW>& b) const {
    return mma_mul<NW>(a, b, P, pmat, ppmat, planes, acc, lane);
  }
};

// mats: K3's tiles (FieldSpec.mma_tiles): the NB x NB block of PMAT then the
// 2NB x NB block of PPMAT, 16-byte aligned.
template <class F, int NW>
__global__ void __launch_bounds__(LB)
bucket_mma_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ lens, int32_t* __restrict__ out, int W,
                  int B2, int64_t n, zk::FieldParams<NW> P, F b3,
                  const uint4* __restrict__ mats) {
  constexpr int NB = 4 * NW;
  constexpr int KT = NB / 16;
  constexpr int MAT_BYTES = 3 * KT * KT * 256;
  __shared__ __align__(32) unsigned char smats[MAT_BYTES];
  __shared__ __align__(32) unsigned char planes[WARPS][KT * 2 * 256];
  __shared__ __align__(32) int acc[WARPS][2 * NB * 32];
  for (int i = threadIdx.x; i < MAT_BYTES / 16; i += LB)
    reinterpret_cast<uint4*>(smats)[i] = mats[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t nb = (int64_t)W * B2;
  const int64_t tid = (int64_t)blockIdx.x * LB + threadIdx.x;
  // lanes past the last bucket take part in the warp's products and store
  // nothing
  const bool live = tid < nb;
  const int64_t w = live ? tid / B2 : 0;
  const int64_t start = live ? starts[tid] : 0;
  const int len = live ? lens[tid] : 0;
  const int rounds = __reduce_max_sync(0xFFFFFFFFu, len);
  // leaf l, row w: plane base + l * (nl * W * n) + w * n; limbs at stride W*n
  const int64_t stride = (int64_t)W * n;
  const int32_t* row = pts + w * n;
  const MmaMul<NW> mul{P, smats, smats + KT * KT * 256, planes[warp], acc[warp], lane};

  F X, Y, Z;
  zk::set_zero<NW>(X);
  zk::set_one<NW>(Y, P);
  zk::set_zero<NW>(Z);
  for (int k = 0; k < rounds; ++k) {
    const int64_t pos = k < len ? start + k : (len > 0 ? start : 0);
    const F qx = zk::load_leaf<NW>(row, 0, stride, pos, (F*)nullptr);
    const F qy = zk::load_leaf<NW>(row, 1, stride, pos, (F*)nullptr);
    F x = X, y = Y, z = Z;
    zk::add_affine_with<F, NW>(x, y, z, qx, qy, b3, P, mul);
    if (k < len) {
      X = x;
      Y = y;
      Z = z;
    }
  }
  if (live) {
    zk::store_leaf<NW>(out, 0, nb, tid, X);
    zk::store_leaf<NW>(out, 1, nb, tid, Y);
    zk::store_leaf<NW>(out, 2, nb, tid, Z);
  }
}

template <int NW>
int launch(const void* pts, const void* starts, const void* lens, void* out, int group,
           int W, int B2, int64_t n, const uint32_t* p, uint32_t pinv, const uint32_t* one,
           const uint32_t* b3, const void* mats, cudaStream_t stream) {
  const zk::FieldParams<NW> P = zk::field_params<NW>(p, pinv, one);
  const int64_t nb = (int64_t)W * B2;
  const unsigned blocks = (unsigned)((nb + LB - 1) / LB);
  if (nb == 0) return (int)cudaGetLastError();
  if (group == 1) {
    zk::Fp<NW> c;
    zk::load_b3<NW>(c, b3);
    bucket_mma_kernel<zk::Fp<NW>, NW><<<blocks, LB, 0, stream>>>(
        (const int32_t*)pts, (const int32_t*)starts, (const int32_t*)lens, (int32_t*)out,
        W, B2, n, P, c, (const uint4*)mats);
  } else if (group == 2) {
    zk::Fp2<NW> c;
    zk::load_b3<NW>(c, b3);
    bucket_mma_kernel<zk::Fp2<NW>, NW><<<blocks, LB, 0, stream>>>(
        (const int32_t*)pts, (const int32_t*)starts, (const int32_t*)lens, (int32_t*)out,
        W, B2, n, P, c, (const uint4*)mats);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2's interface (bucket.cu) plus mats, the device tile bytes of K3.
int zk_bucket_accumulate_mma(const void* pts, const void* starts, const void* lens,
                             void* out, int nl, int group, int W, int B2, long long n,
                             const uint32_t* p, uint32_t pinv, const uint32_t* one,
                             const uint32_t* b3, const void* mats, void* stream) {
  if (nl != ZK_NL) return (int)cudaErrorInvalidValue;
  return launch<ZK_NL / 2>(pts, starts, lens, out, group, W, B2, n, p, pinv, one, b3, mats,
                           (cudaStream_t)stream);
}

}  // extern "C"
