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
// Input, scratch and output are K2's (bucket.cu): pts (L, nl, W, n) sorted
// planes, starts/lens (W, B2), the int64 chunk table coff (W B2,), the
// chunk partials part (L nl + 1, cap) with cap from the rows' length (a
// bucket with chunks past it, which only overlapping runs have, the fold
// sums from its points), and out (3 or 6, nl, W, B2) bucket sums in affine
// normal form, G1 and G2.
//
// Design. K2m is K2's chunk and fold kernels (bucket_chunks.cuh), the same
// chunk length T, K chunks a lane, the same fold over G lanes, and K2's
// SmallB3 where 3b is a small integer, instantiated with MmaProduct below
// in place of the CIOS product. Its output, like K2's, is the affine normal
// form, which is unique, so it equals K2's limb for limb, and
// kernels.bucket_accumulate_plain(..., mode="mma", affine=True) computes it
// with K3's plain product. A product is collective over the warp
// (MmaProduct::kWarp), so no lane leaves early: each lane runs its warp's
// longest chunk in the chunk kernel (every member of every step, a member
// with nothing to add multiplying by one) and its warp's longest segment
// in the fold, computes past its end on a point it may read, and keeps
// nothing there; the lanes meet again after each inversion's loop
// (field.cuh finv_with). Each product:
//   1. each lane forms T = a b in 32-bit words (the schoolbook of K3) and
//      writes the NB = 2 nl bytes of T mod R into the warp's (NB x 32) byte
//      tile in shared memory;
//   2. the warp runs PMAT @ bytes as exact u8 x u8 -> s32 WMMA products
//      (m16n16k16, two 16-lane tiles) into its (2NB x 32) int32 tile;
//   3. each lane carries its column into the bytes of m mod R;
//   4. the warp runs PPMAT @ bytes(m), 2 NB rows;
//   5. each lane folds T + m p word by word and subtracts p once.
// The PMAT/PPMAT tiles (FieldSpec.mma_tiles, K3's) are copied into shared
// memory once per block, beside each warp's byte and int32 tiles: 39 KB a
// 128-thread block for BN254, 61 KB for BLS12-381 (Shape below).
//
// What bounds it. The work is the products K2 makes (six a point in the
// chunk kernel, 18 for G2; the fold's mixed adds, 11 or 13, 33 or 39 for
// G2), each 2 NW^2 multiply-adds for T and 3 NB^2 tensor-core MACs:
// operations. What the card spends is latency: a product is two tile
// products with four warp barriers and 3 NB x 32 int32 words through
// shared memory, so a warp waits on every product, and as many warps as
// the registers allow hide each other's waits. The product is a
// __noinline__ function so the G2 variants build in reasonable time.

#include <cuda_runtime.h>
#include <mma.h>

#include "bucket_chunks.cuh"

// One library per limb count (ZK_NL = 16: BN254, 24: BLS12-381).
#ifndef ZK_NL
#define ZK_NL 16
#endif

namespace {

using namespace nvcuda;

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

// K2m's product for bucket_chunks.cuh: aux holds K3's tiles
// (FieldSpec.mma_tiles), the NB x NB block of PMAT then the 2NB x NB block
// of PPMAT, 16-byte aligned; the block's shared memory holds them, then
// each warp's byte tile and int32 tile.
template <int NW>
struct MmaProduct {
  static constexpr bool kWarp = true;
  static constexpr int NB = 4 * NW, KT = NB / 16;
  static constexpr int MAT_BYTES = 3 * KT * KT * 256;
  static constexpr int PLANE_BYTES = KT * 2 * 256;
  static constexpr int WARP_BYTES = PLANE_BYTES + 2 * NB * 32 * 4;
  __host__ __device__ static constexpr int smem_bytes(int bt) {
    return MAT_BYTES + bt / 32 * WARP_BYTES;
  }
  __device__ static MmaMul<NW> make(const zk::FieldParams<NW>& P, unsigned char* smem,
                                    const void* aux) {
    const uint4* mats = static_cast<const uint4*>(aux);
    for (int i = threadIdx.x; i < MAT_BYTES / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] = mats[i];
    __syncthreads();
    unsigned char* mine = smem + MAT_BYTES + (threadIdx.x >> 5) * WARP_BYTES;
    return MmaMul<NW>{P, smem, smem + KT * KT * 256, mine,
                      reinterpret_cast<int*>(mine + PLANE_BYTES), (int)(threadIdx.x & 31)};
  }
};

// K2m's counterpart of K2's Shape (bucket.cu): threads a block, chunks a
// lane sums at once (0: the projective order) and blocks an SM should
// hold, per group; K2's BT and K, so the two sum in one order and return
// the same limbs; no register cap (none measured).
template <class F>
struct Shape;
template <int NW>
struct Shape<zk::Fp<NW>> {
  static constexpr int BT = 128, K = NW == 8 ? 0 : 16, MINB = 1;
};
template <int NW>
struct Shape<zk::Fp2<NW>> {
  static constexpr int BT = 64, K = 16, MINB = 1;
};

}  // namespace

extern "C" {

// K2's interface (bucket.cu) plus mats, the device tile bytes of K3.
int zk_bucket_accumulate_mma(const void* pts, const void* starts, const void* lens,
                             const void* coff, void* part, void* out, int nl, int group, int W,
                             int B2, long long n, long long cap, int T, const uint32_t* p,
                             uint32_t pinv, const uint32_t* one, const uint32_t* r3,
                             const uint32_t* b3, int b3k, void* exc, const void* mats,
                             void* stream) {
  if (nl != ZK_NL || cap < 1 || cap >= (1LL << 31) || mats == nullptr)
    return (int)cudaErrorInvalidValue;
  return zk::bucket::launch<ZK_NL / 2, MmaProduct, Shape>(
      pts, starts, lens, coff, part, out, group, W, B2, n, cap, T, p, pinv, one, r3, b3, b3k,
      exc, mats, (cudaStream_t)stream);
}

// Shape's K of the group's build (1: G1, 2: G2; -1 for another).
int zk_bucket_members(int group) { return zk::bucket::members<ZK_NL / 2, Shape>(group); }

}  // extern "C"
