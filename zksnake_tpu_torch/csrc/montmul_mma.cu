// K3: batched Montgomery product out = a * b * R^-1 mod p, with both
// reduction products on the tensor cores.
//
// Replaces zksnake_tpu/backend/pallas_field.py::_make_kernel_mxu (the body
// is mxu_field.py::mont_mul_mxu_cols, launched by mont_mul_pallas with
// variant="mxu"). That kernel ran the SOS Montgomery product on (nl, 1024)
// VMEM tiles: the schoolbook T = a b on the vector unit, then the two
// reduction products, m = (T mod R) P' mod R and m p, as matmuls of
// constant byte-Toeplitz matrices (PMAT, PPMAT) against the byte planes of
// T mod R and of m on the MXU (bf16 in, f32 accumulate, exact).
//
// Here one thread owns one element (lane). A block of LB = 64 lanes:
//   1. copies the constant Toeplitz tiles of PMAT and PPMAT (built once by
//      the wrapper, kernels.py) from device memory into shared memory;
//   2. each thread forms T in 32-bit words (the schoolbook of field.cuh)
//      and writes the NB = 2 nl bytes of T mod R into a shared byte tile;
//   3. the two warps run m_conv = PMAT @ bytes(T mod R) as exact
//      u8 x u8 -> s32 WMMA products (m16n16k16), into shared int32;
//   4. each thread carries its column of m_conv into the bytes of m mod R;
//   5. the warps run mp_conv = PPMAT @ bytes(m), 2 NB rows;
//   6. each thread folds T + m p word by word (the low half comes out zero),
//      keeps the high half and subtracts p once if needed (canonical).
// Partial sums stay below 255^2 NB (3.2M at NB = 48), far inside s32, so
// every product is exact and the result equals K1's limb for limb. The
// JAX package's extra plane t8[NB] is always zero for an exact T mod R and
// meets only a zero column of PMAT, so K = NB (32, or 48 = 3 k16 steps).
//
// Bound: device memory, as K1: 3 nl 4-byte limb planes per lane; the
// tensor-core work (3 NB^2 byte MACs a lane) is a few percent of that time
// and the schoolbook is NW^2 32-bit multiply-adds. This first version keeps
// the products exact and simple; wgmma, TMA and fusing into K2 are later
// work.

#include <cuda_runtime.h>
#include <mma.h>

#include "field.cuh"

namespace {

using namespace nvcuda;

constexpr int LB = 64;  // lanes (= threads) per block: two warps

// acc[(mt*16 + r) * LB + lane] = sum_k A[mt*16 + r][k] * B[k][lane] for
// every row tile of A; each warp takes its half of the block's lane tiles.
template <int MT, int KT>
__device__ __forceinline__ void tile_product(const unsigned char* A, const unsigned char* B,
                                             int* acc) {
  constexpr int NT = LB / 16;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = warp * (NT / 2); nt < (warp + 1) * (NT / 2); ++nt) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> c;
      wmma::fill_fragment(c, 0);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, A + (mt * KT + kt) * 256, 16);
        wmma::load_matrix_sync(fb, B + (kt * NT + nt) * 256, 16);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(acc + (mt * 16) * LB + nt * 16, c, LB, wmma::mem_row_major);
    }
  }
}

// mats: the NB x NB block of PMAT then the 2NB x NB block of PPMAT, bytes,
// each cut into row-major 16x16 tiles stored one after another (tile
// (mt, kt) of a matrix at (mt * KT + kt) * 256).
template <int NW>
__global__ void __launch_bounds__(LB)
montmul_mma_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int64_t n, zk::FieldParams<NW> P,
                   const uint4* __restrict__ mats) {
  constexpr int NB = 4 * NW;   // bytes of an R-sized value (2 nl)
  constexpr int KT = NB / 16;  // k tiles: bytes of T mod R, or of m
  constexpr int NT = LB / 16;  // lane tiles of the block
  constexpr int MAT_BYTES = 3 * KT * KT * 256;
  __shared__ __align__(32) unsigned char smats[MAT_BYTES];      // PMAT, PPMAT tiles
  __shared__ __align__(32) unsigned char planes[KT * NT * 256];  // NB x LB bytes
  __shared__ __align__(32) int acc[2 * NB * LB];                 // products
  const unsigned char* pmat = smats;                   // NB x NB
  const unsigned char* ppmat = smats + KT * KT * 256;  // 2NB x NB

  for (int i = threadIdx.x; i < MAT_BYTES / 16; i += LB)
    reinterpret_cast<uint4*>(smats)[i] = mats[i];

  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * LB + tid;
  const bool live = lane < n;

  // T = a b, 2 NW words (zero on the ragged edge)
  uint32_t T[2 * NW];
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) T[j] = 0;
  if (live) {
    const zk::Fp<NW> x = zk::load_limbs<NW>(a, n, lane);
    const zk::Fp<NW> y = zk::load_limbs<NW>(b, n, lane);
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
  }

  // byte k of T mod R -> planes tile (k / 16, tid / 16), row k % 16, column tid % 16
  unsigned char* mine = planes + (tid >> 4) * 256 + (tid & 15);
#pragma unroll
  for (int k = 0; k < NB; ++k)
    mine[(k >> 4) * NT * 256 + (k & 15) * 16] = (unsigned char)((T[k >> 2] >> (8 * (k & 3))) & 0xFFu);
  __syncthreads();

  // m_conv = PMAT @ bytes(T mod R): rows 0..NB-1 of acc
  tile_product<KT, KT>(pmat, planes, acc);
  __syncthreads();

  // m = m_conv mod R as bytes (the carry out of byte NB-1 is dropped)
  int mc = 0;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int v = acc[k * LB + tid] + mc;
    mine[(k >> 4) * NT * 256 + (k & 15) * 16] = (unsigned char)(v & 0xFF);
    mc = v >> 8;
  }
  __syncthreads();

  // mp_conv = PPMAT @ bytes(m): 2 NB byte columns of m p
  tile_product<2 * KT, KT>(ppmat, planes, acc);
  __syncthreads();

  // (T + m p) / R: word w of m p is sum_q mp_conv[4w + q] 2^(8q)
  uint32_t r[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < 2 * NW; ++w) {
    uint64_t s = (uint64_t)T[w] + carry;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += (uint64_t)(uint32_t)acc[(4 * w + q) * LB + tid] << (8 * q);
    if (w >= NW) r[w - NW] = (uint32_t)s;
    carry = s >> 32;
  }
  if (live) zk::store_limbs<NW>(out, n, lane, zk::cond_sub_p<NW>(r, (uint32_t)carry, P));
}

template <int NW>
int launch(const void* a, const void* b, void* out, int64_t n, const uint32_t* p,
           const void* mats, cudaStream_t stream) {
  zk::FieldParams<NW> P;
  for (int j = 0; j < NW; ++j) {
    P.p[j] = p[j];
    P.one[j] = 0;
  }
  P.pinv = 0;
  if (n > 0) {
    const int64_t blocks = (n + LB - 1) / LB;
    montmul_mma_kernel<NW><<<(unsigned)blocks, LB, 0, stream>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n, P, (const uint4*)mats);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, out: (nl, n) int32 planes of 16-bit limbs, contiguous.
// p: nl/2 little-endian 32-bit words of the modulus (host memory).
// mats: device bytes of the PMAT and PPMAT tiles (see the kernel), 16-byte
// aligned. Returns the cudaError_t of the launch (0 on success).
int zk_mont_mul_mma(const void* a, const void* b, void* out, long long n, int nl,
                    const uint32_t* p, const void* mats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 16:
      return launch<8>(a, b, out, n, p, mats, s);
    case 24:
      return launch<12>(a, b, out, n, p, mats, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
