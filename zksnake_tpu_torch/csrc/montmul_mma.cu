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
// Here each warp multiplies 32 consecutive elements at a time, one a lane,
// in a grid-stride loop over such tiles: a lane reads its element's limbs
// at stride N (neighbouring lanes on neighbouring addresses, as K1), forms
// T in 32-bit words, and the warp runs the two reductions as mma.sync
// m16n8k32 u8 products with everything in registers (mma_frag.cuh: the
// elements' words are the A fragments, the constant Toeplitz B fragments are
// loaded once a lane from a table in fragment order, each n8 tile's columns
// reach their element's lane by one transpose inside the quad). No shared
// memory, no barrier; the result equals K1's limb for limb.
//
// Bound: device memory, as K1: 3 nl 4-byte limb planes per lane. The
// tensor-core work (3 NB^2 byte MACs a lane) is a few percent of that time
// and the schoolbook is NW^2 32-bit multiply-adds; the quad transposes are
// about 3 NB / 4 shuffles a lane.

#include <cuda_runtime.h>

#include "mma_frag.cuh"

namespace {

// threads a block: BN254's build (95 registers) keeps two blocks of 256 on
// an SM, BLS12-381's (165) three of 128, where blocks of 256 left one an SM
// and ran slower on the H100
template <int NW>
constexpr int THREADS = NW <= 8 ? 256 : 128;
template <int NW>
constexpr int WARPS = THREADS<NW> / 32;

template <int NW>
__global__ void __launch_bounds__(THREADS<NW>)
montmul_mma_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int64_t n, zk::FieldParams<NW> P,
                   const uint2* __restrict__ frags) {
  const int lane = threadIdx.x & 31;
  zk::frag::RegFrags<NW> bf;
  bf.load(frags, lane);
  const int64_t stride = (int64_t)gridDim.x * WARPS<NW>;
  // warp-uniform: every lane of a warp takes the same tiles
  for (int64_t tile = (int64_t)blockIdx.x * WARPS<NW> + (threadIdx.x >> 5); tile * 32 < n;
       tile += stride) {
    const int64_t i = tile * 32 + lane;
    const bool live = i < n;
    zk::Fp<NW> x = zk::fzero<NW>(), y = zk::fzero<NW>();  // zeros past n
    if (live) {
      x = zk::load_limbs<NW>(a, n, i);
      y = zk::load_limbs<NW>(b, n, i);
    }
    const zk::Fp<NW> r = zk::frag::mont_mul<NW>(x, y, bf, P, lane);
    if (live) zk::store_limbs<NW>(out, n, i, r);
  }
}

template <int NW>
int launch(const void* a, const void* b, void* out, int64_t n, const uint32_t* p,
           const void* frags, cudaStream_t stream) {
  zk::FieldParams<NW> P;
  for (int j = 0; j < NW; ++j) {
    P.p[j] = p[j];
    P.one[j] = 0;
  }
  P.pinv = 0;
  if (n <= 0) return (int)cudaGetLastError();
  // one wave of resident blocks at most; the warps stride over the rest
  static int resident[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, montmul_mma_kernel<NW>,
                                                  THREADS<NW>, 0);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = (n + 31) / 32;
  const int64_t want = (tiles + WARPS<NW> - 1) / WARPS<NW>;
  const int64_t blocks = want < resident[dev] ? want : resident[dev];
  montmul_mma_kernel<NW><<<(unsigned)blocks, THREADS<NW>, 0, stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n, P, (const uint2*)frags);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, out: (nl, n) int32 planes of 16-bit limbs, contiguous.
// p: nl/2 little-endian 32-bit words of the modulus (host memory).
// frags: the device table of B fragments (FieldSpec.mma_frags: NF x 32
// uint2, 8-byte aligned). Returns the cudaError_t of the launch (0 on
// success).
int zk_mont_mul_mma(const void* a, const void* b, void* out, long long n, int nl,
                    const uint32_t* p, const void* frags, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 16:
      return launch<8>(a, b, out, n, p, frags, s);
    case 24:
      return launch<12>(a, b, out, n, p, frags, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
