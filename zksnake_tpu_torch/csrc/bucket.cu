// K2: Pippenger bucket accumulation for every window of one MSM in one launch.
//
// Replaces zksnake_tpu/backend/pallas_field.py::bucket_accumulate_pallas.
// The Pallas kernel streamed a padded round-major table through R grid steps
// of one masked mixed add over all B bucket lanes (Mosaic's grid is fixed, so
// the table, its gather, the static round budget and a remainder loop existed
// to fit it). Here one thread owns one (window, bucket) and walks its own
// contiguous run of the points sorted by |digit|, in rank order, with the
// complete mixed add of field.cuh: no table, no padding, no masked rounds.
//
// Input  pts:    (L, nl, W, n) int32 planes, L = 2 (G1: X, Y) or 4 (G2: X.a,
//                X.b, Y.a, Y.b); row w holds the n points sorted by window w's
//                |digit|, with Y already negated for negative digits.
//        starts, lens: (W, B2) int32, the run of |digit| = b + 1 in row w.
// Output out:    (3 or 6, nl, W, B2) projective bucket sums X, Y, Z (leaves in
//                the same order as the input's), identity (0 : 1 : 0) for an
//                empty run.
//
// What bounds it: the runs are ragged (the mean is n / B2, the longest a few
// standard deviations more), so a warp runs as long as its longest run and
// the tail of the launch is a few long-run warps. For G2 the register budget
// binds first: a thread holds an Fq2 accumulator and point, 5 x 2 x NW words,
// plus the Karatsuba temporaries, and spills past 255 registers. Load
// balancing the runs and splitting G2 coordinates over lanes are later work.

#include <cuda_runtime.h>

#include "field.cuh"

// One library per limb count (ZK_NL = 16: BN254, 24: BLS12-381), built in
// parallel: the fully unrolled Fq2 variants dominate the build time.
#ifndef ZK_NL
#define ZK_NL 16
#endif

namespace {

template <class F, int NW>
__global__ void __launch_bounds__(128)
bucket_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ starts,
              const int32_t* __restrict__ lens, int32_t* __restrict__ out,
              int W, int B2, int64_t n, zk::FieldParams<NW> P, F b3) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nb = (int64_t)W * B2;
  if (tid >= nb) return;
  const int64_t w = tid / B2;
  const int64_t start = starts[tid];
  const int len = lens[tid];
  // leaf l, row w: plane base + l * (nl * W * n) + w * n; limbs at stride W*n
  const int64_t stride = (int64_t)W * n;
  const int32_t* row = pts + w * n;

  F X, Y, Z;
  zk::set_zero<NW>(X);
  zk::set_one<NW>(Y, P);
  zk::set_zero<NW>(Z);
  for (int k = 0; k < len; ++k) {
    const int64_t pos = start + k;
    const F qx = zk::load_leaf<NW>(row, 0, stride, pos, (F*)nullptr);
    const F qy = zk::load_leaf<NW>(row, 1, stride, pos, (F*)nullptr);
    zk::add_affine<F, NW>(X, Y, Z, qx, qy, b3, P);
  }
  zk::store_leaf<NW>(out, 0, nb, tid, X);
  zk::store_leaf<NW>(out, 1, nb, tid, Y);
  zk::store_leaf<NW>(out, 2, nb, tid, Z);
}

template <int NW>
int launch(const void* pts, const void* starts, const void* lens, void* out,
           int group, int W, int B2, int64_t n, const uint32_t* p, uint32_t pinv,
           const uint32_t* one, const uint32_t* b3, cudaStream_t stream) {
  const zk::FieldParams<NW> P = zk::field_params<NW>(p, pinv, one);
  const int64_t nb = (int64_t)W * B2;
  const int threads = 128;
  const unsigned blocks = (unsigned)((nb + threads - 1) / threads);
  if (nb == 0) return (int)cudaGetLastError();
  if (group == 1) {
    zk::Fp<NW> c;
    zk::load_b3<NW>(c, b3);
    bucket_kernel<zk::Fp<NW>, NW><<<blocks, threads, 0, stream>>>(
        (const int32_t*)pts, (const int32_t*)starts, (const int32_t*)lens,
        (int32_t*)out, W, B2, n, P, c);
  } else if (group == 2) {
    zk::Fp2<NW> c;
    zk::load_b3<NW>(c, b3);
    bucket_kernel<zk::Fp2<NW>, NW><<<blocks, threads, 0, stream>>>(
        (const int32_t*)pts, (const int32_t*)starts, (const int32_t*)lens,
        (int32_t*)out, W, B2, n, P, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// See the header comment for the layouts. p, one: nl/2 words; b3: nl/2 words
// (G1) or nl words (G2: real part then u part), all Montgomery form except p.
int zk_bucket_accumulate(const void* pts, const void* starts, const void* lens,
                         void* out, int nl, int group, int W, int B2,
                         long long n, const uint32_t* p, uint32_t pinv,
                         const uint32_t* one, const uint32_t* b3, void* stream) {
  if (nl != ZK_NL) return (int)cudaErrorInvalidValue;
  return launch<ZK_NL / 2>(pts, starts, lens, out, group, W, B2, n, p, pinv, one, b3,
                           (cudaStream_t)stream);
}

}  // extern "C"
