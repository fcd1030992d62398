// S9: one-launch BN254 G2 probes over (16, B) int32 limb planes.
//
// Replaces the Pallas kernel of scripts/debug_g2_mosaic.py::main (:21, the
// pallas_call at :105), which put one piece of the G2 arithmetic inside a
// one-block kernel to find what crashed the TPU's compiler. One kernel per
// variant, one thread per lane, the arithmetic of field.cuh as it stands:
//   addaff    the complete mixed add (X1:Y1:Z1) + (X2, Y2) over Fq2
//             (add_affine_with, Karatsuba Fq2 products of CIOS: 39 a lane);
//             the script's addaff1 is the same add and kernel: it only
//             issued the Karatsuba products pair by pair instead of stacked,
//             and a thread issues its products one by one either way
//   fq2mul    one Karatsuba Fq2 product (fmul_with, 3 CIOS products);
//             the script's fq2mul1 is the same product and kernel
//   fqstack   mont_mul on a stacked (nl, k, B) tensor: fmul on k B lanes
//             (fqmul3d is k = 3, fqstack5/6/15/18 are k = 5, 6, 15, 18)
//   select    an Fq2 select on limb 0 of the first input, then an Fq2 zero
//             test
//
// Bound: at the script's B = 1024 lanes the work is a few microseconds of
// multiply-adds and a megabyte of planes: the launch itself. Registers bind
// the add (an Fq2 point and its Karatsuba temporaries), so blocks are 128
// threads.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int NL = 16;  // BN254 Fq: 16 limbs of 16 bits
constexpr int NW = NL / 2;
using Fp = zk::Fp<NW>;
using Fp2 = zk::Fp2<NW>;
using Params = zk::FieldParams<NW>;

enum Variant { ADDAFF = 0, FQ2MUL = 1, FQSTACK = 2, SELECT = 3 };

struct Planes {
  const int32_t* in[10];
  int32_t* out[6];
};

__device__ __forceinline__ Fp2 load2(const Planes& io, int i, int64_t B, int64_t t) {
  Fp2 v;
  v.a = zk::load_limbs<NW>(io.in[i], B, t);
  v.b = zk::load_limbs<NW>(io.in[i + 1], B, t);
  return v;
}

__device__ __forceinline__ void store2(const Planes& io, int o, int64_t B, int64_t t,
                                       const Fp2& v) {
  zk::store_limbs<NW>(io.out[o], B, t, v.a);
  zk::store_limbs<NW>(io.out[o + 1], B, t, v.b);
}

template <int V>
__global__ void __launch_bounds__(128)
g2_block_kernel(Planes io, int64_t B, int k, Params P, Fp2 b3) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (V == FQSTACK) {
    // lane t = i B + j of the (nl, k, B) stack: in[i % 2] * in[(i + 1) % 2]
    if (t >= (int64_t)k * B) return;
    const int64_t i = t / B, j = t - i * B;
    const Fp x = zk::load_limbs<NW>(io.in[i & 1], B, j);
    const Fp y = zk::load_limbs<NW>(io.in[(i + 1) & 1], B, j);
    zk::store_limbs<NW>(io.out[0], (int64_t)k * B, t, zk::fmul(x, y, P));
  } else if constexpr (V == SELECT) {
    if (t >= B) return;
    // s = in[0:2] where limb 0 of in[0] is nonzero, else in[2:4];
    // out = (s.a, s == 0 ? s.b : in[0])
    const bool cond = io.in[0][t] > 0;
    const int32_t* sa = cond ? io.in[0] : io.in[2];
    const int32_t* sb = cond ? io.in[1] : io.in[3];
    bool zero = true;
#pragma unroll
    for (int l = 0; l < NL; ++l) zero = zero && sa[l * B + t] == 0 && sb[l * B + t] == 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      io.out[0][l * B + t] = sa[l * B + t];
      io.out[1][l * B + t] = zero ? sb[l * B + t] : io.in[0][l * B + t];
    }
  } else if constexpr (V == FQ2MUL) {
    if (t >= B) return;
    store2(io, 0, B, t, zk::fmul_with(load2(io, 0, B, t), load2(io, 2, B, t), P,
                                      zk::CiosMul<NW>{P}));
  } else {  // ADDAFF: P = (in 0-1, 2-3, 4-5), Q = (in 6-7, 8-9)
    if (t >= B) return;
    Fp2 X = load2(io, 0, B, t), Y = load2(io, 2, B, t), Z = load2(io, 4, B, t);
    const Fp2 X2 = load2(io, 6, B, t), Y2 = load2(io, 8, B, t);
    zk::add_affine<Fp2, NW>(X, Y, Z, X2, Y2, b3, P);
    store2(io, 0, B, t, X);
    store2(io, 2, B, t, Y);
    store2(io, 4, B, t, Z);
  }
}

template <int V>
void launch(const Planes& io, int64_t lanes, int64_t B, int k, const Params& P, const Fp2& b3,
            cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  g2_block_kernel<V><<<blocks, threads, 0, stream>>>(io, B, k, P, b3);
}

}  // namespace

extern "C" {

// variant: 0 addaff, 1 fq2mul, 2 fqstack (k = stack width), 3 select. ins / outs: host arrays of n_in / n_out device pointers
// to (16, B) int32 planes (fqstack's single output is (16, k, B)). p, one:
// 8 words of BN254's Fq modulus and of R mod p; b3: 16 words, 3 b' of G2 in
// Montgomery form (real part, then u part). Returns the cudaError_t of the
// launch (0 on success).
int zk_g2_block(int variant, const void* const* ins, int n_in, void* const* outs, int n_out,
                long long B, int k, const uint32_t* p, uint32_t pinv, const uint32_t* one,
                const uint32_t* b3, void* stream) {
  static const int want_in[4] = {10, 4, 2, 4};
  static const int want_out[4] = {6, 2, 1, 2};
  if (variant < 0 || variant > 3 || n_in != want_in[variant] || n_out != want_out[variant] ||
      B < 0 || (variant == FQSTACK && k < 1))
    return (int)cudaErrorInvalidValue;
  Planes io = {};
  for (int i = 0; i < n_in; ++i) io.in[i] = (const int32_t*)ins[i];
  for (int i = 0; i < n_out; ++i) io.out[i] = (int32_t*)outs[i];
  const Params P = zk::field_params<NW>(p, pinv, one);
  Fp2 c;
  zk::load_b3<NW>(c, b3);
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t lanes = variant == FQSTACK ? (int64_t)k * B : B;
  if (lanes == 0) return (int)cudaGetLastError();
  switch (variant) {
    case ADDAFF: launch<ADDAFF>(io, lanes, B, k, P, c, s); break;
    case FQ2MUL: launch<FQ2MUL>(io, lanes, B, k, P, c, s); break;
    case FQSTACK: launch<FQSTACK>(io, lanes, B, k, P, c, s); break;
    default: launch<SELECT>(io, lanes, B, k, P, c, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
