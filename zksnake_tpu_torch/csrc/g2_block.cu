// S9: one-launch BN254 G2 probes over (16, B) int32 limb planes.
//
// Replaces the Pallas kernel of scripts/debug_g2_mosaic.py::main (:21, the
// pallas_call at :105), which put one piece of the G2 arithmetic inside a
// one-block kernel to find what crashed the TPU's compiler. One kernel per
// variant, the arithmetic of field.cuh:
//   addaff    the complete mixed add (X1:Y1:Z1) + (X2, Y2) over Fq2, spread
//             over a group of G lanes (g2_add_kernel below); the script's
//             addaff1 is the same add and kernel: it only issued the
//             Karatsuba products pair by pair instead of stacked
//   fq2mul    one Karatsuba Fq2 product (fmul_with, 3 CIOS products), one
//             thread a lane; the script's fq2mul1 is the same product
//   fqstack   mont_mul on a stacked (nl, k, B) tensor: fmul on k B lanes
//             (fqmul3d is k = 3, fqstack5/6/15/18 are k = 5, 6, 15, 18)
//   select    an Fq2 select on limb 0 of the first input, then an Fq2 zero
//             test
//
// Bound: at the script's B = 1024 lanes the add's multiply-adds take the
// card 0.00065 ms and its planes a megabyte, so what bounds it is the chain
// of dependent work in one add plus the launch: three levels of Montgomery
// products, each a serial carry chain of some 300 instructions, and the
// additions between them. One thread doing all 39 of an add's CIOS
// products in turn (as K2 does) runs that chain 39 times, with 8 of the 132
// SMs busy at 1024 lanes and an Fq2 point's registers spilling.
//
// The design: the add is the table of csrc/g2_add_schedule.cuh (written
// from kernels.py::G2_ADD_LEVELS): ten levels of independent Fq operations,
// three of them products (15, 6 and 18 CIOS products), the rest the
// additions and subtractions between them. A group of 16 lanes runs one
// add: each lane takes the level's ops lane, lane + 16, ... (one product a
// lane a level, two for lanes 0 and 1 in the last: four products deep),
// reading its operands from and writing its result to the group's slab of
// Fq slots in shared memory (34 slots of 32 bytes), and the warp syncs
// between levels. A lane holds only its op's operands and the CIOS
// product's words, so nothing spills. Groups never wait on each other: no
// block-wide barrier. A group whose add is past B computes on the last
// add's inputs and stores nothing; a warp with no add at all returns.
//
// The select loads every limb it may need at once and OR-reduces the zero
// test over registers (one memory latency, not a chain of 32 dependent
// loads).

#include <cuda_runtime.h>

#include "field.cuh"
#include "g2_add_schedule.cuh"

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
g2_block_kernel(Planes io, int64_t B, int k, Params P) {
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
    int32_t a[NL], b[NL], x[NL];
    int32_t any = 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      a[l] = sa[l * B + t];
      b[l] = sb[l * B + t];
      x[l] = io.in[0][l * B + t];
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) any |= a[l] | b[l];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      io.out[0][l * B + t] = a[l];
      io.out[1][l * B + t] = any == 0 ? b[l] : x[l];
    }
  } else {  // FQ2MUL
    if (t >= B) return;
    store2(io, 0, B, t, zk::fmul_with(load2(io, 0, B, t), load2(io, 2, B, t), P,
                                      zk::CiosMul<NW>{P}));
  }
}

// ------------------------------------------------------- the add ---------

constexpr int ADD_THREADS = 128;
constexpr int ADD_GROUP = 16;  // lanes an add

__device__ __forceinline__ Fp slot_load(const uint32_t* slab, int s) {
  const uint4* q = reinterpret_cast<const uint4*>(slab + s * NW);
  const uint4 lo = q[0], hi = q[1];
  return Fp{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void slot_store(uint32_t* slab, int s, const Fp& v) {
  uint4* q = reinterpret_cast<uint4*>(slab + s * NW);
  q[0] = make_uint4(v.c[0], v.c[1], v.c[2], v.c[3]);
  q[1] = make_uint4(v.c[4], v.c[5], v.c[6], v.c[7]);
}

// The ops [FIRST, END) of one level, lane `lane` of the group taking every
// ADD_GROUP-th; each reads the slab as the previous level left it.
template <int MUL, int FIRST, int END>
__device__ __forceinline__ void run_level(uint32_t* slab, int lane, const Params& P) {
#pragma unroll 1
  for (int o = FIRST + lane; o < END; o += ADD_GROUP) {
    const g2add::Op op = g2add::kOp[o];
    Fp x;
    if constexpr (MUL) {
      x = zk::fmul(zk::fadd(slot_load(slab, op.a0), slot_load(slab, op.a1), P),
                   zk::fadd(slot_load(slab, op.b0), slot_load(slab, op.b1), P), P);
    } else {
      const Fp a1 = slot_load(slab, op.a1), a2 = slot_load(slab, op.a2);
      x = slot_load(slab, op.a0);
      x = (op.neg & 1) ? zk::fsub(x, a1, P) : zk::fadd(x, a1, P);
      x = (op.neg & 2) ? zk::fsub(x, a2, P) : zk::fadd(x, a2, P);
    }
    slot_store(slab, op.dst, x);
  }
}

// One mixed add a group of ADD_GROUP lanes: P = (in 0-1, 2-3, 4-5), Q =
// (in 6-7, 8-9), out = P + Q (X3, Y3, Z3 as out 0-1, 2-3, 4-5).
__global__ void __launch_bounds__(ADD_THREADS)
g2_add_kernel(Planes io, int64_t B, Params P, Fp2 b3) {
  constexpr int G = ADD_GROUP, GROUPS = ADD_THREADS / G;
  // a group's slab is 4 words longer than its slots, so that the same slot
  // of the warp's groups starts on different banks
  __shared__ __align__(16) uint32_t slabs[GROUPS][g2add::kSlots * NW + 4];
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int64_t add = (int64_t)blockIdx.x * GROUPS + grp;
  const int64_t warp_first = (int64_t)blockIdx.x * GROUPS + (threadIdx.x / 32) * (32 / G);
  if (warp_first >= B) return;  // the whole warp: no add to do
  const bool live = add < B;
  const int64_t col = live ? add : B - 1;
  uint32_t* slab = slabs[grp];
  // the ten input elements, word w of input i a task (two 16-bit limbs)
  for (int task = lane; task < 10 * NW; task += G) {
    const int i = task / NW, w = task % NW;
    const int32_t* plane = io.in[i];
    const uint32_t lo = (uint32_t)plane[(2 * w) * B + col];
    const uint32_t hi = (uint32_t)plane[(2 * w + 1) * B + col];
    slab[i * NW + w] = lo | (hi << 16);
  }
  if (lane == 0) {
    slot_store(slab, g2add::kB3, b3.a);
    slot_store(slab, g2add::kB3 + 1, b3.b);
    slot_store(slab, g2add::kZero, zk::fzero<NW>());
  }
  __syncwarp();
#define ZK_RUN_LEVEL(MUL, FIRST, END)         \
  run_level<MUL, FIRST, END>(slab, lane, P); \
  __syncwarp();
  ZK_G2_ADD_LEVELS(ZK_RUN_LEVEL)
#undef ZK_RUN_LEVEL
  if (!live) return;
  // the six output elements, limb l of output o a task
  for (int task = lane; task < 6 * NL; task += G) {
    const int o = task / NL, l = task % NL;
    const uint32_t w = slab[g2add::kOutputs[o] * NW + l / 2];
    io.out[o][l * B + add] = (int32_t)((l & 1) ? w >> 16 : w & 0xFFFFu);
  }
}

template <int V>
void launch(const Planes& io, int64_t lanes, int64_t B, int k, const Params& P,
            cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  g2_block_kernel<V><<<blocks, threads, 0, stream>>>(io, B, k, P);
}

void launch_add(const Planes& io, int64_t B, const Params& P, const Fp2& b3,
                cudaStream_t stream) {
  constexpr int groups = ADD_THREADS / ADD_GROUP;
  const unsigned blocks = (unsigned)((B + groups - 1) / groups);
  g2_add_kernel<<<blocks, ADD_THREADS, 0, stream>>>(io, B, P, b3);
}

}  // namespace

extern "C" {

// variant: 0 addaff, 1 fq2mul, 2 fqstack (k = stack width), 3 select.
// ins / outs: host arrays of n_in / n_out device pointers to (16, B) int32
// planes (fqstack's single output is (16, k, B)). p, one: 8 words of
// BN254's Fq modulus and of R mod p; b3: 16 words, 3 b' of G2 in Montgomery
// form (real part, then u part). Returns the cudaError_t of the launch (0
// on success).
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
    case ADDAFF: launch_add(io, B, P, c, s); break;
    case FQ2MUL: launch<FQ2MUL>(io, lanes, B, k, P, s); break;
    case FQSTACK: launch<FQSTACK>(io, lanes, B, k, P, s); break;
    default: launch<SELECT>(io, lanes, B, k, P, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
