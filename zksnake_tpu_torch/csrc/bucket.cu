// K2: Pippenger bucket accumulation for every window of one MSM, as chunks
// summed in affine coordinates with one inversion shared by a lane's
// chunks, then a fold; BN254's G1 build sums its chunks in projective
// coordinates instead (the projective order, below).
//
// Replaces zksnake_tpu/backend/pallas_field.py::bucket_accumulate_pallas.
// The Pallas kernel streamed a padded round-major table through R grid steps
// of one masked mixed add over all B bucket lanes (Mosaic's grid is fixed, so
// the table, its gather, the static round budget and a remainder loop existed
// to fit it). Here the sorted runs are read where they lie.
//
// Input  pts:    (L, nl, W, n) int32 planes, L = 2 (G1: X, Y) or 4 (G2: X.a,
//                X.b, Y.a, Y.b); row w holds the n points sorted by window w's
//                |digit|, with Y already negated for negative digits; none
//                is the identity (sort_by_digit drops those).
//        starts, lens: (W, B2) int32, the run of |digit| = b + 1 in row w.
//        coff:   (W B2,) int64, the inclusive prefix sum over the buckets (in
//                (w, b) order) of ceil(len / T): the chunk table, T the
//                chunk length the wrapper passes.
// Scratch part:  (L nl + 1, cap) int32: chunk partials X, Y, affine (L nl
//                planes), then a flag, 1 where the partial is the identity
//                (the projective order: X, Y, Z, 3 L nl / 2 planes);
//                cap = kernels.chunk_scratch(W, B2, n, T) =
//                max(1, (W n + (T - 1) W B2) / T): every chunk where each
//                window's runs total at most n points (sort_by_digit's do).
//                Runs that overlap may have more; a bucket with a chunk past
//                cap is folded from its points, so the kernel computes the
//                same function of any runs and the host never waits for
//                coff[-1].
// Output out:    (3 or 6, nl, W, B2) bucket sums in affine normal form:
//                (X, Y, 1) for a finite sum, (0, 1, 0) for the identity (an
//                empty run, or one that cancels), Montgomery form. That form
//                is unique, so every order of summing gives the same limbs:
//                kernels.bucket_accumulate_plain(..., affine=True), the rank-
//                order walk brought to that form, equals the kernel limb for
//                limb, and so does K2m (bucket_mma.cu). The projective
//                order leaves its sums projective: the same points, and the
//                same limbs as K2m's, which sums in that order too.
// Counter exc:   where not null, the members that met a doubling, a
//                cancellation or an identity (uint64, added to); the
//                projective order's complete add has none.
//
// The order. The kernels are bucket_chunks.cuh's on the CIOS product (K2m
// runs the same ones on its tensor-core product). Every run is cut into
// chunks of T consecutive points from its start, the last one shorter:
// ceil(len / T) chunks, numbered bucket by bucket in (w, b) order, so chunk
// g belongs to the first bucket with coff[b] > g.
//  1. chunk_kernel: each lane sums K chunks at once (Shape below), lane t
//     of block i taking chunks (i K + k) BT + t, k < K. A member (a chunk)
//     starts at its first point, affine; at step s = 1 .. T - 1 every member
//     with an s-th point adds it: the lane forms each member's denominator
//     x2 - x1 and their running product (one product a member), inverts
//     the product once, and walks back, peeling each member's inverse off
//     it (two products) and finishing its add: lambda = (y2 - y1) / (x2 -
//     x1), x3 = lambda^2 - x1 - x2, y3 = lambda (x1 - x3) - y1 (three
//     products): six a point. Exact for every input, with no branch out of
//     the batch: a member whose sum is the identity takes the point as it
//     is, one with x1 = x2 doubles (denominator 2 y1, lambda = 3 x1^2 / 2
//     y1) where y1 = y2 and becomes the identity where y1 = -y2; each adds
//     denominator 1 where it has nothing to finish.
//  2. fold_kernel: G neighbouring lanes a bucket of m chunks. Lane j adds
//     the partials of chunks j s .. min(m, (j + 1) s) - 1, s = ceil(m / G),
//     to the identity with the complete mixed add (field.cuh add_affine,
//     skipping a partial flagged the identity; a bucket with a chunk past
//     the scratch adds those chunks' points instead); then for d = 1, 2,
//     .., G / 2 lane j (j a multiple of 2d) adds lane j + d's sum if that
//     lane had chunks (shuffles), with the complete projective add
//     (field.cuh add_proj). Projective sums into out.
//  3. fold_kernel, its normal-form instance: each lane brings KN sums of
//     out to affine normal form with one inversion (Montgomery's trick).
//  The inversions are field.cuh's safegcd (inv_int): shifts, adds and
//  32-bit products, no field product.
// The projective order (Shape's K = 0): the chunk kernel sums one chunk a
// thread from the identity with the complete mixed add (field.cuh
// add_affine, 11 products where 3b is small) into projective partials;
// the fold's lanes start from their first partial (a point of a cold
// bucket as (x, y, 1)) and add the rest, then the tree, with the complete
// projective add; no normal-form launch. Two launches. BN254's G1 takes
// this order, at T = kernels.K2_CHUNK: in the affine order it was slower
// at every shape measured, whatever K (PERF.md).
//
// What bounds it, and the design. The work is the additions the data
// needs, at batch-affine's six products each (portbench/peaks.py prices
// them so; 18 for G2) plus a lane's inversion over its K members, and
// the fold's mixed adds (11 or 13 products, 33 or 39 for G2) over about W
// n / T partials: operations. The parent's design paid RCB15's 11 products
// a point on projective X, Y, Z, at 180 registers (8 warps an SM) for the
// 24-limb G1 build; here a lane keeps its members' sums, points and
// running products in local memory (coalesced: lane t's words sit beside
// lane t + 1's) and holds one member at a time in registers, and the
// inversion costs no more than a few products a member once shared by K.
// A lane's points are read where they lie, T slots apart from its
// neighbours'. Where 3b is a small integer (G1 of both curves, BLS12-381's
// G2) the fold's two products an add with it are additions (field.cuh
// SmallB3).

#include <cuda_runtime.h>

#include "bucket_chunks.cuh"

// One library per limb count (ZK_NL = 16: BN254, 24: BLS12-381), built in
// parallel: the fully unrolled Fq2 variants dominate the build time.
#ifndef ZK_NL
#define ZK_NL 16
#endif

namespace {

// Threads a block, chunks a lane sums at once (K; 0: the projective
// order) and blocks an SM should hold (MINB, a register cap), per group.
// BN254's G1 (8-word products) sums in the projective order: in the affine
// one it was slower at every shape measured, K = 16 or smaller (PERF.md).
// The 24-limb G1 build holds 3 blocks of 128: its fold then fits 168
// registers (80 B spilled) in place of 197 and runs about a fifth faster,
// the chunk kernel unchanged at 160 (scripts/k2_chunk_sweep.py).
template <class F>
struct Shape;
template <int NW>
struct Shape<zk::Fp<NW>> {
  static constexpr int BT = 128, K = NW == 8 ? 0 : 16, MINB = NW == 12 ? 3 : 1;
};
template <int NW>
struct Shape<zk::Fp2<NW>> {
  static constexpr int BT = 64, K = 16, MINB = 1;
};

}  // namespace

extern "C" {

// See the header comment for the layouts and bucket_chunks.cuh's launch
// for the constants. W B2 < 2^31 and 1 <= cap < 2^31.
int zk_bucket_accumulate(const void* pts, const void* starts, const void* lens,
                         const void* coff, void* part, void* out, int nl, int group, int W,
                         int B2, long long n, long long cap, int T, const uint32_t* p,
                         uint32_t pinv, const uint32_t* one, const uint32_t* r3,
                         const uint32_t* b3, int b3k, void* exc, void* stream) {
  if (nl != ZK_NL || cap < 1 || cap >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return zk::bucket::launch<ZK_NL / 2, zk::bucket::CiosProduct, Shape>(
      pts, starts, lens, coff, part, out, group, W, B2, n, cap, T, p, pinv, one, r3, b3, b3k,
      exc, nullptr, (cudaStream_t)stream);
}

// Shape's K of the group's build (1: G1, 2: G2; -1 for another).
int zk_bucket_members(int group) { return zk::bucket::members<ZK_NL / 2, Shape>(group); }

}  // extern "C"
