// K2: Pippenger bucket accumulation for every window of one MSM, as chunked
// runs and a fixed fold.
//
// Replaces zksnake_tpu/backend/pallas_field.py::bucket_accumulate_pallas.
// The Pallas kernel streamed a padded round-major table through R grid steps
// of one masked mixed add over all B bucket lanes (Mosaic's grid is fixed, so
// the table, its gather, the static round budget and a remainder loop existed
// to fit it). Here the sorted runs are read where they lie.
//
// Input  pts:    (L, nl, W, n) int32 planes, L = 2 (G1: X, Y) or 4 (G2: X.a,
//                X.b, Y.a, Y.b); row w holds the n points sorted by window w's
//                |digit|, with Y already negated for negative digits.
//        starts, lens: (W, B2) int32, the run of |digit| = b + 1 in row w.
//        coff:   (W B2,) int64, the inclusive prefix sum over the buckets (in
//                (w, b) order) of ceil(len / T): the chunk table.
// Scratch part:  (3 or 6, nl, cap) chunk partial sums, cap = kernels.
//                chunk_scratch(W, B2, n) = max(1, (W n + (T - 1) W B2) / T):
//                every chunk where each window's runs total at most n points
//                (sort_by_digit's do). Runs that overlap may have more; a
//                bucket with a chunk past cap is folded from its points
//                (bucket_chunks.cuh, the fold's cold instance), so the
//                kernel computes the same function of any runs and the
//                host never waits for coff[-1].
// Output out:    (3 or 6, nl, W, B2) projective bucket sums X, Y, Z (leaves in
//                the same order as the input's), identity (0 : 1 : 0) for an
//                empty run.
//
// The order, fixed. The kernels are bucket_chunks.cuh's on the CIOS product
// (K2m runs the same ones on its tensor-core product). Every run is cut
// into chunks of T consecutive points from its start, the last one
// shorter: ceil(len / T) chunks, chunk k holding ranks kT .. min(len,
// (k + 1) T) - 1. Chunks are numbered bucket by bucket in (w, b) order, so
// chunk g belongs to the first bucket with coff[b] > g, and its points lie
// in slot order.
//  1. chunk_kernel: one thread sums one chunk from the identity, in rank
//     order, with the complete mixed add (field.cuh add_affine); for a
//     bucket with a chunk past the scratch, the fold's cold instance sums
//     its chunks the same way.
//  2. fold_kernel: G neighbouring lanes a bucket of m
//     chunks. Lane j folds chunks j s .. min(m, (j + 1) s) - 1, s =
//     ceil(m / G), from left to right; then for d = 1, 2, .., G / 2 lane j
//     (j a multiple of 2d) adds lane j + d's sum if that lane had chunks
//     (shuffles), with the complete projective add (field.cuh add_proj,
//     GroupSpec.add's formula). No chunk: the identity; one chunk: its
//     partial, untouched.
// So a bucket whose run is at most T long comes out limb for limb as a
// rank-order walk of its run would give it, and every bucket is the same
// point as that walk's. kernels.bucket_accumulate_plain(..., chunk=T)
// follows these steps and equals the kernel limb for limb.
//
// What bounds it, and the design. The work is the mixed adds the data
// needs (13 CIOS products each, 39 for G2; 11 and 33 where 3b is a small
// integer, see below): operations. One thread per (window, bucket) walking
// its whole run gave 24 x 1024 threads at the prove shape, about 1.5 warps
// an SM, each waiting on scattered loads and on the longest run of its
// warp. Chunks give about W n / T threads (400k at the prove shape with
// T = 8), a warp waits on at most T adds, and the card fills to what the
// registers allow. The fold is latency-bound (one chain of adds a bucket),
// so its G lanes cut a bucket's chain from m - 1 adds to about m / G +
// log2 G; T and G are the fastest pair measured on the H100
// (scripts/k2_chunk_sweep.py). Where 3b is a small integer (G1 of both
// curves, BLS12-381's G2) its two products an add are additions (field.cuh
// SmallB3).
//
// The points' loads. A lane reads its own chunk's points: at every step a
// warp's 32 points lie about T slots apart, so one step's points are not a
// contiguous range, and a contiguous, coalesced staging of a warp's whole
// slot range would hold T points a lane, beyond shared memory at the
// occupancy the registers allow; so no such staging is built. Where it
// measured faster (every build but BN254's G1, Shape below), a lane
// prefetches its next points, limb plane by limb plane, with 4-byte
// cp.async into its column of a ring of STAGES steps in shared memory
// ([step][plane][lane], so the adds read it without bank conflicts), while
// it adds the current step's point: the same scattered loads, issued ahead
// of their use.

#include <cuda_runtime.h>

#include "bucket_chunks.cuh"

// One library per limb count (ZK_NL = 16: BN254, 24: BLS12-381), built in
// parallel: the fully unrolled Fq2 variants dominate the build time.
#ifndef ZK_NL
#define ZK_NL 16
#endif

namespace {

// Threads a block and steps of the prefetch ring (0: no ring), per group.
// BN254's G1 reads its points straight from device memory: with the ring
// its chunk kernel took 4% longer (121 against 108 registers, 4 blocks an
// SM either way), while the ring cut the other three builds' by 8-16%
// (scripts/k2_chunk_sweep.py). A ring of 3 steps is 48 KB a block for
// BN254's G2 (4 blocks an SM at 255 registers) and 72 KB for BLS12-381's
// G1 (2 blocks at 180); its G2 takes 2 steps (48 KB) to keep 4 blocks.
template <class F>
struct Shape;
template <int NW>
struct Shape<zk::Fp<NW>> {
  static constexpr int BT = 128, STAGES = NW == 8 ? 0 : 3;
};
template <int NW>
struct Shape<zk::Fp2<NW>> {
  static constexpr int BT = 64, STAGES = NW == 8 ? 3 : 2;
};

}  // namespace

extern "C" {

// See the header comment for the layouts and bucket_chunks.cuh's launch
// for the constants. W B2 < 2^31 and 1 <= cap < 2^31.
int zk_bucket_accumulate(const void* pts, const void* starts, const void* lens,
                         const void* coff, void* part, void* out, int nl, int group, int W,
                         int B2, long long n, long long cap, const uint32_t* p, uint32_t pinv,
                         const uint32_t* one, const uint32_t* b3, int b3k, void* stream) {
  if (nl != ZK_NL || cap < 1 || cap >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return zk::bucket::launch<ZK_NL / 2, zk::bucket::CiosProduct, Shape>(
      pts, starts, lens, coff, part, out, group, W, B2, n, cap, p, pinv, one, b3, b3k, nullptr,
      (cudaStream_t)stream);
}

}  // extern "C"
