// A warp-collective Montgomery product with both reduction products on the
// tensor cores, every operand in registers: K3's product (montmul_mma.cu),
// written so that any kernel whose warps each multiply 32 pairs can call it.
//
// The arithmetic is the SOS product of zksnake_tpu/backend/mxu_field.py
// (mont_mul_mxu_cols): T = a b; m = (T mod R) P' mod R and m p as exact
// integer products of T's and m's bytes with the constant byte-Toeplitz
// matrices PMAT (NB x NB) and PPMAT (2NB x NB) of kernels._reduction_mats,
// where NB = 4 NW bytes make an R-sized value; then (T + m p) / R, less p
// once if needed. The result is canonical, so it equals K1's limb for limb.
//
// Layout. The products are mma.sync m16n8k32 u8 x u8 -> s32, elements as A's
// rows and the constant matrix as B (B[i][k] = PMAT[k][i]: output byte k is
// B's column). A warp multiplies 32 elements at once, two m16 tiles. In the
// PTX ISA's fragment layout for this shape, lane (g = lane / 4, q = lane % 4)
// holds, of each m tile, bytes 4q..4q+3 and 16+4q..16+4q+3 of rows g and
// g + 8 (A, four 32-bit registers), bytes 4q..4q+3 and 16+4q..16+4q+3 of
// B's column g (two registers), and columns 2q, 2q+1 of rows g, g + 8 of C.
// Four consecutive bytes of a row are one little-endian 32-bit word of the
// element, so the A fragment of a k32 step is words q and q + 4 of the rows'
// elements: no byte packing. Each quad's four lanes own the quad's four rows
// (lane 4g + 2mt + h owns row g + 8h of m tile mt), and one 4 x 4 transpose
// inside the quad (three shuffles) moves four words between the owners and
// the fragment order. C's columns 2q and 2q+1 of an n8 tile, added as
// c0 + (c1 << 8), are 16-bit-aligned column pair 4nt + q of a row, so one
// transpose per n8 tile hands each owner four consecutive pairs of its own
// row, and its carry chain runs in its own registers. No shared memory and
// no barrier.
//
// Sums stay exact: a column is below 255^2 NB (3.2M at NB = 48), a pair
// below 2^30, and every carry chain runs in 32-bit words. BLS12-381's
// NB = 48 is padded to K = 64 (two k32 steps, the pad bytes zero). Tiles of
// B that hold no byte of the band (PMAT's above the diagonal, PPMAT's
// corners) are skipped: they hold no fragment in the table.
//
// The constant B fragments come from a table in fragment order
// (FieldSpec.mma_frags): fragment f of lane l is the uint2 at f * 32 + l,
// PMAT's live tiles first, then PPMAT's, each n8 tile's k32 steps in turn.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace zk {
namespace frag {

// Does k32 step ks of n8 tile nt hold a byte of the band? Entry (k, i) of
// PMAT or PPMAT is a byte of P' or p at k - i, non-zero only where
// 0 <= k - i < nb, i < nb. (kernels.mma_frag_tiles is the same test.)
__host__ __device__ constexpr bool live(int nb, int nt, int ks) {
  return 32 * ks < nb && 32 * ks <= 8 * nt + 7 &&
         8 * nt - (32 * ks + 31 < nb - 1 ? 32 * ks + 31 : nb - 1) < nb;
}

__host__ __device__ constexpr int live_tiles(int nb, int ntiles) {
  int c = 0;
  for (int nt = 0; nt < ntiles; ++nt)
    for (int ks = 0; ks < (nb + 31) / 32; ++ks) c += live(nb, nt, ks) ? 1 : 0;
  return c;
}

template <int NW>
struct Shape {
  static constexpr int NB = 4 * NW;              // bytes of an R-sized value
  static constexpr int KS = (NB + 31) / 32;      // k32 steps
  static constexpr int NT1 = NB / 8;             // n8 tiles of m_conv
  static constexpr int NT2 = 2 * NB / 8;         // n8 tiles of m p
  static constexpr int NF1 = live_tiles(NB, NT1);
  static constexpr int NF = NF1 + live_tiles(NB, NT2);  // BN254 12, BLS12-381 26
};

// The table's fragments held in registers: loaded once by each lane.
template <int NW>
struct RegFrags {
  uint2 f[Shape<NW>::NF];
  __device__ __forceinline__ void load(const uint2* __restrict__ tab, int lane) {
#pragma unroll
    for (int i = 0; i < Shape<NW>::NF; ++i) f[i] = __ldg(tab + i * 32 + lane);
  }
  __device__ __forceinline__ uint2 operator[](int i) const { return f[i]; }
};

__device__ __forceinline__ void mma_u8(uint32_t (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Lane 4g + q holds x[0..3]; afterwards y[i] is x[q] of lane 4g + i (a 4 x 4
// transpose inside every quad: three shuffles, the selects follow q).
__device__ __forceinline__ void quad_transpose(const uint32_t (&x)[4], uint32_t (&y)[4], int q) {
  const bool s0 = q & 1, s1 = (q >> 1) & 1;
  uint32_t v[4];  // v[r]: x[q] of lane q ^ r
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool c0 = s0 ^ (r & 1), c1 = s1 ^ (r >> 1);
    const uint32_t send = c1 ? (c0 ? x[3] : x[2]) : (c0 ? x[1] : x[0]);  // x[q ^ r]
    v[r] = r ? __shfl_xor_sync(0xffffffffu, send, r) : send;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool c0 = s0 ^ (i & 1), c1 = s1 ^ (i >> 1);
    y[i] = c1 ? (c0 ? v[3] : v[2]) : (c0 ? v[1] : v[0]);  // v[i ^ q]
  }
}

// The A fragments a[mt][ks][.] of every owner's NW words w (the pad past NW
// zero): register 2 half + h is row g + 8 h, bytes 16 half + 4q.. of k32
// step ks, i.e. word 8 ks + 4 half + q of the element of lane 4g + 2mt + h.
template <int NW>
__device__ __forceinline__ void to_frags(const uint32_t (&w)[NW],
                                         uint32_t (&a)[2][Shape<NW>::KS][4], int q) {
#pragma unroll
  for (int ks = 0; ks < Shape<NW>::KS; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int base = 8 * ks + 4 * half;
      uint32_t x[4], y[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = base + j < NW ? w[base + j] : 0u;
      if (base < NW) quad_transpose(x, y, q);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][ks][2 * half] = y[2 * mt];
        a[mt][ks][2 * half + 1] = y[2 * mt + 1];
      }
    }
  }
}

// n8 tile nt of one product over its live k32 steps (fragments from f on;
// f advances past them), then on each owner its row's column pairs
// 4nt..4nt+3 (pair j = column 2j + (column 2j + 1) << 8).
template <int NW>
__device__ __forceinline__ void tile_pairs(const uint32_t (&a)[2][Shape<NW>::KS][4],
                                           const RegFrags<NW>& bf, int& f, int nt, int q,
                                           uint32_t (&pairs)[4]) {
  uint32_t acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
  for (int ks = 0; ks < Shape<NW>::KS; ++ks) {
    if (live(Shape<NW>::NB, nt, ks)) {
      const uint2 b = bf[f++];
      mma_u8(acc[0], a[0][ks], b);
      mma_u8(acc[1], a[1][ks], b);
    }
  }
  const uint32_t x[4] = {acc[0][0] + (acc[0][1] << 8), acc[0][2] + (acc[0][3] << 8),
                         acc[1][0] + (acc[1][1] << 8), acc[1][2] + (acc[1][3] << 8)};
  quad_transpose(x, pairs, q);
}

// x y R^-1 mod p, canonical, for every lane's own (x, y). Warp-collective:
// all 32 lanes of the warp call it together (a lane with nothing to multiply
// passes zeros). bf: the table's fragments.
template <int NW>
__device__ __forceinline__ Fp<NW> mont_mul(const Fp<NW>& x, const Fp<NW>& y,
                                           const RegFrags<NW>& bf, const FieldParams<NW>& P,
                                           int lane) {
  using S = Shape<NW>;
  const int q = lane & 3;
  // T = x y, 2 NW words
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

  uint32_t a[2][S::KS][4];
  uint32_t w[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = T[j];
  to_frags<NW>(w, a, q);

  // m = m_conv mod R, 16 bits a pair (the carry out of the top is dropped)
  int f = 0;
  uint32_t c = 0;
#pragma unroll
  for (int nt = 0; nt < S::NT1; ++nt) {
    uint32_t pairs[4];
    tile_pairs<NW>(a, bf, f, nt, q, pairs);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const uint32_t lo = pairs[i] + c;
      const uint32_t hi = pairs[i + 1] + (lo >> 16);
      w[2 * nt + i / 2] = (lo & 0xFFFFu) | (hi << 16);
      c = hi >> 16;
    }
  }
  to_frags<NW>(w, a, q);

  // (T + m p) / R: the low NW words come out zero, only their carry is kept
  uint32_t r[NW];
  c = 0;
#pragma unroll
  for (int nt = 0; nt < S::NT2; ++nt) {
    uint32_t pairs[4];
    tile_pairs<NW>(a, bf, f, nt, q, pairs);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int word = 2 * nt + i / 2;
      const uint32_t lo = (T[word] & 0xFFFFu) + pairs[i] + c;
      const uint32_t hi = (T[word] >> 16) + pairs[i + 1] + (lo >> 16);
      c = hi >> 16;
      if (word >= NW) r[word - NW] = (lo & 0xFFFFu) | (hi << 16);
    }
  }
  return cond_sub_p<NW>(r, c, P);
}

}  // namespace frag
}  // namespace zk
