// Montgomery field and curve arithmetic shared by the montmul (K1),
// bucket (K2), montmul_mma (K3), bucket_mma (K2m) and bucket_reduce (K4)
// kernels.
//
// Device tensors hold 16-bit limbs in int32 lanes, limbs-first (nl, N), as
// zksnake_tpu.backend.field does. Inside a thread two limbs are paired into
// one 32-bit word, so a BN254 element is NW = 8 words and a BLS12-381 Fq
// element NW = 12. R = 2^(16 nl) = 2^(32 NW): the Montgomery integers are the
// same as the 16-bit CIOS of the JAX package, and every result is canonical
// (< p), so kernels and the plain PyTorch versions agree limb for limb.
//
// The product is CIOS on 32-bit words with 64-bit accumulators
// (field.py::_mont_mul_cpu64 is the same loop), pinv = -p^-1 mod 2^32.
#pragma once

#include <cstdint>

namespace zk {

template <int NW>
struct FieldParams {
  uint32_t p[NW];
  uint32_t pinv;      // -p^-1 mod 2^32
  uint32_t one[NW];   // R mod p, the Montgomery form of 1
};

template <int NW>
struct Fp {
  uint32_t c[NW];
};

template <int NW>
struct Fp2 {
  Fp<NW> a, b;  // a + b u, u^2 = -1
};

// ---------------------------------------------------------------- Fp ------

// t[0..NW] < 2p -> t mod p.
template <int NW>
__device__ __forceinline__ Fp<NW> cond_sub_p(const uint32_t* t, uint32_t top,
                                              const FieldParams<NW>& P) {
  Fp<NW> d;
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)t[j] - P.p[j] - br;
    d.c[j] = (uint32_t)v;
    br = (uint32_t)(v >> 63);
  }
  const bool ge = top != 0 || br == 0;
  Fp<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.c[j] = ge ? d.c[j] : t[j];
  return r;
}

template <int NW>
__device__ __forceinline__ Fp<NW> fmul(const Fp<NW>& a, const Fp<NW>& b,
                                       const FieldParams<NW>& P) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t cs = (uint64_t)t[j] + (uint64_t)a.c[i] * b.c[j] + c;
      t[j] = (uint32_t)cs;
      c = cs >> 32;
    }
    uint64_t cs = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)cs;
    t[NW + 1] = (uint32_t)(cs >> 32);
    const uint32_t m = t[0] * P.pinv;
    cs = (uint64_t)t[0] + (uint64_t)m * P.p[0];
    c = cs >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      cs = (uint64_t)t[j] + (uint64_t)m * P.p[j] + c;
      t[j - 1] = (uint32_t)cs;
      c = cs >> 32;
    }
    cs = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)cs;
    t[NW] = t[NW + 1] + (uint32_t)(cs >> 32);
  }
  return cond_sub_p<NW>(t, t[NW], P);
}

template <int NW>
__device__ __forceinline__ Fp<NW> fadd(const Fp<NW>& a, const Fp<NW>& b,
                                       const FieldParams<NW>& P) {
  uint32_t t[NW];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)a.c[j] + b.c[j] + c;
    t[j] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  return cond_sub_p<NW>(t, c, P);
}

template <int NW>
__device__ __forceinline__ Fp<NW> fsub(const Fp<NW>& a, const Fp<NW>& b,
                                       const FieldParams<NW>& P) {
  Fp<NW> d;
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)a.c[j] - b.c[j] - br;
    d.c[j] = (uint32_t)v;
    br = (uint32_t)(v >> 63);
  }
  // borrowed past the top word: add p back (the carry out is dropped)
  const uint32_t mask = 0u - br;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)d.c[j] + (P.p[j] & mask) + c;
    d.c[j] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  return d;
}

template <int NW>
__device__ __forceinline__ Fp<NW> fzero() {
  Fp<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.c[j] = 0;
  return r;
}

template <int NW>
__device__ __forceinline__ bool feq(const Fp<NW>& a, const Fp<NW>& b) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) d |= a.c[j] ^ b.c[j];
  return d == 0;
}

// --------------------------------------------------------------- Fp2 ------
// Karatsuba, as zksnake_tpu.backend.curve_ops.DevFq2.mul_many.

// A base-field product: CIOS (fmul above); K2m passes its tensor-core
// product instead. mul(a, b) -> Fp<NW>.
template <int NW>
struct CiosMul {
  const FieldParams<NW>& P;
  __device__ __forceinline__ Fp<NW> operator()(const Fp<NW>& a, const Fp<NW>& b) const {
    return fmul(a, b, P);
  }
};

template <int NW, class M>
__device__ __forceinline__ Fp<NW> fmul_with(const Fp<NW>& a, const Fp<NW>& b,
                                            const FieldParams<NW>&, const M& mul) {
  return mul(a, b);
}

template <int NW, class M>
__device__ __forceinline__ Fp2<NW> fmul_with(const Fp2<NW>& x, const Fp2<NW>& y,
                                             const FieldParams<NW>& P, const M& mul) {
  const Fp<NW> t0 = mul(x.a, y.a);
  const Fp<NW> t1 = mul(x.b, y.b);
  const Fp<NW> t2 = mul(fadd(x.a, x.b, P), fadd(y.a, y.b, P));
  Fp2<NW> r;
  r.a = fsub(t0, t1, P);
  r.b = fsub(fsub(t2, t0, P), t1, P);
  return r;
}

template <int NW>
__device__ __forceinline__ Fp2<NW> fadd(const Fp2<NW>& x, const Fp2<NW>& y,
                                        const FieldParams<NW>& P) {
  Fp2<NW> r;
  r.a = fadd(x.a, y.a, P);
  r.b = fadd(x.b, y.b, P);
  return r;
}

template <int NW>
__device__ __forceinline__ Fp2<NW> fsub(const Fp2<NW>& x, const Fp2<NW>& y,
                                        const FieldParams<NW>& P) {
  Fp2<NW> r;
  r.a = fsub(x.a, y.a, P);
  r.b = fsub(x.b, y.b, P);
  return r;
}

template <int NW>
__device__ __forceinline__ bool feq(const Fp2<NW>& x, const Fp2<NW>& y) {
  return feq(x.a, y.a) & feq(x.b, y.b);
}

// 3b as a small integer K (G1: 3b = K; G2: 3b = K + K u). A product with
// it is doublings and additions: the same field element as the product
// with 3b in Montgomery form, for a fraction of a product's work.
template <int K>
struct SmallB3 {};

__host__ __device__ constexpr int top_bit(int k) { return k > 1 ? 1 + top_bit(k >> 1) : 0; }

template <int K, int NW>
__device__ __forceinline__ Fp<NW> fmul_small(const Fp<NW>& x, const FieldParams<NW>& P) {
  static_assert(K > 0, "a positive multiplier");
  Fp<NW> r = x;
#pragma unroll
  for (int bit = top_bit(K) - 1; bit >= 0; --bit) {
    r = fadd(r, r, P);
    if ((K >> bit) & 1) r = fadd(r, x, P);
  }
  return r;
}

template <int NW, class M, int K>
__device__ __forceinline__ Fp<NW> fmul_with(const SmallB3<K>&, const Fp<NW>& x,
                                            const FieldParams<NW>& P, const M&) {
  return fmul_small<K>(x, P);
}

// (K + K u)(a + b u) = K (a - b) + K (a + b) u
template <int NW, class M, int K>
__device__ __forceinline__ Fp2<NW> fmul_with(const SmallB3<K>&, const Fp2<NW>& x,
                                             const FieldParams<NW>& P, const M&) {
  Fp2<NW> r;
  r.a = fmul_small<K>(fsub(x.a, x.b, P), P);
  r.b = fmul_small<K>(fadd(x.a, x.b, P), P);
  return r;
}

// 3b of each group as a small integer where it is one (SmallB3), else 0 (a
// product with 3b): BN254 (NW = 8) 3b = 9, and 3b' = 3 / (9 + u) is none;
// BLS12-381 (NW = 12) 3b = 12 and 3b' = 12 + 12 u.
template <int NW>
struct SmallB3Of {
  static constexpr int G1 = NW == 12 ? 12 : 9, G2 = NW == 12 ? 12 : 0;
};

// ---------------------------------------------------------- inversion ---
// a^-1 mod p by Bernstein and Yang's safegcd (ePrint 2019/266) on signed
// 30-bit limbs: the constant-time batches of 30 half-delta divsteps of
// libsecp256k1's modinv32 (its divsteps_30, update_de_30, update_fg_30 and
// normalize_30, for N = ceil(32 NW / 30) limbs: 9 for BN254, 13 for
// BLS12-381), repeated until g = 0, so every lane of a warp runs its warp's
// longest count. No product: divsteps are shifts, adds and selects, and a
// batch's updates 4 N + 2 N 32 x 32-bit products. Then one Montgomery
// product with R^3 mod p turns (a R)^-1 into the Montgomery form of a^-1.

template <int NW>
struct InvParams {
  static constexpr int N = (32 * NW + 29) / 30;
  int32_t m[N];      // p in 30-bit limbs
  uint32_t minv30;   // p^-1 mod 2^30
  Fp<NW> r3;         // R^3 mod p
};

struct Divsteps {
  int32_t u, v, q, r;  // the transition matrix, scaled by 2^30
};

constexpr int32_t kM30 = 0x3FFFFFFF;

__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f, uint32_t g,
                                               Divsteps& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);  // zeta < 0
    const uint32_t c2 = 0u - (g & 1);            // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    const uint32_t c3 = c1 & c2;
    zeta = (zeta ^ (int32_t)c3) - 1;
    f += g & c3;
    u += q & c3;
    v += r & c3;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = Divsteps{(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// [d, e] = t [d, e] / 2^30 mod p, in (-2p, p) on both sides
template <int N>
__device__ __forceinline__ void update_de(int32_t (&d)[N], int32_t (&e)[N], const Divsteps& t,
                                          const int32_t (&m)[N], uint32_t minv30) {
  const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
  const int32_t sd = d[N - 1] >> 31, se = e[N - 1] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((minv30 * (uint32_t)cd + (uint32_t)md) & kM30);
  me -= (int32_t)((minv30 * (uint32_t)ce + (uint32_t)me) & kM30);
  cd = (cd + (int64_t)m[0] * md) >> 30;
  ce = (ce + (int64_t)m[0] * me) >> 30;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)m[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)m[i] * me;
    d[i - 1] = (int32_t)cd & kM30;
    cd >>= 30;
    e[i - 1] = (int32_t)ce & kM30;
    ce >>= 30;
  }
  d[N - 1] = (int32_t)cd;
  e[N - 1] = (int32_t)ce;
}

// [f, g] = t [f, g] / 2^30, exactly
template <int N>
__device__ __forceinline__ void update_fg(int32_t (&f)[N], int32_t (&g)[N], const Divsteps& t) {
  const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
  int64_t cf = ((int64_t)u * f[0] + (int64_t)v * g[0]) >> 30;
  int64_t cg = ((int64_t)q * f[0] + (int64_t)r * g[0]) >> 30;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    f[i - 1] = (int32_t)cf & kM30;
    cf >>= 30;
    g[i - 1] = (int32_t)cg & kM30;
    cg >>= 30;
  }
  f[N - 1] = (int32_t)cf;
  g[N - 1] = (int32_t)cg;
}

// r in (-2p, p), negated where sign < 0 -> [0, p)
template <int N>
__device__ __forceinline__ void normalize_s30(int32_t (&r)[N], int32_t sign,
                                              const int32_t (&m)[N]) {
  const int32_t neg = sign >> 31;
  int32_t add = r[N - 1] >> 31;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = ((r[i] + (m[i] & add)) ^ neg) - neg;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    r[i] += r[i - 1] >> 30;
    r[i - 1] &= kM30;
  }
  add = r[N - 1] >> 31;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] += m[i] & add;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    r[i] += r[i - 1] >> 30;
    r[i - 1] &= kM30;
  }
}

// a (< p) as 30-bit limbs, and back (even bit offsets: two limbs a word)
template <int NW, int N>
__device__ __forceinline__ void to_s30(const Fp<NW>& a, int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int w = 30 * i / 32, s = 30 * i % 32;
    uint32_t x = a.c[w] >> s;
    if (s > 2 && w + 1 < NW) x |= a.c[w + 1] << (32 - s);
    r[i] = (int32_t)(x & kM30);
  }
}
template <int NW, int N>
__device__ __forceinline__ Fp<NW> from_s30(const int32_t (&r)[N]) {
  Fp<NW> a;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int i = 32 * w / 30, s = 32 * w % 30;
    uint32_t x = (uint32_t)r[i] >> s;
    if (i + 1 < N) x |= (uint32_t)r[i + 1] << (30 - s);
    a.c[w] = x;
  }
  return a;
}

// a^-1 mod p of a canonical a as an integer (0 -> 0); out of line: one call
// a step of many products
template <int NW>
__device__ __noinline__ Fp<NW> inv_int(const Fp<NW> a, const InvParams<NW> I) {
  constexpr int N = InvParams<NW>::N;
  int32_t d[N], e[N], f[N], g[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = 0;
    e[i] = 0;
    f[i] = I.m[i];
  }
  e[0] = 1;
  to_s30<NW, N>(a, g);
  int32_t zeta = -1;  // -(delta + 1/2), delta = 1/2
  // safegcd needs fewer than (49 d + 57) / 17 divsteps for d-bit inputs
  constexpr int kMaxBatches = ((49 * 32 * NW + 57) / 17 + 29) / 30 + 1;
  for (int it = 0; it < kMaxBatches; ++it) {
    int32_t live = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) live |= g[i];
    if (live == 0) break;
    Divsteps t;
    zeta = divsteps_30(zeta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de<N>(d, e, t, I.m, I.minv30);
    update_fg<N>(f, g, t);
  }
  normalize_s30<N>(d, f[N - 1], I.m);  // f = +-1
  return from_s30<NW, N>(d);
}

// The Montgomery form of a^-1 from that of a (a != 0): inv_int, then one
// product with R^3. Fp2: conj(x) / (x.a^2 + x.b^2). SYNC: the product is
// collective over the warp, so the lanes meet again after inv_int's loop.
template <bool SYNC, int NW, class M>
__device__ __forceinline__ Fp<NW> finv_with(const Fp<NW>& x, const FieldParams<NW>&,
                                            const InvParams<NW>& I, const M& mul) {
  const Fp<NW> r = inv_int<NW>(x, I);
  if constexpr (SYNC) __syncwarp();
  return mul(r, I.r3);
}
template <bool SYNC, int NW, class M>
__device__ __forceinline__ Fp2<NW> finv_with(const Fp2<NW>& x, const FieldParams<NW>& P,
                                             const InvParams<NW>& I, const M& mul) {
  const Fp<NW> ni = finv_with<SYNC>(fadd(mul(x.a, x.a), mul(x.b, x.b), P), P, I, mul);
  Fp2<NW> r;
  r.a = mul(x.a, ni);
  r.b = mul(fsub(fzero<NW>(), x.b, P), ni);
  return r;
}

// ------------------------------------------------- limb-plane loads ------

// Element `idx` of a limbs-first plane with `stride` elements between limbs.
template <int NW>
__device__ __forceinline__ Fp<NW> load_limbs(const int32_t* plane, int64_t stride,
                                             int64_t idx) {
  Fp<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t lo = (uint32_t)plane[(2 * j) * stride + idx];
    const uint32_t hi = (uint32_t)plane[(2 * j + 1) * stride + idx];
    r.c[j] = lo | (hi << 16);
  }
  return r;
}

template <int NW>
__device__ __forceinline__ void store_limbs(int32_t* plane, int64_t stride,
                                            int64_t idx, const Fp<NW>& v) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    plane[(2 * j) * stride + idx] = (int32_t)(v.c[j] & 0xFFFFu);
    plane[(2 * j + 1) * stride + idx] = (int32_t)(v.c[j] >> 16);
  }
}

// ------------------------------------------------------ curve points ------

// Complete mixed addition, RCB15 Algorithm 8 with a = 0: (X1:Y1:Z1) += (X2, Y2)
// with Z2 = 1. The same formula as GroupSpec.add_affine, so every output
// coordinate is the same field element. (X2, Y2) must not be the identity.
// Every field product goes through `mul` (13 of them; the two with 3b are
// additions where b3 is a SmallB3).
template <class F, int NW, class M, class B>
__device__ __forceinline__ void add_affine_with(F& X1, F& Y1, F& Z1, const F& X2,
                                                const F& Y2, const B& b3,
                                                const FieldParams<NW>& P, const M& mul) {
  const F t0 = fmul_with(X1, X2, P, mul);
  const F t1 = fmul_with(Y1, Y2, P, mul);
  const F s3 = fmul_with(fadd(X1, Y1, P), fadd(X2, Y2, P), P, mul);
  const F y2z1 = fmul_with(Y2, Z1, P, mul);
  const F x2z1 = fmul_with(X2, Z1, P, mul);
  const F t3 = fsub(s3, fadd(t0, t1, P), P);  // X1 Y2 + X2 Y1
  const F t4 = fadd(y2z1, Y1, P);             // Y1 + Y2 Z1
  const F t5 = fadd(x2z1, X1, P);             // X1 + X2 Z1
  const F t0_3 = fadd(fadd(t0, t0, P), t0, P);
  const F t2b = fmul_with(b3, Z1, P, mul);
  const F y3p = fmul_with(b3, t5, P, mul);
  const F z3s = fadd(t1, t2b, P);
  const F t1m = fsub(t1, t2b, P);
  X1 = fsub(fmul_with(t3, t1m, P, mul), fmul_with(t4, y3p, P, mul), P);
  Y1 = fadd(fmul_with(y3p, t0_3, P, mul), fmul_with(t1m, z3s, P, mul), P);
  Z1 = fadd(fmul_with(z3s, t4, P, mul), fmul_with(t0_3, t3, P, mul), P);
}

template <class F, int NW, class B>
__device__ __forceinline__ void add_affine(F& X1, F& Y1, F& Z1, const F& X2,
                                           const F& Y2, const B& b3,
                                           const FieldParams<NW>& P) {
  add_affine_with<F, NW>(X1, Y1, Z1, X2, Y2, b3, P, CiosMul<NW>{P});
}

// Complete projective addition, RCB15 Algorithm 7 with a = 0:
// (X1:Y1:Z1) += (X2:Y2:Z2). The formula of GroupSpec.add, so every output
// coordinate is the same field element. Every field product goes through
// `mul` (14 of them; 12 where b3 is a SmallB3).
template <class F, int NW, class M, class B>
__device__ __forceinline__ void add_proj_with(F& X1, F& Y1, F& Z1, const F& X2, const F& Y2,
                                              const F& Z2, const B& b3,
                                              const FieldParams<NW>& P, const M& mul) {
  const F t0 = fmul_with(X1, X2, P, mul);
  const F t1 = fmul_with(Y1, Y2, P, mul);
  const F t2 = fmul_with(Z1, Z2, P, mul);
  const F t3 = fsub(fmul_with(fadd(X1, Y1, P), fadd(X2, Y2, P), P, mul), fadd(t0, t1, P), P);
  const F t4 = fsub(fmul_with(fadd(Y1, Z1, P), fadd(Y2, Z2, P), P, mul), fadd(t1, t2, P), P);
  const F t5 = fsub(fmul_with(fadd(X1, Z1, P), fadd(X2, Z2, P), P, mul), fadd(t0, t2, P), P);
  const F t0_3 = fadd(fadd(t0, t0, P), t0, P);
  const F t2b = fmul_with(b3, t2, P, mul);
  const F y3p = fmul_with(b3, t5, P, mul);
  const F z3s = fadd(t1, t2b, P);
  const F t1m = fsub(t1, t2b, P);
  X1 = fsub(fmul_with(t3, t1m, P, mul), fmul_with(t4, y3p, P, mul), P);
  Y1 = fadd(fmul_with(y3p, t0_3, P, mul), fmul_with(t1m, z3s, P, mul), P);
  Z1 = fadd(fmul_with(z3s, t4, P, mul), fmul_with(t0_3, t3, P, mul), P);
}

template <class F, int NW, class B>
__device__ __forceinline__ void add_proj(F& X1, F& Y1, F& Z1, const F& X2, const F& Y2,
                                         const F& Z2, const B& b3, const FieldParams<NW>& P) {
  add_proj_with<F, NW>(X1, Y1, Z1, X2, Y2, Z2, b3, P, CiosMul<NW>{P});
}

// ------------------------------------------------- bucket-kernel helpers --
// A coordinate's limb planes in K2's layouts: leaf l of a point (G1: X, Y,
// Z; G2: X.a, X.b, Y.a, ...) starts at base + l * nl * stride.

template <int NW>
__device__ __forceinline__ Fp<NW> load_leaf(const int32_t* base, int64_t leaf,
                                            int64_t stride, int64_t idx, Fp<NW>*) {
  return load_limbs<NW>(base + leaf * 2 * NW * stride, stride, idx);
}

template <int NW>
__device__ __forceinline__ Fp2<NW> load_leaf(const int32_t* base, int64_t leaf,
                                             int64_t stride, int64_t idx, Fp2<NW>*) {
  Fp2<NW> r;
  r.a = load_limbs<NW>(base + (2 * leaf) * 2 * NW * stride, stride, idx);
  r.b = load_limbs<NW>(base + (2 * leaf + 1) * 2 * NW * stride, stride, idx);
  return r;
}

template <int NW>
__device__ __forceinline__ void store_leaf(int32_t* base, int64_t leaf, int64_t stride,
                                           int64_t idx, const Fp<NW>& v) {
  store_limbs<NW>(base + leaf * 2 * NW * stride, stride, idx, v);
}

template <int NW>
__device__ __forceinline__ void store_leaf(int32_t* base, int64_t leaf, int64_t stride,
                                           int64_t idx, const Fp2<NW>& v) {
  store_limbs<NW>(base + (2 * leaf) * 2 * NW * stride, stride, idx, v.a);
  store_limbs<NW>(base + (2 * leaf + 1) * 2 * NW * stride, stride, idx, v.b);
}

template <int NW>
__device__ __forceinline__ void set_zero(Fp<NW>& v) { v = fzero<NW>(); }
template <int NW>
__device__ __forceinline__ void set_zero(Fp2<NW>& v) {
  v.a = fzero<NW>();
  v.b = fzero<NW>();
}
template <int NW>
__device__ __forceinline__ void set_one(Fp<NW>& v, const FieldParams<NW>& P) {
#pragma unroll
  for (int j = 0; j < NW; ++j) v.c[j] = P.one[j];
}
template <int NW>
__device__ __forceinline__ void set_one(Fp2<NW>& v, const FieldParams<NW>& P) {
  set_one<NW>(v.a, P);
  v.b = fzero<NW>();
}

// Host side: the field constants and 3b (nl/2 words, or nl for G2: real
// part then u part) of K2's and K2m's C interface as kernel parameters.
template <int NW>
inline FieldParams<NW> field_params(const uint32_t* p, uint32_t pinv, const uint32_t* one) {
  FieldParams<NW> P;
  for (int j = 0; j < NW; ++j) {
    P.p[j] = p[j];
    P.one[j] = one[j];
  }
  P.pinv = pinv;
  return P;
}

// The inversion's constants from p (NW words), pinv = -p^-1 mod 2^32 and
// R^3 mod p (NW words).
template <int NW>
inline InvParams<NW> inv_params(const uint32_t* p, uint32_t pinv, const uint32_t* r3) {
  InvParams<NW> I;
  constexpr int N = InvParams<NW>::N;
  for (int i = 0; i < N; ++i) {
    const int w = 30 * i / 32, s = 30 * i % 32;
    uint32_t x = p[w] >> s;
    if (s > 2 && w + 1 < NW) x |= p[w + 1] << (32 - s);
    I.m[i] = (int32_t)(x & kM30);
  }
  I.minv30 = (0u - pinv) & (uint32_t)kM30;
  for (int j = 0; j < NW; ++j) I.r3.c[j] = r3[j];
  return I;
}

template <int NW>
inline void load_b3(Fp<NW>& c, const uint32_t* b3) {
  for (int j = 0; j < NW; ++j) c.c[j] = b3[j];
}

template <int NW>
inline void load_b3(Fp2<NW>& c, const uint32_t* b3) {
  for (int j = 0; j < NW; ++j) {
    c.a.c[j] = b3[j];
    c.b.c[j] = b3[NW + j];
  }
}

}  // namespace zk
