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
