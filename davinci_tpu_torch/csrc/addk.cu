// B8: the complete G1 addition (RCB15 Algorithm 7, a = 0) of BN254 in the
// four designs of the point-add experiment, one thread per point.  Built
// at L = 22 only: at L = 32 this file compiles to an empty library.
//
// Replaces the TPU kernel scripts/addk_exp.py::_add_2d and its variants:
//   v2d      _kernel_v2d: the strict formula, field constants compiled in
//            (B1 takes them as a Consts struct by value);
//   lazy     _kernel_lazy: products without the final conditional
//            subtract, adds without reduction, subtracts that add a
//            multiple of p, one canonicalisation at the end;
//   kara     _kernel_kara: Karatsuba on the 8-word a*b product (three
//            4x4-word products), then the same exact REDC by 2^264;
//   addonly  _kernel_addonly: the diagnostic, the experiment's 12-bit limb
//            dataflow with every limb product replaced by an add (not field
//            arithmetic), computed exactly on int32 12-bit limbs.
// v2d, lazy and kara return canonical Montgomery limbs, so they equal B1
// (csrc/point_add.cu) limb for limb.
//
// Boundary: the experiment's (L, n) layout, limb j of point i at j * n + i,
// int32 12-bit limbs in Montgomery form with R = 2^264.  Consecutive
// threads read and write consecutive words, so every access is coalesced:
// the card's counterpart of the experiment's batch-on-lanes tiles.
//
// Inside (v2d, lazy, kara) a field element is 8 32-bit words (field.cuh's
// Fp<22>), and the product is a CIOS over the 8 words followed by one
// 8-bit reduction step, exact REDC by 2^264, as in field.cuh, with BN254's
// p, -p^-1 mod 2^32 and 3b (Montgomery form) as literals.
//
// What bounds it on the card: a complete add moves 9 x 88 bytes and does
// 14 field products of about 145 32-bit multiplies; at 3.35 TB/s against
// 132 SMs x 64 multiplies per clock the bytes bound it, so the layout is
// coalesced, and the variants measure what the multiplies, the reductions
// and the product's algorithm cost on top.

#include <type_traits>

#include "field.cuh"

#if DAVINCI_L == 22

namespace {

constexpr int L = 22;  // 12-bit limbs
constexpr int N = 8;   // 32-bit words
using F = Fp<L>;

// -- BN254's base field, compiled in (tests/test_torch_addk.py holds these
//    literals against the curve's parameters) ---------------------------------

constexpr uint32_t NP0 = 0xe4866389u;  // -p^-1 mod 2^32

// word k of K p, K = 1, 2, 3
template <int K>
__device__ __forceinline__ uint32_t kp(int k) {
  static_assert(K >= 1 && K <= 3, "multiples of p");
  constexpr uint32_t w[3][N] = {
      {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
       0xb85045b6u, 0xe131a029u, 0x30644e72u},
      {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u, 0x0302b0bbu,
       0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
      {0x8976f7d5u, 0xb461a444u, 0x39555fa7u, 0xc6843fb4u, 0x84840918u,
       0x28f0d123u, 0xa394e07du, 0x912ceb58u}};
  return w[K - 1][k];
}

// 3b = 9 in Montgomery form, as words
__device__ __forceinline__ void set_b3(F& r) {
  constexpr uint32_t w[N] = {0x21559fbcu, 0x62727055u, 0x7678a3e5u,
                             0xea925d37u, 0x55f4f826u, 0xf2490302u,
                             0xa95abdbcu, 0x18791aa6u};
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = w[k];
}

// the same two constants as 12-bit limbs, for the addonly diagnostic
__device__ __forceinline__ int32_t p_limb(int j) {
  constexpr int32_t v[L] = {3399, 1999, 1752, 2241, 3104, 2259, 458, 1671,
                            2705, 2070, 3479, 1413, 385,  2920, 69,  2949,
                            41,   794,  737,  1255, 100,  3};
  return v[j];
}

__device__ __forceinline__ int32_t b3_limb(int j) {
  constexpr int32_t v[L] = {4028, 1369, 1313, 1797, 626,  3670, 2211, 1895,
                            3383, 2341, 1770, 3970, 1524, 37,   2307, 3876,
                            3516, 1451, 1705, 426,  2169, 1};
  return v[j];
}

// -- word arithmetic ------------------------------------------------------------

// a >= K p ? a - K p : a
template <int K>
__device__ __forceinline__ void sub_if_ge(F& a) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint64_t t = (uint64_t)a.w[k] - kp<K>(k) - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
#pragma unroll
  for (int k = 0; k < N; k++) a.w[k] = borrow ? a.w[k] : d[k];
}

// r = a + b without reduction: the caller keeps the sum below 2^256
__device__ __forceinline__ void add_raw(F& r, const F& a, const F& b) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint64_t t = (uint64_t)a.w[k] + b.w[k] + carry;
    r.w[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

// r = a - b + K p: the caller keeps b <= K p and a + K p below 2^256
template <int K>
__device__ __forceinline__ void sub_kp(F& r, const F& a, const F& b) {
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const int64_t t = (int64_t)a.w[k] + kp<K>(k) - (int64_t)b.w[k] + c;
    r.w[k] = (uint32_t)t;
    c = t >> 32;
  }
}

// The exact reduction by the radix's last 8 bits (R = 2^256 * 2^8) of a
// value t[0..N] of 9 words below 2^257: r = (t + m p) / 2^8 with
// m = t * -p^-1 mod 2^8.
__device__ __forceinline__ void redc8(F& r, uint32_t (&t)[N + 1]) {
  const uint32_t m = (t[0] * NP0) & 0xFFu;
  uint64_t C = 0;
#pragma unroll
  for (int j = 0; j < N; j++) {
    const uint64_t s = (uint64_t)m * kp<1>(j) + t[j] + C;
    t[j] = (uint32_t)s;
    C = s >> 32;
  }
  t[N] += (uint32_t)C;
#pragma unroll
  for (int j = 0; j < N; j++) r.w[j] = (t[j] >> 8) | (t[j + 1] << 24);
}

// r = a b / 2^264 mod p by CIOS over the words (field.cuh's mont_mul with
// the constants compiled in).  For any a, b below 2^256 every partial sum
// stays below a + p and r < a b / 2^264 + p; kCanon subtracts p once, for
// a b < p 2^264.  r may alias a or b.
template <bool kCanon>
__device__ __forceinline__ void mul_cios(F& r, const F& a, const F& b) {
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      const uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + C;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * NP0;
    s = (uint64_t)m * kp<1>(0) + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * kp<1>(j) + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    s = (uint64_t)t[N] + C;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  uint32_t u[N + 1];
#pragma unroll
  for (int k = 0; k <= N; k++) u[k] = t[k];
  redc8(r, u);
  if constexpr (kCanon) sub_if_ge<1>(r);
}

// r[0..7] = x y, 4 x 4 words, schoolbook
__device__ __forceinline__ void mul4(uint32_t (&r)[8], const uint32_t (&x)[4],
                                     const uint32_t (&y)[4]) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = 0;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const uint64_t s = (uint64_t)x[j] * y[i] + r[i + j] + C;
      r[i + j] = (uint32_t)s;
      C = s >> 32;
    }
    r[i + 4] = (uint32_t)C;
  }
}

// s = x + y over 4 words; returns the carry out (0 or 1)
__device__ __forceinline__ uint32_t add4(uint32_t (&s)[4],
                                         const uint32_t (&x)[4],
                                         const uint32_t (&y)[4]) {
  uint64_t C = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const uint64_t t = (uint64_t)x[k] + y[k] + C;
    s[k] = (uint32_t)t;
    C = t >> 32;
  }
  return (uint32_t)C;
}

// Karatsuba: with a = a0 + a1 2^128 and b likewise, a b = z0 + (z1 - z0 -
// z2) 2^128 + z2 2^256 where z0 = a0 b0, z2 = a1 b1 and z1 = (a0 + a1)(b0 +
// b1).  The half sums have 129 bits: z1 is the 4x4-word product of their
// low words plus the carry bits' cross terms, 9 words.  Then the exact REDC
// by 2^264: 8 word rounds over the 16-word product (below p^2 + 2^256 p <
// 2^511 throughout, so 16 words hold it), leaving a value below p^2 / 2^256
// + p < 2p, and the 8-bit step; a canonical result.
__device__ __forceinline__ void mul_kara(F& r, const F& a, const F& b) {
  uint32_t a0[4], a1[4], b0[4], b1[4], sa[4], sb[4];
  uint32_t z0[8], z1[8], z2[8], t[16];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    a0[k] = a.w[k];
    a1[k] = a.w[k + 4];
    b0[k] = b.w[k];
    b1[k] = b.w[k + 4];
  }
  const uint32_t ca = add4(sa, a0, a1);
  const uint32_t cb = add4(sb, b0, b1);
  mul4(z0, a0, b0);
  mul4(z2, a1, b1);
  mul4(z1, sa, sb);
  // z1 += (ca sb + cb sa) 2^128 + ca cb 2^256, 9 words
  uint32_t w9[9];
  uint64_t C = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    w9[k] = z1[k];
    const uint64_t s = (uint64_t)z1[k + 4] + (sb[k] & (0u - ca)) +
                       (sa[k] & (0u - cb)) + C;
    w9[k + 4] = (uint32_t)s;
    C = s >> 32;
  }
  w9[8] = (uint32_t)C + (ca & cb);
  // mid = z1 - z0 - z2 = a0 b1 + a1 b0, below 2^257
  uint32_t mid[9];
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int64_t s = (int64_t)w9[k] - (int64_t)z0[k] - (int64_t)z2[k] + c;
    mid[k] = (uint32_t)s;
    c = s >> 32;
  }
  mid[8] = w9[8] + (uint32_t)c;
  // t = z0 + mid 2^128 + z2 2^256, below 2^508
#pragma unroll
  for (int k = 0; k < 8; k++) {
    t[k] = z0[k];
    t[k + 8] = z2[k];
  }
  C = 0;
#pragma unroll
  for (int k = 0; k < 9; k++) {
    const uint64_t s = (uint64_t)t[k + 4] + mid[k] + C;
    t[k + 4] = (uint32_t)s;
    C = s >> 32;
  }
#pragma unroll
  for (int k = 13; k < 16; k++) {
    const uint64_t s = (uint64_t)t[k] + C;
    t[k] = (uint32_t)s;
    C = s >> 32;
  }
  // REDC: 8 word rounds, t += m p 2^(32 i)
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t m = t[i] * NP0;
    C = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      const uint64_t s = (uint64_t)m * kp<1>(j) + t[i + j] + C;
      t[i + j] = (uint32_t)s;
      C = s >> 32;
    }
#pragma unroll
    for (int k = i + N; k < 16; k++) {
      const uint64_t s = (uint64_t)t[k] + C;
      t[k] = (uint32_t)s;
      C = s >> 32;
    }
  }
  uint32_t u[N + 1];
#pragma unroll
  for (int k = 0; k < N; k++) u[k] = t[k + N];
  u[N] = 0;
  redc8(r, u);
  sub_if_ge<1>(r);
}

// -- the strict field (v2d, kara): every value canonical ------------------------

template <bool kKaratsuba>
struct Strict {
  using E = F;
  static __device__ __forceinline__ void mul(F& r, const F& a, const F& b) {
    if constexpr (kKaratsuba) {
      mul_kara(r, a, b);
    } else {
      mul_cios<true>(r, a, b);
    }
  }
  // a + b < 2p < 2^256: one conditional subtract
  static __device__ __forceinline__ void add(F& r, const F& a, const F& b) {
    add_raw(r, a, b);
    sub_if_ge<1>(r);
  }
  static __device__ __forceinline__ void sub(F& r, const F& a, const F& b) {
    sub_kp<1>(r, a, b);
    sub_if_ge<1>(r);
  }
  static __device__ __forceinline__ void b3(F& r) { set_b3(r); }
};

// -- the addonly diagnostic: the experiment's int32 12-bit limb dataflow ------
//
// The experiment's mul with every limb product u[i] * v[k - i] replaced by
// u[i] + v[k - i], where a compile-time constant right operand (n', p)
// contributes 1 instead of its limb; the constant b3 as left operand is its
// real limbs.  _ripple carries with an arithmetic shift and drops the last
// carry; every sum wraps as int32 (on 12-bit limb inputs no column comes
// near 2^31).  Not field arithmetic: its output is defined on 12-bit limbs
// only, and only its plain version (ec/addk_exp.py::addonly_plain) checks
// it.

struct Limbs {
  int32_t v[L];
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// cols[0..n) -> 12-bit limbs; returns the last carry
template <int M>
__device__ __forceinline__ int32_t ripple(int32_t (&c)[M]) {
  int32_t carry = 0;
#pragma unroll
  for (int k = 0; k < M; k++) {
    const int32_t v = wrap_add(c[k], carry);
    c[k] = v & 0xFFF;
    carry = v >> 12;
  }
  return carry;
}

// s >= p (the last ripple of s - p carries nothing) ? s - p : s
__device__ __forceinline__ void ao_csub(Limbs& r, const int32_t (&s)[L]) {
  int32_t d[L];
#pragma unroll
  for (int j = 0; j < L; j++) d[j] = wrap_sub(s[j], p_limb(j));
  const int32_t borrow = ripple(d);
#pragma unroll
  for (int j = 0; j < L; j++) r.v[j] = borrow != 0 ? s[j] : d[j];
}

struct AddOnly {
  using E = Limbs;
  static __device__ __forceinline__ void mul(Limbs& r, const Limbs& a,
                                             const Limbs& b) {
    int32_t t[2 * L];
#pragma unroll
    for (int k = 0; k < 2 * L; k++) {
      int32_t acc = 0;
#pragma unroll
      for (int i = (k - L + 1 > 0 ? k - L + 1 : 0); i < (k + 1 < L ? k + 1 : L);
           i++)
        acc = wrap_add(acc, wrap_add(a.v[i], b.v[k - i]));
      t[k] = acc;
    }
    ripple(t);
    int32_t m[L];  // "t * n'": the column sums of t[i] + 1
#pragma unroll
    for (int k = 0; k < L; k++) {
      int32_t acc = 0;
#pragma unroll
      for (int i = 0; i <= k; i++) acc = wrap_add(acc, wrap_add(t[i], 1));
      m[k] = acc;
    }
    ripple(m);
    int32_t s[2 * L];  // t + "m * p"
#pragma unroll
    for (int k = 0; k < 2 * L; k++) {
      int32_t acc = 0;
#pragma unroll
      for (int i = (k - L + 1 > 0 ? k - L + 1 : 0); i < (k + 1 < L ? k + 1 : L);
           i++)
        acc = wrap_add(acc, wrap_add(m[i], 1));
      s[k] = wrap_add(t[k], acc);
    }
    ripple(s);
    int32_t hi[L];
#pragma unroll
    for (int j = 0; j < L; j++) hi[j] = s[L + j];
    ao_csub(r, hi);
  }
  static __device__ __forceinline__ void add(Limbs& r, const Limbs& a,
                                             const Limbs& b) {
    int32_t s[L];
#pragma unroll
    for (int j = 0; j < L; j++) s[j] = wrap_add(a.v[j], b.v[j]);
    ripple(s);
    ao_csub(r, s);
  }
  static __device__ __forceinline__ void sub(Limbs& r, const Limbs& a,
                                             const Limbs& b) {
    int32_t s[L];
#pragma unroll
    for (int j = 0; j < L; j++)
      s[j] = wrap_add(wrap_sub(a.v[j], b.v[j]), p_limb(j));
    ripple(s);
    ao_csub(r, s);
  }
  static __device__ __forceinline__ void b3(Limbs& r) {
#pragma unroll
    for (int j = 0; j < L; j++) r.v[j] = b3_limb(j);
  }
};

// -- the formula ------------------------------------------------------------------

// RCB15 Algorithm 7 (a = 0) in the operation order of the experiment's
// _rcb15 (and field.cuh's rcb15), on the field Ops.
template <class Ops, class E = typename Ops::E>
__device__ __forceinline__ void rcb15(E& X3, E& Y3, E& Z3, const E& X1,
                                      const E& Y1, const E& Z1, const E& X2,
                                      const E& Y2, const E& Z2) {
  E t0, t1, t2, t3, t4, u, v, b3;
  Ops::b3(b3);
  Ops::mul(t0, X1, X2);
  Ops::mul(t1, Y1, Y2);
  Ops::mul(t2, Z1, Z2);
  Ops::add(u, X1, Y1);
  Ops::add(v, X2, Y2);
  Ops::mul(t3, u, v);
  Ops::add(u, t0, t1);
  Ops::sub(t3, t3, u);
  Ops::add(u, Y1, Z1);
  Ops::add(v, Y2, Z2);
  Ops::mul(t4, u, v);
  Ops::add(u, t1, t2);
  Ops::sub(t4, t4, u);
  Ops::add(u, X1, Z1);
  Ops::add(v, X2, Z2);
  Ops::mul(X3, u, v);
  Ops::add(u, t0, t2);
  Ops::sub(Y3, X3, u);
  Ops::add(X3, t0, t0);
  Ops::add(t0, X3, t0);
  Ops::mul(t2, b3, t2);
  Ops::add(Z3, t1, t2);
  Ops::sub(t1, t1, t2);
  Ops::mul(Y3, b3, Y3);
  Ops::mul(X3, t4, Y3);
  Ops::mul(t2, t3, t1);
  Ops::sub(X3, t2, X3);
  Ops::mul(Y3, Y3, t0);
  Ops::mul(t1, t1, Z3);
  Ops::add(Y3, t1, Y3);
  Ops::mul(t0, t0, t3);
  Ops::mul(Z3, Z3, t4);
  Ops::add(Z3, Z3, t0);
}

// The lazy formula.  Bounds, in multiples of p, for canonical inputs (each
// below p).  BN254's p is 0.18906 * 2^256, so a value fits the 8 words
// while below 5.2901 p, and a product's REDC input a b stays below p 2^264
// while a b < 1354 p^2.  mul_cios<false> returns r < a b / 2^264 + p =
// p (1 + alpha beta e) for a < alpha p, b < beta p, with e = p / 2^264 =
// 0.000738.  So every product here is below 1.01 p, where the experiment's
// bound is 2p (its 264-bit container of 12-bit limbs holds 5.29 * 2^8 p,
// where 8 words hold 5.29 p: with 2p products its t0 = 3 t0 and its
// "sub4" results would reach 6p and not fit).  A subtract a - b adds the
// least K p at or above b's bound; exact bounds in
// tests/test_torch_addk.py::test_lazy_bounds_fit_the_words.
//   t0, t1, t2 = X1 X2, Y1 Y2, Z1 Z2                 < 1.0008 p
//   t3 = (X1 + Y1)(X2 + Y2)  (inputs < 2p)          < 1.003 p
//   t3 = t3 - (t0 + t1) + 3p  (t0 + t1 < 2.0015 p)  < 4.003 p
//   t4, Y3 the same                                 < 4.003 p
//   t0 = 3 t0                                       < 3.003 p
//   t2 = b3 t2                                      < 1.0008 p
//   Z3 = t1 + t2                                    < 2.0015 p
//   t1 = t1 - t2 + 2p                               < 3.0008 p
//   Y3 = b3 Y3; X3 = t4 Y3                          < 1.003 p
//   t2 = t3 t1 (12.02 p^2)                          < 1.009 p
//   X3 = t2 - X3 + 2p                               < 3.009 p
//   Y3 = Y3 t0; t1 = t1 Z3                          < 1.005 p
//   Y3 = t1 + Y3                                    < 2.008 p
//   t0 = t0 t3 (12.02 p^2); Z3 = Z3 t4 (8.01 p^2)   < 1.009 p
//   Z3 = Z3 + t0                                    < 2.016 p
// Every value stays below 4.01 p < 2^256, every product's a b below 13 p^2;
// the end subtracts 2p where a value is at or above 2p, then p.
__device__ __forceinline__ void rcb15_lazy(F& X3, F& Y3, F& Z3, const F& X1,
                                           const F& Y1, const F& Z1,
                                           const F& X2, const F& Y2,
                                           const F& Z2) {
  F t0, t1, t2, t3, t4, u, v, b3;
  set_b3(b3);
  mul_cios<false>(t0, X1, X2);
  mul_cios<false>(t1, Y1, Y2);
  mul_cios<false>(t2, Z1, Z2);
  add_raw(u, X1, Y1);
  add_raw(v, X2, Y2);
  mul_cios<false>(t3, u, v);
  add_raw(u, t0, t1);
  sub_kp<3>(t3, t3, u);
  add_raw(u, Y1, Z1);
  add_raw(v, Y2, Z2);
  mul_cios<false>(t4, u, v);
  add_raw(u, t1, t2);
  sub_kp<3>(t4, t4, u);
  add_raw(u, X1, Z1);
  add_raw(v, X2, Z2);
  mul_cios<false>(X3, u, v);
  add_raw(u, t0, t2);
  sub_kp<3>(Y3, X3, u);
  add_raw(X3, t0, t0);
  add_raw(t0, X3, t0);
  mul_cios<false>(t2, b3, t2);
  add_raw(Z3, t1, t2);
  sub_kp<2>(t1, t1, t2);
  mul_cios<false>(Y3, b3, Y3);
  mul_cios<false>(X3, t4, Y3);
  mul_cios<false>(t2, t3, t1);
  sub_kp<2>(X3, t2, X3);
  mul_cios<false>(Y3, Y3, t0);
  mul_cios<false>(t1, t1, Z3);
  add_raw(Y3, t1, Y3);
  mul_cios<false>(t0, t0, t3);
  mul_cios<false>(Z3, Z3, t4);
  add_raw(Z3, Z3, t0);
  sub_if_ge<2>(X3);
  sub_if_ge<1>(X3);
  sub_if_ge<2>(Y3);
  sub_if_ge<1>(Y3);
  sub_if_ge<2>(Z3);
  sub_if_ge<1>(Z3);
}

// -- the kernels ----------------------------------------------------------------

__device__ __forceinline__ void load(Limbs& r, const int32_t* src,
                                     long long n) {
#pragma unroll
  for (int j = 0; j < L; j++) r.v[j] = src[j * n];
}

__device__ __forceinline__ void store(int32_t* dst, const Limbs& a,
                                      long long n) {
#pragma unroll
  for (int j = 0; j < L; j++) dst[j * n] = a.v[j];
}

enum Variant { kV2d, kLazy, kKara, kAddOnly };

template <Variant V>
__device__ __forceinline__ void addk(const int32_t* __restrict__ x1,
                                     const int32_t* __restrict__ y1,
                                     const int32_t* __restrict__ z1,
                                     const int32_t* __restrict__ x2,
                                     const int32_t* __restrict__ y2,
                                     const int32_t* __restrict__ z2,
                                     int32_t* __restrict__ x3,
                                     int32_t* __restrict__ y3,
                                     int32_t* __restrict__ z3, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  using E = std::conditional_t<V == kAddOnly, Limbs, F>;
  E X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3;
  load(X1, x1 + i, n);
  load(Y1, y1 + i, n);
  load(Z1, z1 + i, n);
  load(X2, x2 + i, n);
  load(Y2, y2 + i, n);
  load(Z2, z2 + i, n);
  if constexpr (V == kV2d) {
    rcb15<Strict<false>>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  } else if constexpr (V == kKara) {
    rcb15<Strict<true>>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  } else if constexpr (V == kLazy) {
    rcb15_lazy(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  } else {
    rcb15<AddOnly>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
  }
  store(x3 + i, X3, n);
  store(y3 + i, Y3, n);
  store(z3 + i, Z3, n);
}

// One entry function per variant, so that a profiler trace names each.
#define ADDK_KERNEL(name, V)                                                \
  __global__ void name(const int32_t* __restrict__ x1,                      \
                       const int32_t* __restrict__ y1,                      \
                       const int32_t* __restrict__ z1,                      \
                       const int32_t* __restrict__ x2,                      \
                       const int32_t* __restrict__ y2,                      \
                       const int32_t* __restrict__ z2,                      \
                       int32_t* __restrict__ x3, int32_t* __restrict__ y3,  \
                       int32_t* __restrict__ z3, long long n) {             \
    addk<V>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n);                          \
  }

ADDK_KERNEL(addk_v2d_kernel, kV2d)
ADDK_KERNEL(addk_lazy_kernel, kLazy)
ADDK_KERNEL(addk_kara_kernel, kKara)
ADDK_KERNEL(addk_addonly_kernel, kAddOnly)

using KernelFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, const int32_t*,
                          int32_t*, int32_t*, int32_t*, long long);

int launch(KernelFn kernel, const int32_t* x1, const int32_t* y1,
           const int32_t* z1, const int32_t* x2, const int32_t* y2,
           const int32_t* z2, int32_t* x3, int32_t* y3, int32_t* z3,
           long long n, void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, x3, y3, z3, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Each takes the nine (L, n) int32 coordinate arrays (x1, y1, z1, x2, y2,
// z2 in, x3, y3, z3 out) and n; `consts` is unused (NULL): the field's
// constants are compiled in.  Returns the launch's cudaGetLastError() code.
#define ADDK_ENTRY(symbol, kernel)                                          \
  extern "C" int symbol(const int32_t* x1, const int32_t* y1,               \
                        const int32_t* z1, const int32_t* x2,               \
                        const int32_t* y2, const int32_t* z2, int32_t* x3,  \
                        int32_t* y3, int32_t* z3, const uint32_t* consts,   \
                        long long n, void* stream) {                        \
    (void)consts;                                                           \
    return launch(kernel, x1, y1, z1, x2, y2, z2, x3, y3, z3, n, stream);   \
  }

ADDK_ENTRY(davinci_addk_v2d, addk_v2d_kernel)
ADDK_ENTRY(davinci_addk_lazy, addk_lazy_kernel)
ADDK_ENTRY(davinci_addk_kara, addk_kara_kernel)
ADDK_ENTRY(davinci_addk_addonly, addk_addonly_kernel)

#endif  // DAVINCI_L == 22
