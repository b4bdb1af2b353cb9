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
// Fp<22>), and the product is a Montgomery product over the 8 words
// followed by one 8-bit reduction step, exact REDC by 2^264, as in
// field.cuh, with BN254's p, -p^-1 mod 2^32 and 3b (Montgomery form) as
// literals.  Every sum of words is a chain of Hopper's carry-chained
// instructions (ptx.cuh): the products' multiply-adds (mad.lo.cc,
// madc.hi.cc) and the adds and subtracts (add.cc/addc, sub.cc/subc), where
// field.cuh writes 64-bit sums that nvcc splits into wide multiplies and
// separate carry arithmetic.  The product keeps its accumulator as even
// and odd words in two halves, so that each row of multiply-adds is one
// unbroken chain (mont_round); Karatsuba's three 4x4-word products are
// the same rows (mul_wide).  Each variant's placement is a
// __launch_bounds__ register budget (kMinBlocks).
//
// What bounds it on the card: a complete add moves 9 x 88 bytes and does
// 14 field products of about 145 32-bit multiplies; at 3.35 TB/s against
// 132 SMs x 64 multiplies per clock the bytes bound it, so the layout is
// coalesced, and the variants measure what the multiplies, the reductions
// and the product's algorithm cost on top.

#include <type_traits>

#include "ptx.cuh"
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

// -- word arithmetic on carry chains (ptx.cuh) ----------------------------------

// a >= K p ? a - K p : a
template <int K>
__device__ __forceinline__ void sub_if_ge(F& a) {
  uint32_t d[N];
  d[0] = sub_cc(a.w[0], kp<K>(0));
#pragma unroll
  for (int k = 1; k < N; k++) d[k] = subc_cc(a.w[k], kp<K>(k));
  const uint32_t borrow = subc(0u, 0u);  // all ones where a < K p
#pragma unroll
  for (int k = 0; k < N; k++) a.w[k] = borrow ? a.w[k] : d[k];
}

// r = a + b without reduction: the caller keeps the sum below 2^256
__device__ __forceinline__ void add_raw(F& r, const F& a, const F& b) {
  r.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) r.w[k] = addc_cc(a.w[k], b.w[k]);
  r.w[N - 1] = addc(a.w[N - 1], b.w[N - 1]);
}

// r = a - b + K p: the caller keeps b <= K p and a + K p below 2^256 (the
// two chains wrap mod 2^256 around a value inside it)
template <int K>
__device__ __forceinline__ void sub_kp(F& r, const F& a, const F& b) {
  r.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) r.w[k] = subc_cc(a.w[k], b.w[k]);
  r.w[N - 1] = subc(a.w[N - 1], b.w[N - 1]);
  r.w[0] = add_cc(r.w[0], kp<K>(0));
#pragma unroll
  for (int k = 1; k < N - 1; k++) r.w[k] = addc_cc(r.w[k], kp<K>(k));
  r.w[N - 1] = addc(r.w[N - 1], kp<K>(N - 1));
}

// r = a - b mod p for a, b < p: p added back where the subtract borrows
__device__ __forceinline__ void sub_mod(F& r, const F& a, const F& b) {
  r.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N; k++) r.w[k] = subc_cc(a.w[k], b.w[k]);
  const uint32_t mask = subc(0u, 0u);
  uint32_t q[N];
#pragma unroll
  for (int k = 0; k < N; k++) q[k] = kp<1>(k) & mask;
  r.w[0] = add_cc(r.w[0], q[0]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) r.w[k] = addc_cc(r.w[k], q[k]);
  r.w[N - 1] = addc(r.w[N - 1], q[N - 1]);
}

// The exact reduction by the radix's last 8 bits (R = 2^256 * 2^8) of a
// value t below 2^256: r = (t + m p) / 2^8 with m = t * -p^-1 mod 2^8,
// the low and the high halves of m p added by two chains.
__device__ __forceinline__ void redc8(F& r, const uint32_t (&t)[N]) {
  const uint32_t m = (t[0] * NP0) & 0xFFu;
  uint32_t u[N + 1];
  u[0] = mad_lo_cc(m, kp<1>(0), t[0]);
#pragma unroll
  for (int j = 1; j < N; j++) u[j] = madc_lo_cc(m, kp<1>(j), t[j]);
  u[N] = addc(0u, 0u);
  u[1] = mad_hi_cc(m, kp<1>(0), u[1]);
#pragma unroll
  for (int j = 2; j < N; j++) u[j] = madc_hi_cc(m, kp<1>(j - 1), u[j]);
  u[N] = madc_hi(m, kp<1>(N - 1), u[N]);
#pragma unroll
  for (int j = 0; j < N; j++) r.w[j] = __funnelshift_r(u[j], u[j + 1], 8);
}

// One round of the word-serial Montgomery product on an accumulator held
// as two halves, T = even + 2^32 odd (even: words 0..7, odd: words 1..8),
// so that every word of each half takes one product half per row and the
// sum a b_i is two unbroken chains of multiply-adds, one for the a_j of
// even j (lo at word j, hi at j + 1: even's words in order) and one for
// odd j (odd's words in order): sppark's mont_t layout for 256-bit fields.
// A round adds a b_i (kProduct) to T, then m p with m = T_0 -p^-1 mod
// 2^32, which zeroes word 0.  The division by 2^32 is left to the next
// round, which is called with the halves swapped: T / 2^32 = odd +
// 2^32 (even >> 64 bits) + even_1, so the new even is the old odd plus
// even_1, and the new odd the old even two words down (rshift), both
// folded into the next round's chains.  `first`: T = 0 before this round.
// Every T stays below 2^32 (a + p) < 2^288 for a < 2^256 - p, so each
// half's own carry out of its top word is zero and is dropped.
template <bool kProduct>
__device__ __forceinline__ void mont_round(uint32_t (&even)[N],
                                           uint32_t (&odd)[N],
                                           const uint32_t (&a)[N],
                                           uint32_t bi, bool first) {
  if (first) {  // only with kProduct
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      even[j] = a[j] * bi;
      even[j + 1] = __umulhi(a[j], bi);
      odd[j] = a[j + 1] * bi;
      odd[j + 1] = __umulhi(a[j + 1], bi);
    }
  } else {
    even[0] = add_cc(even[0], odd[1]);
    if constexpr (kProduct) {
#pragma unroll
      for (int j = 0; j < N - 2; j += 2) {
        odd[j] = madc_lo_cc(a[j + 1], bi, odd[j + 2]);
        odd[j + 1] = madc_hi_cc(a[j + 1], bi, odd[j + 3]);
      }
      odd[N - 2] = madc_lo_cc(a[N - 1], bi, 0u);
      odd[N - 1] = madc_hi(a[N - 1], bi, 0u);
      even[0] = mad_lo_cc(a[0], bi, even[0]);
      even[1] = madc_hi_cc(a[0], bi, even[1]);
#pragma unroll
      for (int j = 2; j < N; j += 2) {
        even[j] = madc_lo_cc(a[j], bi, even[j]);
        even[j + 1] = madc_hi_cc(a[j], bi, even[j + 1]);
      }
      odd[N - 1] = addc(odd[N - 1], 0u);
    } else {
#pragma unroll
      for (int j = 0; j < N - 2; j++) odd[j] = addc_cc(odd[j + 2], 0u);
      odd[N - 2] = addc(0u, 0u);
      odd[N - 1] = 0u;
    }
  }
  const uint32_t m = even[0] * NP0;
  odd[0] = mad_lo_cc(m, kp<1>(1), odd[0]);
  odd[1] = madc_hi_cc(m, kp<1>(1), odd[1]);
#pragma unroll
  for (int j = 3; j < N; j += 2) {
    odd[j - 1] = madc_lo_cc(m, kp<1>(j), odd[j - 1]);
    odd[j] = madc_hi_cc(m, kp<1>(j), odd[j]);
  }
  even[0] = mad_lo_cc(m, kp<1>(0), even[0]);
  even[1] = madc_hi_cc(m, kp<1>(0), even[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    even[j] = madc_lo_cc(m, kp<1>(j), even[j]);
    even[j + 1] = madc_hi_cc(m, kp<1>(j), even[j + 1]);
  }
  odd[N - 1] = addc(odd[N - 1], 0u);
}

// r = T / 2^32 after the last round, called with the halves in the order
// that round took them: even + (odd >> 32) by one chain.
__device__ __forceinline__ void mont_merge(uint32_t (&r)[N],
                                           const uint32_t (&even)[N],
                                           const uint32_t (&odd)[N]) {
  r[0] = add_cc(even[1], odd[0]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) r[k] = addc_cc(even[k + 1], odd[k]);
  r[N - 1] = addc(0u, odd[N - 1]);
}

// r = a b / 2^264 mod p: eight product rounds (the CIOS of field.cuh's
// mont_mul, the same m_i, so the same value) and the exact 8-bit step.
// For any a, b below 2^256 - p, r < a b / 2^264 + p; kCanon subtracts p
// once, for a b < p 2^264.  r may alias a or b.
template <bool kCanon>
__device__ __forceinline__ void mul_cios(F& r, const F& a, const F& b) {
  uint32_t ev[N], od[N], t[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mont_round<true>(ev, od, a.w, b.w[i], i == 0);
    mont_round<true>(od, ev, a.w, b.w[i + 1], false);
  }
  mont_merge(t, od, ev);
  redc8(r, t);
  if constexpr (kCanon) sub_if_ge<1>(r);
}

// r[0..2M) = x y over M words (M even), schoolbook on two accumulators as
// in mont_round: for each y_i, the even-j products form one chain over
// words i .. i + M - 1 of E and the odd-j products one over words i + 1 ..
// i + M of O, each chain's carry written to the next word up (untouched
// until then); then r = E + O.
template <int M>
__device__ __forceinline__ void mul_wide(uint32_t (&r)[2 * M],
                                         const uint32_t (&x)[M],
                                         const uint32_t (&y)[M]) {
  uint32_t E[2 * M], O[2 * M];
#pragma unroll
  for (int j = 0; j < M; j += 2) {
    E[j] = x[j] * y[0];
    E[j + 1] = __umulhi(x[j], y[0]);
    O[j + 1] = x[j + 1] * y[0];
    O[j + 2] = __umulhi(x[j + 1], y[0]);
  }
  E[M] = 0u;
  O[M + 1] = 0u;
#pragma unroll
  for (int i = 1; i < M; i++) {
    E[i] = mad_lo_cc(x[0], y[i], E[i]);
    E[i + 1] = madc_hi_cc(x[0], y[i], E[i + 1]);
#pragma unroll
    for (int j = 2; j < M; j += 2) {
      E[i + j] = madc_lo_cc(x[j], y[i], E[i + j]);
      E[i + j + 1] = madc_hi_cc(x[j], y[i], E[i + j + 1]);
    }
    if (i + M < 2 * M) E[i + M] = addc(0u, 0u);
    O[i + 1] = mad_lo_cc(x[1], y[i], O[i + 1]);
    O[i + 2] = madc_hi_cc(x[1], y[i], O[i + 2]);
#pragma unroll
    for (int j = 3; j < M; j += 2) {
      O[i + j] = madc_lo_cc(x[j], y[i], O[i + j]);
      O[i + j + 1] = madc_hi_cc(x[j], y[i], O[i + j + 1]);
    }
    if (i + M + 1 < 2 * M) O[i + M + 1] = addc(0u, 0u);
  }
  r[0] = E[0];
  r[1] = add_cc(E[1], O[1]);
#pragma unroll
  for (int k = 2; k < 2 * M - 1; k++) r[k] = addc_cc(E[k], O[k]);
  r[2 * M - 1] = addc(E[2 * M - 1], O[2 * M - 1]);
}

// s = x + y over 4 words; returns the carry out (0 or 1)
__device__ __forceinline__ uint32_t add4(uint32_t (&s)[4],
                                         const uint32_t (&x)[4],
                                         const uint32_t (&y)[4]) {
  s[0] = add_cc(x[0], y[0]);
  s[1] = addc_cc(x[1], y[1]);
  s[2] = addc_cc(x[2], y[2]);
  s[3] = addc_cc(x[3], y[3]);
  return addc(0u, 0u);
}

// Karatsuba: with a = a0 + a1 2^128 and b likewise, a b = z0 + (z1 - z0 -
// z2) 2^128 + z2 2^256 where z0 = a0 b0, z2 = a1 b1 and z1 = (a0 + a1)(b0 +
// b1).  The half sums have 129 bits: z1 is the 4x4-word product of their
// low words plus the carry bits' cross terms, 9 words.  Then the exact REDC
// by 2^264 of the 16-word product t (below p^2 + 2^256 p < 2^511): eight
// reduction rounds on its low half alone (the m_i depend on the low words
// only), u = (t_lo + M p) / 2^256 <= p, plus its high half, a value below
// p^2 / 2^256 + p < 2p, and the 8-bit step; a canonical result.
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
  mul_wide(z0, a0, b0);
  mul_wide(z2, a1, b1);
  mul_wide(z1, sa, sb);
  // z1 += (ca sb + cb sa) 2^128 + ca cb 2^256, 9 words
  uint32_t w9[9], xb[4], xa[4];
  const uint32_t top = ca & cb;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    w9[k] = z1[k];
    xb[k] = sb[k] & (0u - ca);
    xa[k] = sa[k] & (0u - cb);
  }
  w9[4] = add_cc(z1[4], xb[0]);
#pragma unroll
  for (int k = 1; k < 4; k++) w9[k + 4] = addc_cc(z1[k + 4], xb[k]);
  w9[8] = addc(top, 0u);
  w9[4] = add_cc(w9[4], xa[0]);
#pragma unroll
  for (int k = 1; k < 4; k++) w9[k + 4] = addc_cc(w9[k + 4], xa[k]);
  w9[8] = addc(w9[8], 0u);
  // mid = z1 - z0 - z2 = a0 b1 + a1 b0, below 2^257
  uint32_t mid[9];
  mid[0] = sub_cc(w9[0], z0[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) mid[k] = subc_cc(w9[k], z0[k]);
  mid[8] = subc(w9[8], 0u);
  mid[0] = sub_cc(mid[0], z2[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) mid[k] = subc_cc(mid[k], z2[k]);
  mid[8] = subc(mid[8], 0u);
  // t = z0 + mid 2^128 + z2 2^256, below 2^508
#pragma unroll
  for (int k = 0; k < 4; k++) t[k] = z0[k];
  t[4] = add_cc(z0[4], mid[0]);
#pragma unroll
  for (int k = 5; k < 8; k++) t[k] = addc_cc(z0[k], mid[k - 4]);
#pragma unroll
  for (int k = 8; k < 13; k++) t[k] = addc_cc(z2[k - 8], mid[k - 4]);
#pragma unroll
  for (int k = 13; k < 15; k++) t[k] = addc_cc(z2[k - 8], 0u);
  t[15] = addc(z2[7], 0u);
  // REDC: the low half's rounds, then its high half added
  uint32_t ev[N], od[N], lo[N], u[N];
#pragma unroll
  for (int k = 0; k < N; k++) {
    ev[k] = t[k];
    od[k] = 0u;
  }
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mont_round<false>(ev, od, ev, 0u, false);
    mont_round<false>(od, ev, od, 0u, false);
  }
  mont_merge(lo, od, ev);
  u[0] = add_cc(lo[0], t[N]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) u[k] = addc_cc(lo[k], t[N + k]);
  u[N - 1] = addc(lo[N - 1], t[2 * N - 1]);
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
    sub_mod(r, a, b);
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
//
// Registers: one product of this dataflow needs 72, but ptxas interleaves
// independent products (three at once needed 168) and the whole add then
// spilled at 255.  So the operations run one after another: each reads
// its operands through a token, zero at run time but unknown to the
// compiler, that the last operation's result gives (AddOnly::tok), so no
// operation can start before the one before it has ended.  Between
// operations the add holds few values: an input stays in device memory and
// is read again at each of its three uses (Ref), and a result, 12-bit
// limbs like every value the formula holds between two operations (each
// operation's ripple output), is kept two limbs a word (limb 2i in the low
// half of word i, 2i + 1 in the high).

struct Limbs {
  uint32_t w[L / 2];
};

struct Ref {  // an input coordinate: limb j at p[j * n]
  const int32_t* p;
  long long n;
};

__device__ __forceinline__ void pack(Limbs& r, const int32_t (&v)[L]) {
#pragma unroll
  for (int i = 0; i < L / 2; i++)
    r.w[i] = (uint32_t)v[2 * i] | ((uint32_t)v[2 * i + 1] << 16);
}

// a's limbs, each word read as w + tok
__device__ __forceinline__ void unpack(int32_t (&v)[L], const Limbs& a,
                                       uint32_t tok = 0) {
#pragma unroll
  for (int i = 0; i < L / 2; i++) {
    const uint32_t w = a.w[i] + tok;
    v[2 * i] = (int32_t)(w & 0xFFFFu);
    v[2 * i + 1] = (int32_t)(w >> 16);
  }
}

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
  for (int j = 0; j < L; j++) d[j] = borrow != 0 ? s[j] : d[j];
  pack(r, d);
}

struct AddOnly {
  using E = Limbs;
  uint32_t zero;     // 0 at run time, from a kernel argument
  uint32_t tok = 0;  // last result's first word & zero: 0

  // an operand's int32 limbs, after the last operation
  __device__ __forceinline__ void get(int32_t (&v)[L], const Limbs& a) {
    unpack(v, a, tok);
  }
  __device__ __forceinline__ void get(int32_t (&v)[L], const Ref& a) {
#pragma unroll
    for (int j = 0; j < L; j++) v[j] = a.p[j * a.n + tok];
  }
  __device__ __forceinline__ void done(const Limbs& r) { tok = r.w[0] & zero; }

  template <class A, class B>
  __device__ __forceinline__ void mul(Limbs& r, const A& pa, const B& pb) {
    int32_t a[L], b[L], t[2 * L];
    get(a, pa);
    get(b, pb);
#pragma unroll
    for (int k = 0; k < 2 * L; k++) {
      int32_t acc = 0;
#pragma unroll
      for (int i = (k - L + 1 > 0 ? k - L + 1 : 0); i < (k + 1 < L ? k + 1 : L);
           i++)
        acc = wrap_add(acc, wrap_add(a[i], b[k - i]));
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
    done(r);
  }
  template <class A, class B>
  __device__ __forceinline__ void add(Limbs& r, const A& pa, const B& pb) {
    int32_t a[L], b[L], s[L];
    get(a, pa);
    get(b, pb);
#pragma unroll
    for (int j = 0; j < L; j++) s[j] = wrap_add(a[j], b[j]);
    ripple(s);
    ao_csub(r, s);
    done(r);
  }
  template <class A, class B>
  __device__ __forceinline__ void sub(Limbs& r, const A& pa, const B& pb) {
    int32_t a[L], b[L], s[L];
    get(a, pa);
    get(b, pb);
#pragma unroll
    for (int j = 0; j < L; j++)
      s[j] = wrap_add(wrap_sub(a[j], b[j]), p_limb(j));
    ripple(s);
    ao_csub(r, s);
    done(r);
  }
  static __device__ __forceinline__ void b3(Limbs& r) {
    int32_t v[L];
#pragma unroll
    for (int j = 0; j < L; j++) v[j] = b3_limb(j);
    pack(r, v);
  }
};

// -- the formula ------------------------------------------------------------------

// RCB15 Algorithm 7 (a = 0) in the operation order of the experiment's
// _rcb15 (and field.cuh's rcb15), on the field Ops.
template <class Ops, class In, class E = typename Ops::E>
__device__ __forceinline__ void rcb15(Ops& ops, E& X3, E& Y3, E& Z3,
                                      const In& X1, const In& Y1,
                                      const In& Z1, const In& X2,
                                      const In& Y2, const In& Z2) {
  E t0, t1, t2, t3, t4, u, v, b3;
  ops.b3(b3);
  ops.mul(t0, X1, X2);
  ops.mul(t1, Y1, Y2);
  ops.mul(t2, Z1, Z2);
  ops.add(u, X1, Y1);
  ops.add(v, X2, Y2);
  ops.mul(t3, u, v);
  ops.add(u, t0, t1);
  ops.sub(t3, t3, u);
  ops.add(u, Y1, Z1);
  ops.add(v, Y2, Z2);
  ops.mul(t4, u, v);
  ops.add(u, t1, t2);
  ops.sub(t4, t4, u);
  ops.add(u, X1, Z1);
  ops.add(v, X2, Z2);
  ops.mul(X3, u, v);
  ops.add(u, t0, t2);
  ops.sub(Y3, X3, u);
  ops.add(X3, t0, t0);
  ops.add(t0, X3, t0);
  ops.mul(t2, b3, t2);
  ops.add(Z3, t1, t2);
  ops.sub(t1, t1, t2);
  ops.mul(Y3, b3, Y3);
  ops.mul(X3, t4, Y3);
  ops.mul(t2, t3, t1);
  ops.sub(X3, t2, X3);
  ops.mul(Y3, Y3, t0);
  ops.mul(t1, t1, Z3);
  ops.add(Y3, t1, Y3);
  ops.mul(t0, t0, t3);
  ops.mul(Z3, Z3, t4);
  ops.add(Z3, Z3, t0);
}

// The lazy formula.  Bounds, in multiples of p, for canonical inputs (each
// below p).  BN254's p is 0.18906 * 2^256, so a value fits the 8 words
// while below 5.2901 p, a product's operands keep its accumulator inside
// 9 words while below 2^256 - p = 4.2901 p (mul_cios), and its REDC input
// a b stays below p 2^264 while a b < 1354 p^2.  mul_cios<false> returns
// r < a b / 2^264 + p =
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
// Every value stays below 4.01 p < 2^256 - p, every product's a b below
// 13 p^2;
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

__device__ __forceinline__ void store(int32_t* dst, const Limbs& a,
                                      long long n) {
  int32_t v[L];
  unpack(v, a);
#pragma unroll
  for (int j = 0; j < L; j++) dst[j * n] = v[j];
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
  if constexpr (V == kAddOnly) {
    // n >> 62: 0 for any n the card can hold, a value the compiler cannot
    // know
    AddOnly ops{(uint32_t)(n >> 62)};
    Limbs X3, Y3, Z3;
    rcb15(ops, X3, Y3, Z3, Ref{x1 + i, n}, Ref{y1 + i, n}, Ref{z1 + i, n},
          Ref{x2 + i, n}, Ref{y2 + i, n}, Ref{z2 + i, n});
    store(x3 + i, X3, n);
    store(y3 + i, Y3, n);
    store(z3 + i, Z3, n);
  } else {
    F X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3;
    load(X1, x1 + i, n);
    load(Y1, y1 + i, n);
    load(Z1, z1 + i, n);
    load(X2, x2 + i, n);
    load(Y2, y2 + i, n);
    load(Z2, z2 + i, n);
    if constexpr (V == kV2d || V == kKara) {
      Strict<V == kKara> ops;
      rcb15(ops, X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
    } else {
      rcb15_lazy(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2);
    }
    store(x3 + i, X3, n);
    store(y3 + i, Y3, n);
    store(z3 + i, Z3, n);
  }
}

// The placement: ADDK_THREADS threads a block, and the blocks an SM must
// hold at once for each variant (ptxas then caps a thread at 65,536 /
// (ADDK_THREADS blocks) registers): for v2d, lazy and kara the budget that
// timed fastest at 2^20 adds, for addonly the only one without a spill
// (PERF.md).
constexpr int ADDK_THREADS = 128;
template <Variant V>
constexpr int kMinBlocks = V == kV2d ? 4 : V == kLazy ? 3 : V == kKara ? 3 : 2;

// One entry function per variant, so that a profiler trace names each.
#define ADDK_KERNEL(name, V)                                                 \
  __global__ void __launch_bounds__(ADDK_THREADS, kMinBlocks<V>)             \
      name(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,   \
           const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,   \
           const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,   \
           int32_t* __restrict__ x3, int32_t* __restrict__ y3,               \
           int32_t* __restrict__ z3, long long n) {                          \
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
  const long long blocks = (n + ADDK_THREADS - 1) / ADDK_THREADS;
  kernel<<<(unsigned)blocks, ADDK_THREADS, 0, (cudaStream_t)stream>>>(
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
