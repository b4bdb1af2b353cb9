// The field and group core shared by every CUDA kernel of the port: a prime
// field of L 12-bit limbs (and its quadratic extension), the Montgomery
// product, complete projective point addition (RCB15 Algorithm 7, a = 0)
// and the complete mixed addition (RCB15 Algorithm 8, a = 0, second point
// affine).  Everything is a template on L; a kernel source picks its
// instantiation with -DDAVINCI_L (cuda_build.py builds L = 22 and L = 32,
// and L = 64, BW6-761's Fp, for the sources of that curve's path).
//
// Boundary: a field element is L int32 12-bit limbs, least significant
// first, in Montgomery form with the reference's radix R = 2^(12 L); limb j
// sits at src[j * stride].  Every operation returns canonical values in
// [0, p), so a kernel's outputs equal the plain PyTorch composition limb
// for limb.
//
// Inside, a field element is N = floor(12 L / 32) 32-bit words.  The
// Montgomery product is a CIOS loop over the N words, which divides by
// 2^(32 N), followed, when the radix has REM = 12 L - 32 N bits left (8 at
// L = 22), by one reduction step over them (m = t * -p^-1 mod 2^REM,
// t = (t + m p) >> REM): exact Montgomery reduction by R, so no conversion
// of the reference's Montgomery values is needed.  At L = 32 and 64,
// R = 2^384 and 2^768 fall on the word rounds (N = 12 and 24) and the step
// disappears.  A modulus below 2^(32 N - 1) (255 bits at L = 22, 383 at
// L = 32, 767 at L = 64: BW6-761's p has 761) keeps every sum below 2p
// inside N words; the wrappers refuse larger ones.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int L>
struct Radix {
  static constexpr int N = 12 * L / 32;        // 32-bit words per element
  static constexpr int REM = 12 * L - 32 * N;  // radix bits beyond them
  // words of a value below R (B6's raw operand): one more when REM > 0
  static constexpr int NR = N + (REM > 0 ? 1 : 0);
  static_assert(N > 0 && REM >= 0 && REM < 32, "radix split");
};

// Laid out word for word as the uint32 array of kernels.py::field_consts.
template <int L>
struct Consts {
  uint32_t p[Radix<L>::N];
  uint32_t b3[2][Radix<L>::N];  // 3*b in Montgomery form (G1 uses b3[0])
  uint32_t nr[Radix<L>::N];     // Fp2 non-residue, Montgomery form
  uint32_t np0;                 // -p^-1 mod 2^32
  uint32_t nr_is_m1;            // nr == -1: c0 = t0 - t1
  uint32_t one[Radix<L>::N];    // 1 in Montgomery form (R mod p)
  uint32_t b3_small;            // G1: |3b| as an integer where below 2^8,
                                // else 0 (group6.cuh)
#if DAVINCI_L > 32
  uint32_t b3_neg;              // 3b = -b3_small (BW6-761 G1: b = -1)
#endif
};

template <int L_>
struct Fp {
  static constexpr int L = L_;
  static constexpr int N = Radix<L_>::N;
  uint32_t w[N];
};

template <int L_>
struct Fp2 {
  static constexpr int L = L_;
  Fp<L_> c0, c1;
};

// -- boundary conversion ----------------------------------------------------

// L 12-bit limbs -> NW words (bits beyond NW words are dropped)
template <int L, int NW>
__device__ __forceinline__ void load_words(uint32_t (&w)[NW],
                                           const int32_t* src,
                                           long long stride = 1) {
#pragma unroll
  for (int k = 0; k < NW; k++) w[k] = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    const uint32_t v = (uint32_t)src[j * stride];
    const int bit = 12 * j, k = bit >> 5, sh = bit & 31;
    if (k < NW) w[k] |= v << sh;
    if (sh > 20 && k + 1 < NW) w[k + 1] |= v >> (32 - sh);
  }
}

template <int L>
__device__ __forceinline__ void load(Fp<L>& r, const int32_t* src,
                                     long long stride = 1) {
  load_words<L>(r.w, src, stride);
}

template <int L>
__device__ __forceinline__ void store(int32_t* dst, const Fp<L>& a,
                                      long long stride = 1) {
  constexpr int N = Fp<L>::N;
#pragma unroll
  for (int j = 0; j < L; j++) {
    const int bit = 12 * j, k = bit >> 5, sh = bit & 31;
    uint32_t v = k < N ? a.w[k] >> sh : 0u;
    if (sh > 20 && k + 1 < N) v |= a.w[k + 1] << (32 - sh);
    dst[j * stride] = (int32_t)(v & 0xFFFu);
  }
}

template <int L>
__device__ __forceinline__ void load(Fp2<L>& r, const int32_t* src) {
  load(r.c0, src);
  load(r.c1, src + L);
}

template <int L>
__device__ __forceinline__ void store(int32_t* dst, const Fp2<L>& a) {
  store(dst, a.c0);
  store(dst + L, a.c1);
}

template <int L>
__device__ __forceinline__ void set_words(Fp<L>& r, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < Fp<L>::N; k++) r.w[k] = w[k];
}

template <int L>
__device__ __forceinline__ void set_b3(Fp<L>& r, const Consts<L>& c) {
  set_words(r, c.b3[0]);
}

template <int L>
__device__ __forceinline__ void set_b3(Fp2<L>& r, const Consts<L>& c) {
  set_words(r.c0, c.b3[0]);
  set_words(r.c1, c.b3[1]);
}

// -- Fp ----------------------------------------------------------------------

// a in [0, 2p) -> a mod p
template <int L>
__device__ __forceinline__ void csub(Fp<L>& a, const Consts<L>& c) {
  constexpr int N = Fp<L>::N;
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint64_t t = (uint64_t)a.w[k] - c.p[k] - borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
#pragma unroll
  for (int k = 0; k < N; k++) a.w[k] = borrow ? a.w[k] : d[k];
}

template <int L>
__device__ __forceinline__ void add(Fp<L>& r, const Fp<L>& a, const Fp<L>& b,
                                    const Consts<L>& c) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < Fp<L>::N; k++) {
    const uint64_t t = (uint64_t)a.w[k] + b.w[k] + carry;
    r.w[k] = (uint32_t)t;
    carry = t >> 32;
  }
  csub(r, c);
}

template <int L>
__device__ __forceinline__ void sub(Fp<L>& r, const Fp<L>& a, const Fp<L>& b,
                                    const Consts<L>& c) {
  constexpr int N = Fp<L>::N;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint64_t t = (uint64_t)a.w[k] - b.w[k] - borrow;
    r.w[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t mask = 0u - borrow;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint64_t t = (uint64_t)r.w[k] + (c.p[k] & mask) + carry;
    r.w[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

// r = a * b * R^-1 mod p, canonical.  a has NA words (N, or NR for a raw
// value below R), b < p.  Then every CIOS partial sum stays below a + p
// and the reduced value below 2p.  r may alias b.
template <int L, int NA>
__device__ __forceinline__ void mont_mul(Fp<L>& r, const uint32_t (&a)[NA],
                                         const Fp<L>& b,
                                         const Consts<L>& c) {
  constexpr int N = Radix<L>::N, REM = Radix<L>::REM;
  static_assert(NA == N || NA == Radix<L>::NR, "operand words");
  uint32_t t[NA + 2];
#pragma unroll
  for (int k = 0; k < NA + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < NA; j++) {
      const uint64_t s = (uint64_t)a[j] * b.w[i] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    uint64_t s = (uint64_t)t[NA] + C;
    t[NA] = (uint32_t)s;
    t[NA + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * c.np0;
    s = (uint64_t)m * c.p[0] + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * c.p[j] + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
#pragma unroll
    for (int j = N; j <= NA; j++) {  // p has no words here: carry only
      s = (uint64_t)t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    t[NA] = t[NA + 1] + (uint32_t)C;
  }
  if constexpr (REM > 0) {
    // reduce by the last REM bits of the radix
    const uint32_t m = (t[0] * c.np0) & ((1u << REM) - 1);
    uint64_t C = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      const uint64_t s = (uint64_t)m * c.p[j] + t[j] + C;
      t[j] = (uint32_t)s;
      C = s >> 32;
    }
    t[N] += (uint32_t)C;
#pragma unroll
    for (int j = 0; j < N; j++)
      r.w[j] = (t[j] >> REM) | (t[j + 1] << (32 - REM));
  } else {
#pragma unroll
    for (int j = 0; j < N; j++) r.w[j] = t[j];
  }
  csub(r, c);
}

// Beyond 8 words the product is a called function: a fully unrolled
// product at L = 32 is 12 x 25 multiply-adds, and nvcc crashed on kernels
// with two point adds (26 products) inlined.  At L = 64 (24 x 49) the
// same function.
template <int L>
__device__ __noinline__ Fp<L> mul_call(const Fp<L> a, const Fp<L> b,
                                       const Consts<L>& c) {
  Fp<L> r;
  mont_mul(r, a.w, b, c);
  return r;
}

template <int L>
__device__ __forceinline__ void mul(Fp<L>& r, const Fp<L>& a, const Fp<L>& b,
                                    const Consts<L>& c) {
  if constexpr (Radix<L>::N > 8) {
    r = mul_call(a, b, c);
  } else {
    mont_mul(r, a.w, b, c);
  }
}

// -- Fp2 = Fp[u]/(u^2 - nr) ---------------------------------------------------

template <int L>
__device__ __forceinline__ void add(Fp2<L>& r, const Fp2<L>& a,
                                    const Fp2<L>& b, const Consts<L>& c) {
  add(r.c0, a.c0, b.c0, c);
  add(r.c1, a.c1, b.c1, c);
}

template <int L>
__device__ __forceinline__ void sub(Fp2<L>& r, const Fp2<L>& a,
                                    const Fp2<L>& b, const Consts<L>& c) {
  sub(r.c0, a.c0, b.c0, c);
  sub(r.c1, a.c1, b.c1, c);
}

template <int L>
__device__ __forceinline__ void mul(Fp2<L>& r, const Fp2<L>& a,
                                    const Fp2<L>& b, const Consts<L>& c) {
  Fp<L> t0, t1, sa, sb, mid;
  mul(t0, a.c0, b.c0, c);
  mul(t1, a.c1, b.c1, c);
  add(sa, a.c0, a.c1, c);
  add(sb, b.c0, b.c1, c);
  mul(mid, sa, sb, c);
  sub(mid, mid, t0, c);
  sub(r.c1, mid, t1, c);
  if (c.nr_is_m1) {
    sub(r.c0, t0, t1, c);
  } else {
    Fp<L> nr;
    set_words(nr, c.nr);
    mul(t1, nr, t1, c);
    add(r.c0, t0, t1, c);
  }
}

// -- group operations --------------------------------------------------------

// RCB15 Algorithm 7 (a = 0), the operation order of pallas_add._rcb15.
// Outputs may alias inputs: every input is read before its output is set.
template <typename E, int L>
__device__ __forceinline__ void rcb15(E& X3, E& Y3, E& Z3, const E& X1,
                                      const E& Y1, const E& Z1, const E& X2,
                                      const E& Y2, const E& Z2, const E& b3,
                                      const Consts<L>& c) {
  E t0, t1, t2, t3, t4, u, v;
  mul(t0, X1, X2, c);
  mul(t1, Y1, Y2, c);
  mul(t2, Z1, Z2, c);
  add(u, X1, Y1, c);
  add(v, X2, Y2, c);
  mul(t3, u, v, c);
  add(u, t0, t1, c);
  sub(t3, t3, u, c);
  add(u, Y1, Z1, c);
  add(v, Y2, Z2, c);
  mul(t4, u, v, c);
  add(u, t1, t2, c);
  sub(t4, t4, u, c);
  add(u, X1, Z1, c);
  add(v, X2, Z2, c);
  mul(X3, u, v, c);
  add(u, t0, t2, c);
  sub(Y3, X3, u, c);
  add(X3, t0, t0, c);
  add(t0, X3, t0, c);
  mul(t2, b3, t2, c);
  add(Z3, t1, t2, c);
  sub(t1, t1, t2, c);
  mul(Y3, b3, Y3, c);
  mul(X3, t4, Y3, c);
  mul(t2, t3, t1, c);
  sub(X3, t2, X3, c);
  mul(Y3, Y3, t0, c);
  mul(t1, t1, Z3, c);
  add(Y3, t1, Y3, c);
  mul(t0, t0, t3, c);
  mul(Z3, Z3, t4, c);
  add(Z3, Z3, t0, c);
}

// RCB15 Algorithm 8 (a = 0): (X1, Y1, Z1) projective plus (X2, Y2) affine,
// not the identity; the operation order of pallas_add._rcb15_mixed.
// Outputs may alias the first point's coordinates.
template <typename E, int L>
__device__ __forceinline__ void rcb15_mixed(E& X3, E& Y3, E& Z3, const E& X1,
                                            const E& Y1, const E& Z1,
                                            const E& X2, const E& Y2,
                                            const E& b3, const Consts<L>& c) {
  E t0, t1, t2, t3, t4, u, v;
  mul(t0, X1, X2, c);
  mul(t1, Y1, Y2, c);
  add(u, X2, Y2, c);
  add(v, X1, Y1, c);
  mul(t3, u, v, c);
  add(u, t0, t1, c);
  sub(t3, t3, u, c);
  mul(t4, Y2, Z1, c);
  add(t4, t4, Y1, c);
  mul(u, X2, Z1, c);
  add(u, u, X1, c);
  mul(t2, b3, Z1, c);
  add(X3, t0, t0, c);
  add(t0, X3, t0, c);
  add(Z3, t1, t2, c);
  sub(t1, t1, t2, c);
  mul(Y3, b3, u, c);
  mul(X3, t4, Y3, c);
  mul(t2, t3, t1, c);
  sub(X3, t2, X3, c);
  mul(Y3, Y3, t0, c);
  mul(t1, t1, Z3, c);
  add(Y3, t1, Y3, c);
  mul(t0, t0, t3, c);
  mul(Z3, Z3, t4, c);
  add(Z3, Z3, t0, c);
}

}  // namespace

// The instantiation a kernel source is built for (cuda_build.py passes
// -DDAVINCI_L).
#ifndef DAVINCI_L
#error "build with -DDAVINCI_L=22, 32 or 64 (see cuda_build.py)"
#endif
