// The field and group core shared by every CUDA kernel of the port: the
// base field of a 254-bit prime (and its quadratic extension), complete
// projective point addition (RCB15 Algorithm 7, a = 0) and the complete
// mixed addition (RCB15 Algorithm 8, a = 0, second point affine).
//
// Boundary: a field element is L = 22 int32 12-bit limbs, least significant
// first, in Montgomery form with the reference's radix R = 2^264; limb j
// sits at src[j * stride].  Every operation returns canonical values in
// [0, p), so a kernel's outputs equal the plain PyTorch composition limb
// for limb.
//
// Inside, a field element is 8 32-bit words.  The Montgomery product is a
// CIOS loop over the 8 words, which divides by 2^256, followed by one
// reduction step over the remaining 8 bits of the radix (m = t * -p^-1
// mod 2^8, t = (t + m p) >> 8): that is exact Montgomery reduction by
// 2^264, so no conversion of the reference's Montgomery values is needed.
// p < 2^254 keeps every intermediate below 2p < 2^255 in 8 words.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int L = 22;                 // 12-bit limbs per base-field element
constexpr int N = 8;                  // 32-bit words per base-field element
constexpr int REM = 12 * L - 32 * N;  // radix bits beyond the word rounds
static_assert(REM > 0 && REM < 32, "radix split");

// Laid out word for word as the uint32 array of ec/cuda_add.py::_consts.
struct Consts {
  uint32_t p[N];
  uint32_t b3[2][N];  // 3*b in Montgomery form (G1 uses b3[0] only)
  uint32_t nr[N];     // Fp2 non-residue, Montgomery form
  uint32_t np0;       // -p^-1 mod 2^32
  uint32_t nr_is_m1;  // nr == -1: c0 = t0 - t1
  uint32_t one[N];    // 1 in Montgomery form (R mod p)
};

struct Fp {
  uint32_t w[N];
};

struct Fp2 {
  Fp c0, c1;
};

// -- boundary conversion ----------------------------------------------------

__device__ __forceinline__ void load(Fp& r, const int32_t* src,
                                     long long stride = 1) {
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    const uint32_t v = (uint32_t)src[j * stride];
    const int bit = 12 * j, k = bit >> 5, sh = bit & 31;
    if (k < N) r.w[k] |= v << sh;
    if (sh > 20 && k + 1 < N) r.w[k + 1] |= v >> (32 - sh);
  }
}

__device__ __forceinline__ void store(int32_t* dst, const Fp& a,
                                      long long stride = 1) {
#pragma unroll
  for (int j = 0; j < L; j++) {
    const int bit = 12 * j, k = bit >> 5, sh = bit & 31;
    uint32_t v = k < N ? a.w[k] >> sh : 0u;
    if (sh > 20 && k + 1 < N) v |= a.w[k + 1] << (32 - sh);
    dst[j * stride] = (int32_t)(v & 0xFFFu);
  }
}

__device__ __forceinline__ void load(Fp2& r, const int32_t* src) {
  load(r.c0, src);
  load(r.c1, src + L);
}

__device__ __forceinline__ void store(int32_t* dst, const Fp2& a) {
  store(dst, a.c0);
  store(dst + L, a.c1);
}

__device__ __forceinline__ void set_words(Fp& r, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = w[k];
}

__device__ __forceinline__ void set_b3(Fp& r, const Consts& c) {
  set_words(r, c.b3[0]);
}

__device__ __forceinline__ void set_b3(Fp2& r, const Consts& c) {
  set_words(r.c0, c.b3[0]);
  set_words(r.c1, c.b3[1]);
}

// -- Fp ----------------------------------------------------------------------

// a in [0, 2p) -> a mod p
__device__ __forceinline__ void csub(Fp& a, const Consts& c) {
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

__device__ __forceinline__ void add(Fp& r, const Fp& a, const Fp& b,
                                    const Consts& c) {
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    const uint64_t t = (uint64_t)a.w[k] + b.w[k] + carry;
    r.w[k] = (uint32_t)t;
    carry = t >> 32;
  }
  csub(r, c);
}

__device__ __forceinline__ void sub(Fp& r, const Fp& a, const Fp& b,
                                    const Consts& c) {
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

// r = a * b * 2^-264 mod p
__device__ __forceinline__ void mul(Fp& r, const Fp& a, const Fp& b,
                                    const Consts& c) {
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
    const uint32_t m = t[0] * c.np0;
    s = (uint64_t)m * c.p[0] + t[0];
    C = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * c.p[j] + t[j] + C;
      t[j - 1] = (uint32_t)s;
      C = s >> 32;
    }
    s = (uint64_t)t[N] + C;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  // t < 1.25 p: reduce by the last REM bits of the radix
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
  for (int j = 0; j < N; j++) r.w[j] = (t[j] >> REM) | (t[j + 1] << (32 - REM));
  csub(r, c);
}

// -- Fp2 = Fp[u]/(u^2 - nr) ---------------------------------------------------

__device__ __forceinline__ void add(Fp2& r, const Fp2& a, const Fp2& b,
                                    const Consts& c) {
  add(r.c0, a.c0, b.c0, c);
  add(r.c1, a.c1, b.c1, c);
}

__device__ __forceinline__ void sub(Fp2& r, const Fp2& a, const Fp2& b,
                                    const Consts& c) {
  sub(r.c0, a.c0, b.c0, c);
  sub(r.c1, a.c1, b.c1, c);
}

__device__ __forceinline__ void mul(Fp2& r, const Fp2& a, const Fp2& b,
                                    const Consts& c) {
  Fp t0, t1, sa, sb, mid;
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
    Fp nr;
    set_words(nr, c.nr);
    mul(t1, nr, t1, c);
    add(r.c0, t0, t1, c);
  }
}

// -- group operations --------------------------------------------------------

// RCB15 Algorithm 7 (a = 0), the operation order of pallas_add._rcb15.
// Outputs may alias inputs: every input is read before its output is set.
template <typename E>
__device__ __forceinline__ void rcb15(E& X3, E& Y3, E& Z3, const E& X1,
                                      const E& Y1, const E& Z1, const E& X2,
                                      const E& Y2, const E& Z2, const E& b3,
                                      const Consts& c) {
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
template <typename E>
__device__ __forceinline__ void rcb15_mixed(E& X3, E& Y3, E& Z3, const E& X1,
                                            const E& Y1, const E& Z1,
                                            const E& X2, const E& Y2,
                                            const E& b3, const Consts& c) {
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
