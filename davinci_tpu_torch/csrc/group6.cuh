// Complete point additions spread over six threads of a warp: the G1 add
// (RCB15 Algorithm 7, a = 0) and mixed add (Algorithm 8) over Fp, and the
// G2 add over Fp2 (B7's step).  A warp holds five such groups (lanes 30 and
// 31 only reach the barriers).
//
// RCB15's products fall into three levels of independent products:
//   level 1: six products of the inputs (Alg 7: X1X2, Y1Y2, Z1Z2,
//            (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2); Alg 8: X1X2,
//            Y1Y2, (X2+Y2)(X1+Y1), Y2Z1, X2Z1, b3 Z1);
//   level 2: the products by b3 (Alg 7: b3 t2 and b3 Y3; Alg 8: b3 Y3);
//   level 3: six products (t4 b3Y3, t3 t1', b3Y3 3t0, t1' Z3, 3t0 t3,
//            Z3 t4, with t1' = t1 - b3 t2 and Z3 = t1 + b3 t2);
// then three adds give X3, Y3 and Z3.  Thread r of a group computes product
// r of levels 1 and 3; intermediates pass through shared memory, separated
// by __syncwarp().  So one add waits on two or three products in a row,
// not fourteen.  Lanes without an add (act false) still reach every
// barrier; a warp with no add at all may leave whole.
//
// On G1 the curve's 3b is a small integer (9 for BN254, 3 for BLS12-377, 12
// for BLS12-381; Consts::b3_small) or the negative of one (-3 for BW6-761,
// b = -1; Consts::b3_neg: the additions, then one subtraction from zero).
// The mixed add (B2, many adds in flight)
// multiplies by it with chains of additions on canonical values inside level
// 1 and the operands of level 3, so it has no level 2; the complete add (B5,
// one chain of dependent adds) keeps level 2's Montgomery products by b3,
// which cost one product and a barrier against about ten additions on the
// critical path.  On the H100 each form was the faster for its kernel (the
// two were timed against each other, PERF.md).  Every field operation
// returns canonical words, so both forms, in any exact order of their adds,
// give the limbs of field.cuh's rcb15 / rcb15_mixed and of the plain PyTorch
// versions.

#pragma once

#include "field.cuh"

namespace {

constexpr int GROUP = 6;            // threads per add
constexpr int GROUPS = 32 / GROUP;  // adds per warp

template <int L>
__device__ __forceinline__ void ld(Fp<L>& r, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < Fp<L>::N; k++) r.w[k] = w[k];
}

template <int L>
__device__ __forceinline__ void st(uint32_t* w, const Fp<L>& a) {
#pragma unroll
  for (int k = 0; k < Fp<L>::N; k++) w[k] = a.w[k];
}

// 12-bit limb j of a value held as words (field.cuh's `store`, one limb)
template <int L>
__device__ __forceinline__ int32_t limb_of(const uint32_t* w, int j) {
  constexpr int N = Radix<L>::N;
  const int bit = 12 * j, k = bit >> 5, sh = bit & 31;
  uint32_t v = w[k] >> sh;
  if (sh > 20 && k + 1 < N) v |= w[k + 1] << (32 - sh);
  return (int32_t)(v & 0xFFFu);
}

// r = k a for the small integer k > 0, by doublings and adds from the top
// bit (r may alias a)
template <int L>
__device__ __forceinline__ void times_small(Fp<L>& r, const Fp<L>& a,
                                            uint32_t k, const Consts<L>& c) {
  const Fp<L> x = a;
  r = x;
  for (int i = 30 - __clz(k); i >= 0; i--) {
    add(r, r, r, c);
    if ((k >> i) & 1) add(r, r, x, c);
  }
}

// r = 3b a with 3b = +-Consts::b3_small (r may alias a).  The sign exists
// only in the L = 64 build (Consts::b3_neg): the L = 22 and 32 builds keep
// the plain chain of additions, with no run-time test and no extra word.
template <int L>
__device__ __forceinline__ void times_b3(Fp<L>& r, const Fp<L>& a,
                                         const Consts<L>& c) {
  times_small(r, a, c.b3_small, c);
#if DAVINCI_L > 32
  if (c.b3_neg) {
    Fp<L> zero;
#pragma unroll
    for (int k = 0; k < Fp<L>::N; k++) zero.w[k] = 0;
    sub(r, zero, r, c);
  }
#endif
}

// -- G1 ------------------------------------------------------------------------

// A point's coordinates as words: c[0] X, c[1] Y, c[2] Z.
template <int L>
struct Pt6 {
  uint32_t c[3][Radix<L>::N];
};

// One group's intermediates.
template <int L>
struct Scratch6 {
  uint32_t p[6][Radix<L>::N];   // level-1 products
  uint32_t q[2][Radix<L>::N];   // add6's level 2: b3 t2, b3 Y3
  uint32_t p3[6][Radix<L>::N];  // level-3 products
};

// Level 3 and the final adds, shared by both adds.  operand(v, k) sets
// operand k: 0 t4, 1 t3, 2 b3 Y3, 3 t1 - b3 t2, 4 3 t0, 5 t1 + b3 t2;
// thread r multiplies operand r by operand (r < 4 ? r + 2 : 5 - r).  The
// result goes to O after every read of the inputs.
template <int L, class Operand>
__device__ __forceinline__ void level3(Pt6<L>& O, Scratch6<L>& s, int r,
                                       bool act, const Consts<L>& c,
                                       Operand operand) {
  Fp<L> a, b;
  if (act) {
    operand(a, r);
    operand(b, r < 4 ? r + 2 : 5 - r);
    mul(a, a, b, c);
    st(s.p3[r], a);
  }
  __syncwarp();
  // X3 = t3 t1' - t4 b3Y3, Y3 = t1' Z3 + b3Y3 3t0, Z3 = Z3 t4 + 3t0 t3
  if (act && r < 3) {
    ld(a, s.p3[2 * r + 1]);
    ld(b, s.p3[2 * r]);
    if (r == 0) {
      sub(a, a, b, c);
    } else {
      add(a, a, b, c);
    }
    st(O.c[r], a);
  }
  __syncwarp();
}

// O = A + B (Algorithm 7), thread r of the group; O may alias A or B.
template <int L>
__device__ __forceinline__ void add6(Pt6<L>& O, const Pt6<L>& A,
                                     const Pt6<L>& B, Scratch6<L>& s, int r,
                                     bool act, const Consts<L>& c) {
  using F = Fp<L>;
  if (act) {
    // X X, Y Y, Z Z, (X+Y)(X+Y), (Y+Z)(Y+Z), (X+Z)(X+Z)
    const int i0 = r == 4 ? 1 : (r < 3 ? r : 0);
    F a, b;
    ld(a, A.c[i0]);
    ld(b, B.c[i0]);
    if (r >= 3) {
      const int i1 = r == 3 ? 1 : 2;
      F a1, b1;
      ld(a1, A.c[i1]);
      ld(b1, B.c[i1]);
      add(a, a, a1, c);
      add(b, b, b1, c);
    }
    mul(a, a, b, c);
    st(s.p[r], a);
  }
  __syncwarp();
  // level 2: b3 t2, b3 Y3 with Y3 = (X1+Z1)(X2+Z2) - (t0 + t2)
  if (act && r < 2) {
    F v, b3;
    ld(v, s.p[r == 0 ? 2 : 5]);
    if (r == 1) {
      F t0, t2;
      ld(t0, s.p[0]);
      ld(t2, s.p[2]);
      add(t0, t0, t2, c);
      sub(v, v, t0, c);
    }
    set_b3(b3, c);
    mul(v, b3, v, c);
    st(s.q[r], v);
  }
  __syncwarp();
  level3(O, s, r, act, c, [&](F& v, int k) {
    F u, w;
    switch (k) {
      case 0:  // t4 = P4 - (P1 + P2)
      case 1:  // t3 = P3 - (P0 + P1)
        ld(v, s.p[k == 0 ? 4 : 3]);
        ld(u, s.p[1]);
        ld(w, s.p[k == 0 ? 2 : 0]);
        add(u, u, w, c);
        sub(v, v, u, c);
        break;
      case 2:
        ld(v, s.q[1]);
        break;
      case 4:
        ld(u, s.p[0]);
        add(v, u, u, c);
        add(v, v, u, c);
        break;
      default:  // 3 and 5: t1 -/+ b3 t2
        ld(w, s.q[0]);
        ld(u, s.p[1]);
        if (k == 3) {
          sub(v, u, w, c);
        } else {
          add(v, u, w, c);
        }
    }
  });
}

// O = A + (x2, y2) (Algorithm 8: the second point affine and not the
// identity; every thread of the group holds x2 and y2), thread r of the
// group; O may alias A.  3b is +-Consts::b3_small, which must not be 0.
template <int L>
__device__ __forceinline__ void madd6(Pt6<L>& O, const Pt6<L>& A,
                                      const Fp<L>& x2, const Fp<L>& y2,
                                      Scratch6<L>& s, int r, bool act,
                                      const Consts<L>& c) {
  using F = Fp<L>;
  if (act) {
    // X1 x2, Y1 y2, (x2+y2)(X1+Y1), y2 Z1, x2 Z1, b3 Z1
    F a, b;
    if (r == 2) {
      F a1;
      add(b, x2, y2, c);
      ld(a, A.c[0]);
      ld(a1, A.c[1]);
      add(a, a, a1, c);
    } else {
      ld(a, A.c[r < 2 ? r : 2]);
      b = r == 0 || r == 4 ? x2 : y2;
    }
    if (r == 5) {
      times_b3(a, a, c);
    } else {
      mul(a, a, b, c);
    }
    st(s.p[r], a);
  }
  __syncwarp();
  level3(O, s, r, act, c, [&](F& v, int k) {
    F u, w;
    switch (k) {
      case 0:  // t4 = y2 Z1 + Y1
        ld(v, s.p[3]);
        ld(u, A.c[1]);
        add(v, v, u, c);
        break;
      case 1:  // t3 = P2 - (P0 + P1)
        ld(v, s.p[2]);
        ld(u, s.p[0]);
        ld(w, s.p[1]);
        add(u, u, w, c);
        sub(v, v, u, c);
        break;
      case 2:  // b3 Y3, Y3 = x2 Z1 + X1
        ld(u, s.p[4]);
        ld(w, A.c[0]);
        add(u, u, w, c);
        times_b3(v, u, c);
        break;
      case 4:
        ld(u, s.p[0]);
        add(v, u, u, c);
        add(v, v, u, c);
        break;
      default:  // 3 and 5: t1 -/+ b3 Z1
        ld(u, s.p[1]);
        ld(w, s.p[5]);
        if (k == 3) {
          sub(v, u, w, c);
        } else {
          add(v, u, w, c);
        }
    }
  });
}

// -- G2 (B7's step) --------------------------------------------------------------

// One G2 add's intermediates: p[i] product i of level 1, then of level 3;
// q the Karatsuba parts m0, m1, m2 of b3 t2 (0-2) and of b3 Y3 (3-5) and,
// for nr != -1, nr m1 of each (6, 7).
template <int L>
struct Scratch6G2 {
  uint32_t p[6][2][Radix<L>::N];
  uint32_t q[8][Radix<L>::N];
};

template <int L>
__device__ __forceinline__ void ld(Fp2<L>& r, const uint32_t (&w)[2][Radix<L>::N]) {
  ld(r.c0, w[0]);
  ld(r.c1, w[1]);
}

template <int L>
__device__ __forceinline__ void st(uint32_t (&w)[2][Radix<L>::N], const Fp2<L>& a) {
  st(w[0], a.c0);
  st(w[1], a.c1);
}

// u * b3 from its parts: c0 = m0 + nr m1, c1 = m2 - m0 - m1 (j = 0: b3 t2,
// j = 1: b3 Y3), as field.cuh's Fp2 mul.
template <int L>
__device__ __forceinline__ void by_b3(Fp2<L>& r, const Scratch6G2<L>& s,
                                      int j, const Consts<L>& c) {
  Fp<L> m0, m1, m2;
  ld(m0, s.q[3 * j]);
  ld(m1, s.q[3 * j + 1]);
  ld(m2, s.q[3 * j + 2]);
  sub(m2, m2, m0, c);
  sub(r.c1, m2, m1, c);
  if (c.nr_is_m1) {
    sub(r.c0, m0, m1, c);
  } else {
    ld(m1, s.q[6 + j]);
    add(r.c0, m0, m1, c);
  }
}

// The operands of level 3: 0 t4 = P4 - (P1 + P2), 1 t3 = P3 - (P0 + P1),
// 2 b3 Y3 (Y3 = P5 - (P0 + P2)), 3 t1 - b3 t2, 4 3 t0, 5 Z3 = t1 + b3 t2.
template <int L>
__device__ __forceinline__ void operand_g2(Fp2<L>& r, int k,
                                           const Scratch6G2<L>& s,
                                           const Consts<L>& c) {
  Fp2<L> u, v;
  const auto& P = s.p;
  switch (k) {
    case 0:
    case 1:
      ld(r, P[k == 0 ? 4 : 3]);
      ld(u, P[1]);
      ld(v, P[k == 0 ? 2 : 0]);
      add(u, u, v, c);
      sub(r, r, u, c);
      break;
    case 2:
      by_b3(r, s, 1, c);
      break;
    case 4:
      ld(u, P[0]);
      add(r, u, u, c);
      add(r, r, u, c);
      break;
    default:  // 3 and 5
      ld(u, P[1]);
      by_b3(v, s, 0, c);
      if (k == 3) {
        sub(r, u, v, c);
      } else {
        add(r, u, v, c);
      }
  }
}

// O = A + B on G2, thread r of the group.  Points are rows of int32 12-bit
// limbs (each coordinate 2L: c0 then c1), as the kernels' boundary; O may
// alias A or B.  At level 2 each thread computes one of the six Fp products
// of the two Karatsuba products by b3 (and, for nr != -1, thread 1 and 4
// the product by nr of theirs).
template <int L>
__device__ __forceinline__ void add6_g2(int32_t (*O)[2 * L],
                                        int32_t (*A)[2 * L],
                                        int32_t (*B)[2 * L],
                                        Scratch6G2<L>& s, int r, bool act,
                                        const Consts<L>& c) {
  using E = Fp2<L>;
  using F = Fp<L>;
  // level 1: product r of the two points' coordinates (or their sums)
  if (act) {
    const int i0 = r == 4 ? 1 : (r < 3 ? r : 0);
    E a, b;
    load(a, A[i0]);
    load(b, B[i0]);
    if (r >= 3) {
      const int i1 = r == 3 ? 1 : 2;
      E a1, b1;
      load(a1, A[i1]);
      load(b1, B[i1]);
      add(a, a, a1, c);
      add(b, b, b1, c);
    }
    mul(a, a, b, c);
    st(s.p[r], a);
  }
  __syncwarp();

  // level 2: part r % 3 of b3 t2 (r < 3) or of b3 Y3
  if (act) {
    E u, b3;
    ld(u, s.p[2]);
    if (r >= 3) {
      E t0, y;
      ld(t0, s.p[0]);
      ld(y, s.p[5]);
      add(t0, t0, u, c);
      sub(u, y, t0, c);
    }
    set_b3(b3, c);
    const int part = r % 3;
    F x, y;
    if (part == 0) {
      x = u.c0;
      y = b3.c0;
    } else if (part == 1) {
      x = u.c1;
      y = b3.c1;
    } else {
      add(x, u.c0, u.c1, c);
      add(y, b3.c0, b3.c1, c);
    }
    mul(x, x, y, c);
    st(s.q[r], x);
    if (part == 1 && !c.nr_is_m1) {
      set_words(y, c.nr);
      mul(x, y, x, c);
      st(s.q[6 + r / 3], x);
    }
  }
  __syncwarp();

  // level 3: X3 = t4 b3Y3, t2 = t3 t1', Y3 = b3Y3 3t0, t1 = t1' Z3,
  // t0 = 3t0 t3, Z3 = Z3 t4 (t1' = t1 - b3 t2, Z3 = t1 + b3 t2)
  E a, b;
  if (act) {
    operand_g2(a, r, s, c);
    operand_g2(b, r < 4 ? r + 2 : 5 - r, s, c);
  }
  __syncwarp();  // every level-1 product is read before it is overwritten
  if (act) {
    mul(a, a, b, c);
    st(s.p[r], a);
  }
  __syncwarp();

  // X3 = t2 - X3, Y3 = t1 + Y3, Z3 = Z3 + t0: products 2r + 1 and 2r
  if (act && r < 3) {
    ld(a, s.p[2 * r + 1]);
    ld(b, s.p[2 * r]);
    if (r == 0) {
      sub(a, a, b, c);
    } else {
      add(a, a, b, c);
    }
    store(O[r], a);
  }
  __syncwarp();
}

}  // namespace
