// Complete projective point addition (RCB15 Algorithm 7, a = 0) for short
// Weierstrass curves over a prime field (G1, B1) and its quadratic
// extension (G2, B7).  Built once per limb count (-DDAVINCI_L): L = 22
// (BN254) and L = 32 (BLS12-381/377), both kernels at both.
//
// Replaces the TPU kernels davinci_tpu/ec/pallas_add.py::_point_add_kernel
// (B1, G1) and ::_point_add2_kernel (B7, G2, Karatsuba Fp2 mul).
//
// Boundary: each coordinate is L int32 12-bit limbs (G2: 2 x L, the c0
// limbs then the c1 limbs), row-major (N, L) / (N, 2, L), in Montgomery
// form with the reference's radix R = 2^(12 L).  The field arithmetic and
// the RCB15 formula are field.cuh's; outputs are canonical, so both kernels
// equal the plain PyTorch composition limb for limb.
//
// B1 gives one thread to each point: integer multiply throughput (a G1 add
// is 14 field muls of N^2 32x32->64 products each plus their reductions)
// and registers bound it (108 at L = 22, 248 at L = 32).
//
// B7 gives each G2 add a group of six threads of one warp.  RCB15's 14 Fp2
// products fall into three levels of independent products (six, two,
// six): at levels 1 and 3 each thread computes one Fp2 product, at level 2
// each computes one of the six Fp products of the two Karatsuba products by
// b3.  Intermediates pass through shared memory between levels, separated
// by __syncwarp().  So one add waits on about 7 Fp products in a row (10
// where the non-residue is not -1: its product by nr follows t1), not 42,
// and a thread holds the operands of one Fp2 product rather than six Fp2
// coordinates, which is what lets L = 32 build.  A warp holds five adds
// (lanes 30 and 31 only move data) and loads and stores their rows
// together, so its global accesses cover consecutive words.  What bounds it
// on the card: the adds' bytes (9 coordinates of 2L words each) against
// 42 Fp products; for one add (the G2 Horner's launches), the latency of
// those 7-10 products.

#include <cstring>

#include "field.cuh"

namespace {

constexpr int LIMBS = DAVINCI_L;
using F = Fp<LIMBS>;
using E = Fp2<LIMBS>;
using Cst = Consts<LIMBS>;
constexpr int N = F::N;

// -- B1 ----------------------------------------------------------------------

__global__ void point_add_kernel(const int32_t* __restrict__ x1,
                                 const int32_t* __restrict__ y1,
                                 const int32_t* __restrict__ z1,
                                 const int32_t* __restrict__ x2,
                                 const int32_t* __restrict__ y2,
                                 const int32_t* __restrict__ z2,
                                 int32_t* __restrict__ x3,
                                 int32_t* __restrict__ y3,
                                 int32_t* __restrict__ z3, const Cst c,
                                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * LIMBS;
  F X1, Y1, Z1, X2, Y2, Z2, b3, X3, Y3, Z3;
  load(X1, x1 + o);
  load(Y1, y1 + o);
  load(Z1, z1 + o);
  load(X2, x2 + o);
  load(Y2, y2 + o);
  load(Z2, z2 + o);
  set_b3(b3, c);
  rcb15(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, b3, c);
  store(x3 + o, X3);
  store(y3 + o, Y3);
  store(z3 + o, Z3);
}

// -- B7 ----------------------------------------------------------------------

constexpr int GROUP = 6;             // threads per G2 add
constexpr int ADDS = 32 / GROUP;     // adds per warp
constexpr int WARPS = 2;             // warps per block
constexpr int ROW = 2 * LIMBS;       // int32 limbs of one Fp2 coordinate

// One warp's shared memory.  p[g][i] holds product i of add g at level 1
// (X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)), then
// at level 3; q[g] the Karatsuba parts m0, m1, m2 of b3 t2 (0-2) and of
// b3 Y3 (3-5) and, for nr != -1, nr m1 of each (6, 7).
struct Tile {
  int32_t rows[ADDS][6][ROW];  // input rows X1 Y1 Z1 X2 Y2 Z2, then X3 Y3 Z3
  uint32_t p[ADDS][6][2][N];
  uint32_t q[ADDS][8][N];
};

__device__ __forceinline__ void get(F& r, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = w[k];
}

__device__ __forceinline__ void put(uint32_t* w, const F& a) {
#pragma unroll
  for (int k = 0; k < N; k++) w[k] = a.w[k];
}

__device__ __forceinline__ void get(E& r, const uint32_t (&w)[2][N]) {
  get(r.c0, w[0]);
  get(r.c1, w[1]);
}

__device__ __forceinline__ void put(uint32_t (&w)[2][N], const E& a) {
  put(w[0], a.c0);
  put(w[1], a.c1);
}

// u * b3 from its parts: c0 = m0 + nr m1, c1 = m2 - m0 - m1 (j = 0: b3 t2,
// j = 1: b3 Y3), as field.cuh's Fp2 mul.
__device__ __forceinline__ void by_b3(E& r, const uint32_t (&q)[8][N], int j,
                                      const Cst& c) {
  F m0, m1, m2;
  get(m0, q[3 * j]);
  get(m1, q[3 * j + 1]);
  get(m2, q[3 * j + 2]);
  sub(m2, m2, m0, c);
  sub(r.c1, m2, m1, c);
  if (c.nr_is_m1) {
    sub(r.c0, m0, m1, c);
  } else {
    get(m1, q[6 + j]);
    add(r.c0, m0, m1, c);
  }
}

// The operands of level 3: 0 t4 = P4 - (P1 + P2), 1 t3 = P3 - (P0 + P1),
// 2 b3 Y3 (Y3 = P5 - (P0 + P2)), 3 t1 - b3 t2, 4 3 t0, 5 Z3 = t1 + b3 t2.
__device__ __forceinline__ void operand(E& r, int k, const Tile& s, int g,
                                        const Cst& c) {
  E u, v;
  const auto& P = s.p[g];
  switch (k) {
    case 0:
    case 1:
      get(r, P[k == 0 ? 4 : 3]);
      get(u, P[1]);
      get(v, P[k == 0 ? 2 : 0]);
      add(u, u, v, c);
      sub(r, r, u, c);
      break;
    case 2:
      by_b3(r, s.q[g], 1, c);
      break;
    case 4:
      get(u, P[0]);
      add(r, u, u, c);
      add(r, r, u, c);
      break;
    default:  // 3 and 5
      get(u, P[1]);
      by_b3(v, s.q[g], 0, c);
      if (k == 3) {
        sub(r, u, v, c);
      } else {
        add(r, u, v, c);
      }
  }
}

__global__ void __launch_bounds__(32 * WARPS)
    point_add_g2_kernel(const int32_t* __restrict__ x1,
                        const int32_t* __restrict__ y1,
                        const int32_t* __restrict__ z1,
                        const int32_t* __restrict__ x2,
                        const int32_t* __restrict__ y2,
                        const int32_t* __restrict__ z2,
                        int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                        int32_t* __restrict__ z3, const Cst c, long long n) {
  __shared__ Tile tiles[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Tile& s = tiles[warp];
  const long long first = ((long long)blockIdx.x * WARPS + warp) * ADDS;
  if (first >= n) return;  // the whole warp: no __syncwarp is left waiting
  const int count = (int)(n - first < ADDS ? n - first : ADDS);
  const int g = lane / GROUP, r = lane % GROUP;
  const bool act = g < count;

  // the warp's rows of each input are count * ROW consecutive words
  const int32_t* in[6] = {x1, y1, z1, x2, y2, z2};
#pragma unroll
  for (int k = 0; k < 6; k++) {
    const int32_t* src = in[k] + first * ROW;
    for (int i = lane; i < count * ROW; i += 32)
      s.rows[i / ROW][k][i % ROW] = src[i];
  }
  __syncwarp();

  // level 1: product r of the two points' coordinates (or their sums)
  if (act) {
    const int i0 = r == 4 ? 1 : (r < 3 ? r : 0);
    E a, b;
    load(a, s.rows[g][i0]);
    load(b, s.rows[g][3 + i0]);
    if (r >= 3) {
      const int i1 = r == 3 ? 1 : 2;
      E a1, b1;
      load(a1, s.rows[g][i1]);
      load(b1, s.rows[g][3 + i1]);
      add(a, a, a1, c);
      add(b, b, b1, c);
    }
    mul(a, a, b, c);
    put(s.p[g][r], a);
  }
  __syncwarp();

  // level 2: part r % 3 of b3 t2 (r < 3) or of b3 Y3
  if (act) {
    E u, b3;
    get(u, s.p[g][2]);
    if (r >= 3) {
      E t0, y;
      get(t0, s.p[g][0]);
      get(y, s.p[g][5]);
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
    put(s.q[g][r], x);
    if (part == 1 && !c.nr_is_m1) {
      set_words(y, c.nr);
      mul(x, y, x, c);
      put(s.q[g][6 + r / 3], x);
    }
  }
  __syncwarp();

  // level 3: X3 = t4 b3Y3, t2 = t3 t1', Y3 = b3Y3 3t0, t1 = t1' Z3,
  // t0 = 3t0 t3, Z3 = Z3 t4 (t1' = t1 - b3 t2, Z3 = t1 + b3 t2)
  E a, b;
  if (act) {
    operand(a, r, s, g, c);
    operand(b, r < 4 ? r + 2 : 5 - r, s, g, c);
  }
  __syncwarp();  // every level-1 product is read before it is overwritten
  if (act) {
    mul(a, a, b, c);
    put(s.p[g][r], a);
  }
  __syncwarp();

  // X3 = t2 - X3, Y3 = t1 + Y3, Z3 = Z3 + t0: products 2r + 1 and 2r
  if (act && r < 3) {
    get(a, s.p[g][2 * r + 1]);
    get(b, s.p[g][2 * r]);
    if (r == 0) {
      sub(a, a, b, c);
    } else {
      add(a, a, b, c);
    }
    store(s.rows[g][r], a);
  }
  __syncwarp();
  int32_t* out[3] = {x3, y3, z3};
#pragma unroll
  for (int k = 0; k < 3; k++) {
    int32_t* dst = out[k] + first * ROW;
    for (int i = lane; i < count * ROW; i += 32)
      dst[i] = s.rows[i / ROW][k][i % ROW];
  }
}

Cst consts_of(const uint32_t* words) {
  Cst c;
  std::memcpy(&c, words, sizeof(c));
  return c;
}

}  // namespace

// consts: the uint32 words of struct Consts (field.cuh).  Returns the launch's
// cudaGetLastError() code (0 on success).
extern "C" int davinci_point_add_g1(const int32_t* x1, const int32_t* y1,
                                    const int32_t* z1, const int32_t* x2,
                                    const int32_t* y2, const int32_t* z2,
                                    int32_t* x3, int32_t* y3, int32_t* z3,
                                    const uint32_t* consts, long long n,
                                    void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  point_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, x3, y3, z3, consts_of(consts), n);
  return (int)cudaGetLastError();
}

extern "C" int davinci_point_add_g2(const int32_t* x1, const int32_t* y1,
                                    const int32_t* z1, const int32_t* x2,
                                    const int32_t* y2, const int32_t* z2,
                                    int32_t* x3, int32_t* y3, int32_t* z3,
                                    const uint32_t* consts, long long n,
                                    void* stream) {
  const long long per_block = (long long)ADDS * WARPS;
  const long long blocks = (n + per_block - 1) / per_block;
  point_add_g2_kernel<<<(unsigned)blocks, 32 * WARPS, 0,
                        (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, x3, y3, z3, consts_of(consts), n);
  return (int)cudaGetLastError();
}
