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
// B7 gives each G2 add a group of six threads of one warp (group6.cuh's
// add6_g2).  RCB15's 14 Fp2 products fall into three levels of independent
// products (six, two, six): at levels 1 and 3 each thread computes one Fp2
// product, at level 2 each computes one of the six Fp products of the two
// Karatsuba products by b3.  Intermediates pass through shared memory
// between levels, separated by __syncwarp().  So one add waits on about 7 Fp products in a row (10
// where the non-residue is not -1: its product by nr follows t1), not 42,
// and a thread holds the operands of one Fp2 product rather than six Fp2
// coordinates, which is what lets L = 32 build.  A warp holds five adds
// (lanes 30 and 31 only move data) and loads and stores their rows
// together, so its global accesses cover consecutive words.  What bounds it
// on the card: the adds' bytes (9 coordinates of 2L words each) against
// 42 Fp products; for one add (the G2 Horner's launches), the latency of
// those 7-10 products.

#include <cstring>

#include "group6.cuh"

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

constexpr int ADDS = GROUPS;      // adds per warp (group6.cuh)
constexpr int WARPS = 2;          // warps per block
constexpr int ROW = 2 * LIMBS;    // int32 limbs of one Fp2 coordinate

// One warp's shared memory: the input rows X1 Y1 Z1 X2 Y2 Z2 of each add,
// then X3 Y3 Z3, and the adds' intermediates.
struct Tile {
  int32_t rows[ADDS][6][ROW];
  Scratch6G2<LIMBS> x[ADDS];
};

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
  // lanes without an add name a real slot, chosen from the lane alone (a
  // slot that depends on count cost ptxas an 8-byte spill)
  const int gs = g < ADDS ? g : 0;
  add6_g2<LIMBS>(s.rows[gs], s.rows[gs], s.rows[gs] + 3, s.x[gs], r, act, c);
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
