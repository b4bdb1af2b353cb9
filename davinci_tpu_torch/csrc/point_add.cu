// Complete projective point addition (RCB15 Algorithm 7, a = 0) for short
// Weierstrass curves over a prime field (G1, B1) and its quadratic
// extension (G2, B7).  Built once per limb count (-DDAVINCI_L): L = 22
// (BN254) and L = 32 (BLS12-381/377), both kernels at both, and L = 64
// (BW6-761, whose G1 and G2 both lie over Fp), B1 alone: no Fp2 curve has
// L = 64, so B7 is left out of that build.  At L = 64 an add's 24-word
// coordinates do not fit one thread's registers: B1 spills to local
// memory there (ptxas's report, PERF.md), a first build that is right
// before it is fast.
//
// Replaces the TPU kernels davinci_tpu/ec/pallas_add.py::_point_add_kernel
// (B1, G1) and ::_point_add2_kernel (B7, G2, Karatsuba Fp2 mul).
//
// Boundary: each coordinate is L int32 12-bit limbs (G2: 2 x L, the c0
// limbs then the c1 limbs) in Montgomery form with the reference's radix
// R = 2^(12 L): B1 takes limb-major (L, n) planes or row-major (n, L)
// rows, B7 row-major (n, 2, L) rows.  The field arithmetic and the RCB15 formula are field.cuh's;
// outputs are canonical, so both kernels equal the plain PyTorch
// composition limb for limb.
//
// B1 works on limb-major planes: each coordinate is (L, n), limb j of add i
// at j * n + i, the layout of the reference kernel's (L, TILE_N) blocks and
// of the point-add experiment (csrc/addk.cu).  One thread per add, so a
// warp's load or store of one limb covers 32 consecutive words: every
// access is coalesced.  The strict formula of field.cuh (`rcb15`, every
// value canonical) with the field's Consts passed by value, which the card
// keeps in its constant bank.  What bounds it on the card: a complete add
// moves 9 coordinates of 4 L bytes and does 14 field products of about
// 2 N^2 word products each; the bytes bound it at both L (3.35 TB/s), the
// multiplies at the card's integer rate take half their time at L = 22
// and three quarters at L = 32.  Row callers (DeviceCurve.add) get the
// same body built for rows (point_add_rows_kernel): each coordinate's
// block of rows is staged through shared memory, so its accesses are
// coalesced too.
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

constexpr int B1_THREADS = 128;
constexpr int B1_STRIDE = LIMBS + 1;  // words per row of a row tile

// One coordinate of this thread's add, element first + t.  On planes it
// is read in place (limb j at j * n).  Rows are staged through the
// block's tile s: the block's count rows are count * L consecutive words,
// read by consecutive threads, each row padded to L + 1 words so that a
// thread reading its own row out of the tile hits distinct banks.
template <bool ROWS>
__device__ __forceinline__ void load_coord(F& x, const int32_t* src,
                                           int32_t* s, long long first,
                                           int count, int t, long long n) {
  if constexpr (ROWS) {
    __syncthreads();  // the tile's last readers are done
    const int32_t* g = src + first * LIMBS;
    for (int w = t; w < count * LIMBS; w += B1_THREADS) {
      const int e = w / LIMBS;
      s[e * B1_STRIDE + (w - e * LIMBS)] = g[w];
    }
    __syncthreads();
    load(x, s + t * B1_STRIDE);
  } else {
    load(x, src + first + t, n);
  }
}

template <bool ROWS>
__device__ __forceinline__ void store_coord(int32_t* dst, const F& x,
                                            int32_t* s, long long first,
                                            int count, int t, long long n) {
  if constexpr (ROWS) {
    __syncthreads();
    if (t < count) store(s + t * B1_STRIDE, x);
    __syncthreads();
    int32_t* g = dst + first * LIMBS;
    for (int w = t; w < count * LIMBS; w += B1_THREADS) {
      const int e = w / LIMBS;
      g[w] = s[e * B1_STRIDE + (w - e * LIMBS)];
    }
  } else {
    store(dst + first + t, x, n);
  }
}

// The body of both B1 entries: planes (s unused) or rows (s the block's
// tile, B1_THREADS rows).  A rows thread past the end computes on a stale
// tile row and stores nothing; it stays for the block's barriers.
template <bool ROWS>
__device__ __forceinline__ void add_g1(
    const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
    const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
    const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
    int32_t* __restrict__ x3, int32_t* __restrict__ y3,
    int32_t* __restrict__ z3, const Cst& c, long long n, int32_t* s) {
  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * B1_THREADS;
  const int count = (int)(n - first < B1_THREADS ? n - first : B1_THREADS);
  if (!ROWS && t >= count) return;
  F X1, Y1, Z1, X2, Y2, Z2, b3, X3, Y3, Z3;
  load_coord<ROWS>(X1, x1, s, first, count, t, n);
  load_coord<ROWS>(Y1, y1, s, first, count, t, n);
  load_coord<ROWS>(Z1, z1, s, first, count, t, n);
  load_coord<ROWS>(X2, x2, s, first, count, t, n);
  load_coord<ROWS>(Y2, y2, s, first, count, t, n);
  load_coord<ROWS>(Z2, z2, s, first, count, t, n);
  set_b3(b3, c);
  rcb15(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, b3, c);
  store_coord<ROWS>(x3, X3, s, first, count, t, n);
  store_coord<ROWS>(y3, Y3, s, first, count, t, n);
  store_coord<ROWS>(z3, Z3, s, first, count, t, n);
}

__global__ void __launch_bounds__(B1_THREADS)
    point_add_kernel(const int32_t* __restrict__ x1,
                     const int32_t* __restrict__ y1,
                     const int32_t* __restrict__ z1,
                     const int32_t* __restrict__ x2,
                     const int32_t* __restrict__ y2,
                     const int32_t* __restrict__ z2, int32_t* __restrict__ x3,
                     int32_t* __restrict__ y3, int32_t* __restrict__ z3,
                     const Cst c, long long n) {
  add_g1<false>(x1, y1, z1, x2, y2, z2, x3, y3, z3, c, n, nullptr);
}

__global__ void __launch_bounds__(B1_THREADS)
    point_add_rows_kernel(const int32_t* __restrict__ x1,
                          const int32_t* __restrict__ y1,
                          const int32_t* __restrict__ z1,
                          const int32_t* __restrict__ x2,
                          const int32_t* __restrict__ y2,
                          const int32_t* __restrict__ z2,
                          int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                          int32_t* __restrict__ z3, const Cst c, long long n) {
  __shared__ int32_t tile[B1_THREADS * B1_STRIDE];
  add_g1<true>(x1, y1, z1, x2, y2, z2, x3, y3, z3, c, n, tile);
}

#if DAVINCI_L <= 32  // B7: Fp2 only, and no Fp2 curve has L = 64

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

#endif  // DAVINCI_L <= 32

Cst consts_of(const uint32_t* words) {
  Cst c;
  std::memcpy(&c, words, sizeof(c));
  return c;
}

}  // namespace

// consts: the uint32 words of struct Consts (field.cuh).  B1's nine
// arguments are (L, n) planes, or (n, L) rows where `rows` is nonzero;
// B7's are (n, 2, L) rows.  Returns the launch's cudaGetLastError() code
// (0 on success).
extern "C" int davinci_point_add_g1(const int32_t* x1, const int32_t* y1,
                                    const int32_t* z1, const int32_t* x2,
                                    const int32_t* y2, const int32_t* z2,
                                    int32_t* x3, int32_t* y3, int32_t* z3,
                                    const uint32_t* consts, long long n,
                                    long long rows, void* stream) {
  const long long blocks = (n + B1_THREADS - 1) / B1_THREADS;
  auto kernel = rows ? point_add_rows_kernel : point_add_kernel;
  kernel<<<(unsigned)blocks, B1_THREADS, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, x3, y3, z3, consts_of(consts), n);
  return (int)cudaGetLastError();
}

#if DAVINCI_L <= 32
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
#endif  // DAVINCI_L <= 32
