// B6: the batched Montgomery product REDC(a * b) = a * b * R^-1 mod p, one
// thread per element, for any modulus the caller passes (p, -p^-1 mod 2^32
// and R mod p in the Consts words, as the TPU kernel takes p_limbs and
// np_limbs).  Built once per limb count (-DDAVINCI_L): L = 22 (BN254 Fr/Fp,
// BLS12-377/381 Fr), L = 32 (BLS12-377/381 Fp, BW6-761 Fr) and L = 64
// (BW6-761 Fp).
//
// Replaces the TPU kernel davinci_tpu/ff/pallas_mul.py::_mont_mul_kernel.
// It computes what that kernel computes (the product, m = t * n' mod R,
// (t + m p) / R, a conditional subtract), interleaved word by word as
// field.cuh's CIOS loop rather than tile by tile.
//
// Boundary: a and b are row-major (na, L) and (nb, L) int32 12-bit limbs;
// element i reads row i % na of a and i % nb of b (a row count of 1
// broadcasts one value), out is (n, L), canonical, limb-equal to the plain
// PyTorch version.  As in the reference's DeviceField.mul, one operand may
// be any raw value below R (to_mont's input, 264 bits at L = 22): it goes
// into the CIOS loop with its extra word, the other operand must be below p.
//
// What bounds it on the card: bytes.  An element moves 3 * 4 L bytes (264
// at L = 22) for 153 32-bit multiplies (8 x 9 for the product, 8 x 8 + 8
// for the reduction, 9 low halves); at 3.35 TB/s the bytes take about
// nine times as long as the multiplies at the card's integer rate
// (132 SMs x 64 per clock x 1.98 GHz).  So a block of T threads moves its
// T consecutive rows of each operand, and of the output, through shared
// memory: consecutive threads read and write consecutive 32-bit words of
// the tile, which is contiguous in global memory, so every access is
// coalesced, and any 4-byte-aligned base works.  A tile row is padded to
// L + 1 words (odd), so the threads reading their own rows out of the tile
// hit distinct banks.  An operand with fewer rows than T (a broadcast row,
// a short repeating table) is staged whole, once per block.  The product
// itself is field.cuh's CIOS, unchanged.  At L = 64 a block holds 64 rows:
// two tiles of 128 rows of 65 words would be 66,560 B, over the 48 KB of
// static shared memory a block may have; 64 keeps them at 33,280 B.

#include <cstring>

#include "field.cuh"

namespace {

constexpr int LIMBS = DAVINCI_L;
constexpr int T = LIMBS > 32 ? 64 : 128;  // elements (threads) per block
constexpr int STRIDE = LIMBS + 1;      // words per tile row

// Stage the rows of an (rows, L) operand that elements first .. first +
// count - 1 read (element i reads row i % rows) into the tile s; returns
// the tile row that element first + t reads.  With rows >= T the tile
// holds the count rows from first % rows on, wrapping at most once; with
// fewer, it holds every row.
__device__ __forceinline__ int stage(int32_t* s, const int32_t* __restrict__ src,
                                     long long rows, long long first,
                                     int count, int t) {
  const long long r0 = first < rows ? first : first % rows;
  if (rows >= T) {
    for (int w = t; w < count * LIMBS; w += T) {
      const int e = w / LIMBS, j = w - e * LIMBS;
      long long r = r0 + e;
      if (r >= rows) r -= rows;
      s[e * STRIDE + j] = src[r * LIMBS + j];
    }
    return t;
  }
  const int nr = (int)rows;
  for (int w = t; w < nr * LIMBS; w += T) {
    const int e = w / LIMBS, j = w - e * LIMBS;
    s[e * STRIDE + j] = src[w];
  }
  return ((int)r0 + t) % nr;  // r0 < nr < T
}

template <int L>
__global__ void __launch_bounds__(T)
    mont_mul_kernel(const int32_t* __restrict__ a, long long na,
                    const int32_t* __restrict__ b, long long nb,
                    int32_t* __restrict__ out, const Consts<L> c,
                    long long n) {
  __shared__ int32_t sa[T * STRIDE], sb[T * STRIDE];
  constexpr int N = Radix<L>::N, NR = Radix<L>::NR;
  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * T;
  const int count = (int)(n - first < T ? n - first : T);
  const int ra = stage(sa, a, na, first, count, t);
  const int rb = stage(sb, b, nb, first, count, t);
  __syncthreads();
  uint32_t x[NR], y[NR];
  load_words<L>(x, sa + ra * STRIDE);
  load_words<L>(y, sb + rb * STRIDE);
  if constexpr (NR > N) {
    // a raw operand at or above 2^(32 N) rides the extra word: put it first
    if (y[N] != 0) {
#pragma unroll
      for (int k = 0; k < NR; k++) {
        const uint32_t v = x[k];
        x[k] = y[k];
        y[k] = v;
      }
    }
  }
  Fp<L> yb, r;
#pragma unroll
  for (int k = 0; k < N; k++) yb.w[k] = y[k];
  mont_mul(r, x, yb, c);
  __syncthreads();  // every thread has read its rows: sa takes the output
  if (t < count) store(sa + t * STRIDE, r);
  __syncthreads();
  int32_t* dst = out + first * LIMBS;
  for (int w = t; w < count * LIMBS; w += T) {
    const int e = w / LIMBS;
    dst[w] = sa[e * STRIDE + (w - e * LIMBS)];
  }
}

}  // namespace

// consts: the uint32 words of struct Consts (field.cuh; only p, np0 are
// read).  Returns the launch's cudaGetLastError() code (0 on success).
extern "C" int davinci_mont_mul(const int32_t* a, const int32_t* b,
                                int32_t* out, const uint32_t* consts,
                                long long na, long long nb, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  Consts<LIMBS> c;
  std::memcpy(&c, consts, sizeof(c));
  const long long blocks = (n + T - 1) / T;
  mont_mul_kernel<LIMBS><<<(unsigned)blocks, T, 0, (cudaStream_t)stream>>>(
      a, na, b, nb, out, c, n);
  return (int)cudaGetLastError();
}
