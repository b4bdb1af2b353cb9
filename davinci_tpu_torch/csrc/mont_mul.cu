// B6: the batched Montgomery product REDC(a * b) = a * b * R^-1 mod p, one
// thread per element, for any modulus the caller passes (p, -p^-1 mod 2^32
// and R mod p in the Consts words, as the TPU kernel takes p_limbs and
// np_limbs).  Built once per limb count (-DDAVINCI_L): L = 22 (BN254 Fr/Fp,
// BLS12-377/381 Fr) and L = 32 (BLS12-377/381 Fp, BW6-761 Fr).
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
// (132 SMs x 64 per clock x 1.98 GHz).  Each thread reads and
// writes its own 88- or 128-byte row, so a warp's accesses are not
// coalesced; a transposed (L, n) layout or a staged copy through shared
// memory, and several elements per thread, are later work.

#include <cstring>

#include "field.cuh"

namespace {

constexpr int LIMBS = DAVINCI_L;
constexpr int THREADS = 128;

template <int L>
__global__ void __launch_bounds__(THREADS)
    mont_mul_kernel(const int32_t* __restrict__ a, long long na,
                    const int32_t* __restrict__ b, long long nb,
                    int32_t* __restrict__ out, const Consts<L> c,
                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int N = Radix<L>::N, NR = Radix<L>::NR;
  const long long ia = na == n ? i : i % na;
  const long long ib = nb == n ? i : i % nb;
  uint32_t x[NR], y[NR];
  load_words<L>(x, a + ia * L);
  load_words<L>(y, b + ib * L);
  if constexpr (NR > N) {
    // a raw operand at or above 2^(32 N) rides the extra word: put it first
    if (y[N] != 0) {
#pragma unroll
      for (int k = 0; k < NR; k++) {
        const uint32_t t = x[k];
        x[k] = y[k];
        y[k] = t;
      }
    }
  }
  Fp<L> yb, r;
#pragma unroll
  for (int k = 0; k < N; k++) yb.w[k] = y[k];
  mont_mul(r, x, yb, c);
  store(out + i * L, r);
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
  const long long blocks = (n + THREADS - 1) / THREADS;
  mont_mul_kernel<LIMBS><<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(a, na, b, nb, out, c, n);
  return (int)cudaGetLastError();
}
