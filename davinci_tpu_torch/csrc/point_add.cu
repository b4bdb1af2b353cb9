// Complete projective point addition (RCB15 Algorithm 7, a = 0) for short
// Weierstrass curves over a prime field (G1) and its quadratic extension
// (G2), one thread per point.  Built once per limb count (-DDAVINCI_L):
// G1 at L = 22 (BN254) and L = 32 (BLS12-381/377), G2 at L = 22 only.
//
// Replaces the TPU kernels davinci_tpu/ec/pallas_add.py::_point_add_kernel
// (B1, G1) and ::_point_add2_kernel (B7, G2, Karatsuba Fp2 mul with the
// nr = -1 shortcut).
//
// Boundary: each coordinate is L int32 12-bit limbs (G2: 2 x L, the c0
// limbs then the c1 limbs), row-major (N, L) / (N, 2, L), in Montgomery
// form with the reference's radix R = 2^(12 L).  The field arithmetic and
// the RCB15 formula are field.cuh's.
//
// What bounds it on the card: integer multiply throughput (a G1 add is 14
// field muls of N^2 32x32->64 products each plus their reductions) and
// registers.  Six Fp2 coordinates at L = 22 are 96 live words before any
// temporary: ptxas (CUDA 12.8, sm_90a) gives the G2 kernel the cap of 255
// registers with no spill, the G1 kernel 108, so a 128-thread block of G2
// adds leaves room for two blocks per SM.  Each thread reads and writes
// its own rows, so global accesses are not coalesced; a transposed (L, N)
// layout, wider multiplies and the register budget of G2 are later work.

#include <cstring>

#include "field.cuh"

namespace {

constexpr int LIMBS = DAVINCI_L;

template <typename E>
__global__ void point_add_kernel(const int32_t* __restrict__ x1,
                                 const int32_t* __restrict__ y1,
                                 const int32_t* __restrict__ z1,
                                 const int32_t* __restrict__ x2,
                                 const int32_t* __restrict__ y2,
                                 const int32_t* __restrict__ z2,
                                 int32_t* __restrict__ x3,
                                 int32_t* __restrict__ y3,
                                 int32_t* __restrict__ z3,
                                 const Consts<E::L> c, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // limbs per coordinate
  constexpr int W = (int)(sizeof(E) / sizeof(Fp<E::L>)) * E::L;
  const long long o = i * W;
  E X1, Y1, Z1, X2, Y2, Z2, b3, X3, Y3, Z3;
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

template <typename E>
int launch(const int32_t* x1, const int32_t* y1, const int32_t* z1,
           const int32_t* x2, const int32_t* y2, const int32_t* z2,
           int32_t* x3, int32_t* y3, int32_t* z3, const uint32_t* consts,
           long long n, void* stream) {
  Consts<E::L> c;
  std::memcpy(&c, consts, sizeof(c));
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  point_add_kernel<E><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, x3, y3, z3, c, n);
  return (int)cudaGetLastError();
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
  return launch<Fp<LIMBS>>(x1, y1, z1, x2, y2, z2, x3, y3, z3, consts, n,
                           stream);
}

#if DAVINCI_L == 22
extern "C" int davinci_point_add_g2(const int32_t* x1, const int32_t* y1,
                                    const int32_t* z1, const int32_t* x2,
                                    const int32_t* y2, const int32_t* z2,
                                    int32_t* x3, int32_t* y3, int32_t* z3,
                                    const uint32_t* consts, long long n,
                                    void* stream) {
  return launch<Fp2<LIMBS>>(x1, y1, z1, x2, y2, z2, x3, y3, z3, consts, n,
                            stream);
}
#endif
