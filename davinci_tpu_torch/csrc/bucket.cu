// The bucket-scan MSM path's kernels, built once per limb count
// (-DDAVINCI_L): L = 22 (BN254), L = 32 (BLS12-381/377) and L = 64 (BW6-761
// G1 and G2, both over Fp; B5's G2 build serves Fp2 and is left out there):
//
//   B2 davinci_bucket_scan_g1    replaces davinci_tpu/msm/bucket_kernel.py
//                                ::_scan_kernel (sorted-stream bucket scan)
//   B3 davinci_bucket_reduce_g1  ::_reduce_kernel (per-lane A = sum S_k,
//                                B = sum k S_k of the bucket arrays)
//   B4 davinci_suffix_reduce_g1  ::_suffix_reduce_kernel (the same sums
//                                over the leading axis of (K, 3L, M))
//   B5 davinci_horner_g1         ::_horner_kernel (sum_w 2^(wbits w) S_w)
//   B5 davinci_horner_g2         davinci_tpu/msm/pippenger.py::_horner on
//                                G2 (the fused route's window combine,
//                                whose steps are _point_add2_kernel)
//
// The TPU kernels carry an accumulator in VMEM across sequential grid
// steps.  Here a loop walks the sequential axis: B4 gives one thread to a
// chunk of a lane (see below), its accumulators in registers; B2 and B5
// give a lane six threads of a warp, which share each add (group6.cuh) and
// keep the accumulator in shared memory, and B3 two such groups, one for
// each of its two sums.  Every group operation is canonical RCB15
// (field.cuh's rcb15 / rcb15_mixed, or their six-thread forms; doublings
// are rcb15(t, t), as in the reference), so the outputs equal the plain
// PyTorch versions of msm/bucket_kernel.py limb for limb (B4:
// `_suffix_reduce_split_plain`, which adds in the kernel's order).
// Limb-major arrays are read with limb i of lane l at i * stride + l, so
// neighbouring threads touch neighbouring words.
//
// What bounds them on the card:
//   B2 moves the most bytes of the four (at n = 2^17 with 22 windows it
//   reads 0.2 GB of planes and keys and writes a 0.76 GB stream) and does
//   one mixed add (13 field muls) per point and window; at c1's 45,056
//   lanes one thread per lane left about 11 warps per SM to hide each
//   product's latency.  Six threads a lane shorten each add to two
//   products in a row and put six times the threads in flight; a block
//   reads its lanes' planes as one tile and each warp writes its lanes'
//   264-byte rows side by side, so both are coalesced.
//   B3 does 2 complete adds per bucket, 2K - 1 per lane, on Wt * C lanes
//   (5,632 at c1, K = 8): its operation bound is 0.01 ms, but one thread
//   a lane walked them as one chain of 15 adds of about 29 us each.  Two
//   six-thread groups a lane make the two sums' adds side by side: K adds
//   in a row.
//   B4 and B5 are chains of dependent adds on few lanes (B4: 2K - 1 adds on
//   each of 2 Wt lanes; B5: (W - 1)(wbits + 1) adds on one lane): latency,
//   not throughput, bounds them, far from any roofline.  B4 splits its
//   chain into P chunks of T rows walked by P threads, then combines the
//   chunk sums (about 2T + 2P + log2 T adds in a row instead of 2K: 67 at
//   K = 256, T = 16); B5 keeps the reference's chain (273 adds at c1) and
//   cuts each add's latency to two or three products in a row.

#include <cstring>

#include "group6.cuh"

namespace {

constexpr int L = DAVINCI_L;
using F = Fp<L>;
using Cst = Consts<L>;
constexpr int N = F::N;
constexpr int LP = (12 * L + 15) / 16;  // packed 16-bit planes per point
static_assert(2 * N <= LP, "the value's 32-bit words come from the planes");
constexpr int THREADS = 128;

__device__ __forceinline__ void set_identity(F& X, F& Y, F& Z,
                                             const Cst& c) {
#pragma unroll
  for (int k = 0; k < N; k++) {
    X.w[k] = 0;
    Z.w[k] = 0;
  }
  set_words(Y, c.one);
}

// B2.  planes: (rows, LP, nl) uint32 words, plane j = bits [16j, 16j+16)
// of x in the low and of y in the high half (at L = 22 plane 16 is zero
// for values below 2^256); keys: (rows, nl) sorted keys; out: (rows, nl, 3L).
// One six-thread group per lane (group6.cuh's madd6), SCAN_LANES lanes per
// block.  Per row the block reads its lanes' planes and keys as one tile
// (consecutive threads on consecutive words), each group folds its point
// into its accumulator (in shared memory), and each warp writes its lanes'
// rows, nw * 3L consecutive words, with consecutive threads on consecutive
// words.  The curve's 3b must be small or the negative of a small one
// (Consts::b3_small not 0; b3_neg for BW6-761 G1).
constexpr int SCAN_WARPS = 4;
constexpr int SCAN_LANES = SCAN_WARPS * GROUPS;

struct ScanGroup {
  Pt6<L> acc;
  Scratch6<L> x;
};

__global__ void __launch_bounds__(32 * SCAN_WARPS)
    bucket_scan_kernel(const uint32_t* __restrict__ planes,
                       const int32_t* __restrict__ keys,
                       int32_t* __restrict__ out, const Cst c,
                       long long rows, long long nl, int is_signed) {
  __shared__ uint32_t tile[LP][SCAN_LANES];
  __shared__ int32_t tkey[SCAN_LANES];
  __shared__ ScanGroup grp[SCAN_LANES];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / GROUP, r = lane % GROUP;
  const long long l0 = (long long)blockIdx.x * SCAN_LANES;
  const int nb = (int)(nl - l0 < SCAN_LANES ? nl - l0 : SCAN_LANES);
  const int w0 = warp * GROUPS;  // the warp's first lane in the block
  const int nw = nb - w0 < 0 ? 0 : (nb - w0 < GROUPS ? nb - w0 : GROUPS);
  const bool mine = g < nw;      // this group has a lane
  ScanGroup& G = grp[mine ? w0 + g : 0];
  F one, zero;
  set_words(one, c.one);
#pragma unroll
  for (int k = 0; k < N; k++) zero.w[k] = 0;
  int prev = 0;
  for (long long row = 0; row < rows; row++) {
    __syncthreads();  // the last row's tile is read
    const uint32_t* pl = planes + row * LP * nl + l0;
    for (int i = threadIdx.x; i < LP * nb; i += blockDim.x)
      tile[i / nb][i % nb] = pl[(long long)(i / nb) * nl + i % nb];
    if (threadIdx.x < nb) tkey[threadIdx.x] = keys[row * nl + l0 + threadIdx.x];
    __syncthreads();
    const int key = mine ? tkey[w0 + g] : 0;
    F x, y;
    if (mine) {
#pragma unroll
      for (int k = 0; k < N; k++) {
        const uint32_t lo = tile[2 * k][w0 + g], hi = tile[2 * k + 1][w0 + g];
        x.w[k] = (lo & 0xFFFFu) | (hi << 16);
        y.w[k] = (lo >> 16) | (hi & 0xFFFF0000u);
      }
      if (is_signed && (key & 1)) sub(y, zero, y, c);  // -P = (x, -y)
    }
    // same bucket: with signed keys (2 * bucket + sign) a run may cross
    // the sign boundary; its points are already negated
    const bool same = mine && row > 0 &&
                      (is_signed ? (key >> 1) == (prev >> 1) : key == prev);
    madd6(G.acc, G.acc, x, y, G.x, r, same, c);
    if (mine && !same && r < 3) st(G.acc.c[r], r == 0 ? x : (r == 1 ? y : one));
    __syncwarp();
    int32_t* o = out + (row * nl + l0 + w0) * (3 * L);
    for (int i = lane; i < nw * 3 * L; i += 32) {
      const int k = i % (3 * L);
      o[i] = limb_of<L>(grp[w0 + i / (3 * L)].acc.c[k / L], k % L);
    }
    prev = key;
  }
}

// B3.  s*: (L, wt, nb) views of the bucket arrays, limb j of slot k of
// window w at j * ls + w * ws + k (the MSM passes the first nb slots of
// its (L, wt, nb + 2) buckets: ws = nb + 2); a*, b*: (L, wt, cw).  Lane
// (w, col), col < cw, walks the K = nb / cw slots k cw + col from the top:
//   run_k = run_{k+1} + S_k  (k = K-1 .. 0; A = run_0),
//   B = (((O + run_{K-1}) + run_{K-2}) + ... + run_1),
// the reference's adds in its order.  The two chains of a lane are two
// six-thread groups of one warp (group6.cuh's add6): at step k the run's
// group adds S_k while the B group adds run_{k+1}, which both read before
// either writes (add6 reads its operands before its first barrier), so a
// lane waits on K adds in a row instead of 2K - 1.  Per step the block
// stages its lanes' S_k as one tile (consecutive threads on consecutive
// words), fetched into registers during the step before; the sums live in
// shared memory and leave as one coalesced tile per output.
constexpr int REDUCE_WARPS = 4;
constexpr int REDUCE_LANES = REDUCE_WARPS * 2;  // groups 2i (run), 2i + 1 (B)
constexpr int REDUCE_THREADS = 32 * REDUCE_WARPS;
// tile words per thread
constexpr int REDUCE_FETCH = (3 * L * REDUCE_LANES + REDUCE_THREADS - 1) /
                             REDUCE_THREADS;

struct ReduceLane {
  Pt6<L> run, b, s;  // the run, B, this step's S_k
  Scratch6<L> x[2];  // the run's and B's intermediates
};

__global__ void __launch_bounds__(REDUCE_THREADS)
    bucket_reduce_kernel(const int32_t* __restrict__ sx,
                         const int32_t* __restrict__ sy,
                         const int32_t* __restrict__ sz,
                         int32_t* __restrict__ ax, int32_t* __restrict__ ay,
                         int32_t* __restrict__ az, int32_t* __restrict__ bx,
                         int32_t* __restrict__ by, int32_t* __restrict__ bz,
                         const Cst c, long long wt, long long nb,
                         long long cw, long long ws, long long ls) {
  __shared__ int32_t tile[3][L][REDUCE_LANES];
  __shared__ ReduceLane lanes[REDUCE_LANES];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / GROUP, r = lane % GROUP;
  const long long t0 = (long long)blockIdx.x * REDUCE_LANES;
  const long long nl = wt * cw;
  const int nbk = (int)(nl - t0 < REDUCE_LANES ? nl - t0 : REDUCE_LANES);
  const int role = g % 2;            // 0: the run, 1: B
  const int li = warp * 2 + g / 2;   // the group's lane
  const bool mine = g / 2 < 2 && li < nbk;
  ReduceLane& R = lanes[mine ? li : 0];
  const long long K = nb / cw;
  // The thread's tile words: word i = threadIdx.x + e REDUCE_THREADS of
  // the flat tile is coordinate i / (L LANES), limb (i / LANES) % L, lane
  // i % LANES; from[e] is its source without the slot's k cw (null past
  // the block's lanes).
  const int32_t* from[REDUCE_FETCH];
#pragma unroll
  for (int e = 0; e < REDUCE_FETCH; e++) {
    const int i = threadIdx.x + e * REDUCE_THREADS;
    const int q = i % REDUCE_LANES;
    from[e] = nullptr;
    if (i < 3 * L * REDUCE_LANES && q < nbk) {
      const long long t = t0 + q;
      const int cc = i / (L * REDUCE_LANES);
      from[e] = (cc == 0 ? sx : cc == 1 ? sy : sz) +
                (i / REDUCE_LANES) % L * ls + t / cw * ws + t % cw;
    }
  }
  auto fetch = [&](int32_t (&v)[REDUCE_FETCH], long long k) {
#pragma unroll
    for (int e = 0; e < REDUCE_FETCH; e++)
      if (from[e]) v[e] = from[e][k * cw];
  };
  if (mine && r < 3) {  // run and B: the identity (0, one, 0)
    F a;
#pragma unroll
    for (int k = 0; k < N; k++) a.w[k] = r == 1 ? c.one[k] : 0u;
    st(role == 0 ? R.run.c[r] : R.b.c[r], a);
  }
  int32_t next[REDUCE_FETCH];
  fetch(next, K - 1);
  for (long long k = K - 1; k >= 0; k--) {
    __syncthreads();  // the last step's tile and S are read
#pragma unroll
    for (int e = 0; e < REDUCE_FETCH; e++)
      if (from[e]) (&tile[0][0][0])[threadIdx.x + e * REDUCE_THREADS] = next[e];
    __syncthreads();
    if (mine && role == 0 && r < 3) {
      F a;
      load(a, &tile[r][0][li], REDUCE_LANES);
      st(R.s.c[r], a);
    }
    if (k) fetch(next, k - 1);  // in flight during the adds
    __syncwarp();
    // the run: run += S_k; B (from the second step): B += run_{k+1}
    Pt6<L>& acc = role == 0 ? R.run : R.b;
    add6(acc, acc, role == 0 ? R.s : R.run, R.x[role], r,
         mine && (role == 0 || k < K - 1), c);
  }
  __syncthreads();
  const long long s_out = nl;  // (L, wt, cw): limb j of lane t at j nl + t
  for (int i = threadIdx.x; i < 6 * L * REDUCE_LANES; i += REDUCE_THREADS) {
    const int q = i % REDUCE_LANES, j = (i / REDUCE_LANES) % L;
    const int o = i / (L * REDUCE_LANES);
    if (q >= nbk) continue;
    int32_t* dst = o == 0 ? ax : o == 1 ? ay : o == 2 ? az
                 : o == 3 ? bx : o == 4 ? by : bz;
    const Pt6<L>& p = o < 3 ? lanes[q].run : lanes[q].b;
    dst[j * s_out + t0 + q] = limb_of<L>(p.c[o % 3], j);
  }
}

// B4.  s: (K, 3L, M) point columns (X limbs, Y limbs, Z limbs); a, b:
// (3L, M).  The walk over k is split into P = ceil(K / T) chunks of T rows
// (T a power of two; rows past K are the identity).  A block holds G
// lanes and all P chunks of each (blockDim P G): thread (c, g) walks chunk
// c of lane m = G blockIdx + g,
//   A_c = sum_j s_{cT+j},  B_c = sum_j j s_{cT+j}  (2T - 1 adds),
// and leaves both in shared memory (sh: [6][N][P G] words, A_c's X Y Z then
// B_c's).  Then, per lane, thread c = 0 walks the chunk sums the same way
// (A = sum_c A_c, W = sum_c c A_c) and doubles W log2 T times, while
// thread c = 1 (c = 0 where P = 1) adds the B_c up from the identity;
// after a second barrier, B = T W + sum_c B_c.  Each value passes through
// shared memory rather than registers, so no thread holds more than one
// walk's points.  Every add is rcb15 in that order, the order of
// bucket_kernel._suffix_reduce_split_plain.
__device__ __forceinline__ void put_words(uint32_t* sh, int q, int stride,
                                          const F& a) {
#pragma unroll
  for (int k = 0; k < N; k++) sh[(q * N + k) * stride] = a.w[k];
}

__device__ __forceinline__ void get_words(F& a, const uint32_t* sh, int q,
                                          int stride) {
#pragma unroll
  for (int k = 0; k < N; k++) a.w[k] = sh[(q * N + k) * stride];
}

__global__ void __launch_bounds__(THREADS)
    suffix_reduce_kernel(const int32_t* __restrict__ s,
                         int32_t* __restrict__ a, int32_t* __restrict__ b,
                         const Cst c, long long K, long long M, int T,
                         int P, int G) {
  extern __shared__ uint32_t sh[];
  const int nt = P * G;
  const int chunk = threadIdx.x / G, g = threadIdx.x % G;
  const long long m = (long long)blockIdx.x * G + g;
  const bool lane = m < M;
  const long long plane = (long long)L * M;
  uint32_t* const own = sh + threadIdx.x;  // this thread's chunk slots
  F b3, RX, RY, RZ, BX, BY, BZ;
  set_b3(b3, c);
  if (lane) {
    set_identity(RX, RY, RZ, c);
    set_identity(BX, BY, BZ, c);
    for (int j = T - 1; j >= 0; j--) {
      const long long k = (long long)chunk * T + j;
      F SX, SY, SZ;
      if (k < K) {
        const int32_t* sk = s + k * 3 * plane + m;
        load(SX, sk, M);
        load(SY, sk + plane, M);
        load(SZ, sk + 2 * plane, M);
      } else {
        set_identity(SX, SY, SZ, c);
      }
      rcb15(RX, RY, RZ, RX, RY, RZ, SX, SY, SZ, b3, c);
      if (j) rcb15(BX, BY, BZ, BX, BY, BZ, RX, RY, RZ, b3, c);
    }
    put_words(own, 0, nt, RX);
    put_words(own, 1, nt, RY);
    put_words(own, 2, nt, RZ);
    put_words(own, 3, nt, BX);
    put_words(own, 4, nt, BY);
    put_words(own, 5, nt, BZ);
  }
  __syncthreads();
  // thread c = 0: (A, W) by the suffix walk over the A_c; A goes out, T W
  // to its own A slot (it alone reads the A slots)
  if (lane && chunk == 0) {
    set_identity(RX, RY, RZ, c);
    set_identity(BX, BY, BZ, c);
    for (int q = P - 1; q >= 0; q--) {
      F SX, SY, SZ;
      const uint32_t* at = sh + q * G + g;
      get_words(SX, at, 0, nt);
      get_words(SY, at, 1, nt);
      get_words(SZ, at, 2, nt);
      rcb15(RX, RY, RZ, RX, RY, RZ, SX, SY, SZ, b3, c);
      if (q) rcb15(BX, BY, BZ, BX, BY, BZ, RX, RY, RZ, b3, c);
    }
    store(a + m, RX, M);
    store(a + plane + m, RY, M);
    store(a + 2 * plane + m, RZ, M);
    for (int d = 1; d < T; d <<= 1)
      rcb15(BX, BY, BZ, BX, BY, BZ, BX, BY, BZ, b3, c);
    put_words(own, 0, nt, BX);
    put_words(own, 1, nt, BY);
    put_words(own, 2, nt, BZ);
  }
  // thread c = sum_c: sum_c B_c, to its own B slot (it alone reads the B
  // slots)
  const int sum_c = P > 1 ? 1 : 0;
  if (lane && chunk == sum_c) {
    set_identity(RX, RY, RZ, c);
    for (int q = P - 1; q >= 0; q--) {
      F SX, SY, SZ;
      const uint32_t* at = sh + q * G + g;
      get_words(SX, at, 3, nt);
      get_words(SY, at, 4, nt);
      get_words(SZ, at, 5, nt);
      rcb15(RX, RY, RZ, RX, RY, RZ, SX, SY, SZ, b3, c);
    }
    put_words(own, 3, nt, RX);
    put_words(own, 4, nt, RY);
    put_words(own, 5, nt, RZ);
  }
  __syncthreads();
  // B = T W + sum_c B_c
  if (lane && chunk == 0) {
    const uint32_t* at = sh + sum_c * G + g;
    get_words(BX, own, 0, nt);
    get_words(BY, own, 1, nt);
    get_words(BZ, own, 2, nt);
    get_words(RX, at, 3, nt);
    get_words(RY, at, 4, nt);
    get_words(RZ, at, 5, nt);
    rcb15(BX, BY, BZ, BX, BY, BZ, RX, RY, RZ, b3, c);
    store(b + m, BX, M);
    store(b + plane + m, BY, M);
    store(b + 2 * plane + m, BZ, M);
  }
}

// B5.  s*: (L, W * B) window-major sums (window w, batch b at column
// w * B + b); o*: (L, B).  One six-thread group per batch column walks the
// windows downward: wbits doublings rcb15(T, T) and one add per window
// (group6.cuh's add6), the state in shared memory.
struct HornerGroup {
  Pt6<L> t, s;  // the running sum and the next window's sum
  Scratch6<L> x;
};

__global__ void __launch_bounds__(32)
    horner_kernel(const int32_t* __restrict__ sx,
                  const int32_t* __restrict__ sy,
                  const int32_t* __restrict__ sz, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  const Cst c, long long W, long long B, long long wbits) {
  __shared__ HornerGroup grp[GROUPS];
  const int g = threadIdx.x / GROUP, r = threadIdx.x % GROUP;
  const long long bi = (long long)blockIdx.x * GROUPS + g;
  const bool act = g < GROUPS && bi < B;
  HornerGroup& h = grp[act ? g : 0];
  const long long WB = W * B;
  const int32_t* src[3] = {sx, sy, sz};
  F a;
  if (act && r < 3) {
    load(a, src[r] + (W - 1) * B + bi, WB);
    st(h.t.c[r], a);
  }
  for (long long w = W - 2; w >= 0; w--) {
    if (act && r < 3) {
      load(a, src[r] + w * B + bi, WB);
      st(h.s.c[r], a);
    }
    __syncwarp();
    for (long long i = 0; i < wbits; i++)
      add6(h.t, h.t, h.t, h.x, r, act, c);
    add6(h.t, h.t, h.s, h.x, r, act, c);
  }
  __syncwarp();
  int32_t* dst[3] = {ox, oy, oz};
  if (act && r < 3) {
    ld(a, h.t.c[r]);
    store(dst[r] + bi, a, B);
  }
}

#if DAVINCI_L <= 32  // Fp2 only: no Fp2 curve has L = 64

// B5 on G2 (the fused route's Horner): s*: (W * B, 2L) window-major rows
// (window w, batch b at row w * B + b); o*: (B, 2L).  The same walk with
// B7's six-thread G2 add (group6.cuh's add6_g2) on rows in shared memory.
constexpr int ROW2 = 2 * L;

struct HornerGroupG2 {
  int32_t t[3][ROW2], s[3][ROW2];
  Scratch6G2<L> x;
};

__global__ void __launch_bounds__(32)
    horner_g2_kernel(const int32_t* __restrict__ sx,
                     const int32_t* __restrict__ sy,
                     const int32_t* __restrict__ sz,
                     int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz, const Cst c, long long W,
                     long long B, long long wbits) {
  __shared__ HornerGroupG2 grp[GROUPS];
  const int g = threadIdx.x / GROUP, r = threadIdx.x % GROUP;
  const long long bi = (long long)blockIdx.x * GROUPS + g;
  const bool act = g < GROUPS && bi < B;
  HornerGroupG2& h = grp[act ? g : 0];
  const int32_t* src[3] = {sx, sy, sz};
  auto rows_of = [&](int32_t (*dst)[ROW2], long long row) {
    for (int i = r; i < 3 * ROW2; i += GROUP)
      dst[i / ROW2][i % ROW2] = src[i / ROW2][row * ROW2 + i % ROW2];
  };
  if (act) rows_of(h.t, (W - 1) * B + bi);
  for (long long w = W - 2; w >= 0; w--) {
    if (act) rows_of(h.s, w * B + bi);
    __syncwarp();
    for (long long i = 0; i < wbits; i++)
      add6_g2<L>(h.t, h.t, h.t, h.x, r, act, c);
    add6_g2<L>(h.t, h.t, h.s, h.x, r, act, c);
  }
  __syncwarp();
  int32_t* dst[3] = {ox, oy, oz};
  if (act)
    for (int i = r; i < 3 * ROW2; i += GROUP)
      dst[i / ROW2][bi * ROW2 + i % ROW2] = h.t[i / ROW2][i % ROW2];
}

#endif  // DAVINCI_L <= 32

Cst consts_of(const uint32_t* words) {
  Cst c;
  std::memcpy(&c, words, sizeof(c));
  return c;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success); consts: the uint32 words of struct Consts (field.cuh).

extern "C" int davinci_bucket_scan_g1(const int32_t* planes,
                                      const int32_t* keys, int32_t* out,
                                      const uint32_t* consts, long long rows,
                                      long long nl, long long is_signed,
                                      void* stream) {
  if (nl <= 0) return 0;
  bucket_scan_kernel<<<(unsigned)((nl + SCAN_LANES - 1) / SCAN_LANES),
                       32 * SCAN_WARPS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)planes, keys, out, consts_of(consts), rows, nl,
      (int)is_signed);
  return (int)cudaGetLastError();
}

extern "C" int davinci_bucket_reduce_g1(
    const int32_t* sx, const int32_t* sy, const int32_t* sz, int32_t* ax,
    int32_t* ay, int32_t* az, int32_t* bx, int32_t* by, int32_t* bz,
    const uint32_t* consts, long long wt, long long nb, long long cw,
    long long ws, long long ls, void* stream) {
  if (wt * cw <= 0) return 0;
  if (nb % cw) return (int)cudaErrorInvalidValue;
  bucket_reduce_kernel<<<(unsigned)((wt * cw + REDUCE_LANES - 1) /
                                    REDUCE_LANES),
                         REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      sx, sy, sz, ax, ay, az, bx, by, bz, consts_of(consts), wt, nb, cw, ws,
      ls);
  return (int)cudaGetLastError();
}

extern "C" int davinci_suffix_reduce_g1(const int32_t* s, int32_t* a,
                                        int32_t* b, const uint32_t* consts,
                                        long long K, long long M, long long T,
                                        void* stream) {
  if (M <= 0) return 0;
  const long long P = (K + T - 1) / T;
  if (K <= 0 || T <= 0 || (T & (T - 1)) || P > THREADS)
    return (int)cudaErrorInvalidValue;
  const long long G = THREADS / P;  // lanes per block
  const size_t shared = sizeof(uint32_t) * 6 * N * P * G;
  if (shared > 48 * 1024) {  // L = 64: 73,728 B, past the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        suffix_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  suffix_reduce_kernel<<<(unsigned)((M + G - 1) / G), (unsigned)(P * G),
                         shared, (cudaStream_t)stream>>>(
      s, a, b, consts_of(consts), K, M, (int)T, (int)P, (int)G);
  return (int)cudaGetLastError();
}

extern "C" int davinci_horner_g1(const int32_t* sx, const int32_t* sy,
                                 const int32_t* sz, int32_t* ox, int32_t* oy,
                                 int32_t* oz, const uint32_t* consts,
                                 long long W, long long B, long long wbits,
                                 void* stream) {
  if (B <= 0) return 0;
  horner_kernel<<<(unsigned)((B + GROUPS - 1) / GROUPS), 32, 0,
                  (cudaStream_t)stream>>>(sx, sy, sz, ox, oy, oz,
                                          consts_of(consts), W, B, wbits);
  return (int)cudaGetLastError();
}

#if DAVINCI_L <= 32
extern "C" int davinci_horner_g2(const int32_t* sx, const int32_t* sy,
                                 const int32_t* sz, int32_t* ox, int32_t* oy,
                                 int32_t* oz, const uint32_t* consts,
                                 long long W, long long B, long long wbits,
                                 void* stream) {
  if (B <= 0) return 0;
  horner_g2_kernel<<<(unsigned)((B + GROUPS - 1) / GROUPS), 32, 0,
                     (cudaStream_t)stream>>>(sx, sy, sz, ox, oy, oz,
                                             consts_of(consts), W, B, wbits);
  return (int)cudaGetLastError();
}
#endif  // DAVINCI_L <= 32
