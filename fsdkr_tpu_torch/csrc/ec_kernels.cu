// Device EC for secp256k1: hand-written kernels for Hopper (sm_90a).
//
// Replaces the JAX package's XLA functions
//   fsdkr_tpu/ops/ec_batch.py:136-172 _scalar_mul_kernel -> ec_scalar_mul_kernel
//   fsdkr_tpu/ops/ec_batch.py:175-186 _tree_sum_kernel   -> ec_tree_sum_kernel
// with the plain PyTorch versions of both in fsdkr_tpu_torch/ops/ec_batch.py
// (the wrappers: ops/ec_kernels.py).
//
// Arithmetic. A field element of F_p, p = 2^256 - 2^32 - 977, is 8 32-bit
// words in registers, little-endian, in the Montgomery domain (R = 2^256,
// the JAX package's R on its 16 16-bit limbs) and canonical (< p) after
// every operation. A product is the 512-bit x * y (a squaring: the 28
// words above the diagonal once, doubled, and the 8 squares) and a
// Montgomery reduction on p's special form: word i's m = T_i p^{-1} mod
// 2^32 adds m * 977 to word i and m to word i + 1 of an unsigned running
// carry, where the generic reduction adds m * p word by word; then T_hi +
// carry - M, plus p where it is negative (mont_reduce). The products by
// b3 R mod p (b3 = 21) and t0 + t0 + t0 are products by the small
// constants 21 and 3, 2^256 folded back as 2^32 + 977. Differences are
// sums of the complement, so every borrow is a carry. A canonical result
// is unique, so every value equals the plain version's and the JAX
// package's bit for bit. Points are homogeneous projective (X : Y : Z),
// the identity (0 : R mod p : 0), added by the complete formula of
// Renes-Costello-Batina 2016, Alg. 7 (a = 0, b3 = 21), with the values of
// the JAX package's `_padd` (:100-125): one formula for additions,
// doublings, the identity and inverses, with no branch on the data. Every
// select is a mask.
//
// ec_scalar_mul_kernel: k*P per row, a row on 8 lanes of a warp (4 rows a
// one-warp block). Lane g holds coordinate g mod 3 of the row's points and
// the addition runs in `_padd`'s three rounds of independent products,
// one product a lane a round (padd_lanes): round 1 the six products of
// coordinates and of coordinate sums, round 2 the sums and the products by
// 3 and b3, one a lane, round 3 the six products of the output; the values
// cross between rounds by warp shuffles within the row's group. A doubling
// runs the same statements with its round-1 products as squarings. The
// 16-entry table of multiples (table[0] the identity, table[j] =
// table[j-1] + P), then per 4-bit window, MSB first, 4 doublings acc + acc
// and one add of the window's entry. The entry is read as a masked OR over
// all 16 entries, never indexed by the digit (the scalars are key shares,
// coefficients and nonces). Each lane keeps its coordinate of the table
// in shared memory (16 KB a block, word-major across the lanes: no bank
// conflict) and zeroes it before it exits. ptxas keeps the whole loop in
// registers (108 of them, no spill, no stack frame in the sm_90a build:
// PERF.md), so no secret state lands in local memory.
//
// ec_tree_sum_kernel: one block a group, one thread a pair (the one-thread
// complete addition, padd). Level by level, row i of the first half plus
// row i of the second (the JAX package's lhs = flat[:, :m], rhs = flat[:,
// m:]), the pairs spread over the block's threads, a barrier between
// levels. The levels' sums lie in a global scratch buffer the wrapper
// allocates (group g's word k of row i at k * M/2 + i, so neighbouring
// threads read neighbouring words), so M is not capped by the block.
// Why the source keeps a second, one-thread addition beside padd_lanes:
// the PDL u1 group's (1, 1024) is 1023 additions on one SM, throughput-
// bound on its wide levels, where a lane group repeats round 2's work and
// pays for shuffles and selects. On an "NVIDIA H100 80GB HBM3, 700.00 W",
// on one arithmetic, the tree on lane groups alone read 1.34x slower
// there than one thread a pair (2.7x faster at (16, 32) and (16, 16), a
// collect's three launches within 0.01 ms of each other), and lane groups
// for the narrow levels only 1.34x faster than the one-thread tree they
// were held against, under the 1.5x that would have kept them (PERF.md).
//
// What bounds it: integer multiply-adds and their carries. A complete
// addition is 12 field products of 8 x 8 32-bit multiply-adds (36 in a
// squaring) with an 8-step reduction each, 3 products by small constants
// and 17 sums and differences; a 256-bit scalar-mul row is 14 + 5 * 64 =
// 334 additions.
// At the main path's 256-1024 rows a launch is 64-256 one-warp blocks, at
// most two an SM, so each row's chain of additions sets the time, by its
// latency and not the card's multiply rate: the lanes cut an addition's
// chain of dependent products from 14 to 2 and spread a launch over 8x as
// many warps as one thread a row did.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;                   // 32-bit words of a field element
constexpr int kPointWords = 3 * kWords;     // X, Y, Z
constexpr int kLimbs = 16;                  // 16-bit limbs of a coordinate
constexpr int kPointLimbs = 3 * kLimbs;
constexpr int kWindowBits = 4;
constexpr int kEntries = 1 << kWindowBits;
constexpr int kRowLanes = 8;                // lanes a row
constexpr int kMulThreads = 32;             // the scalar mul's block: one warp
constexpr int kMulRows = kMulThreads / kRowLanes;
constexpr int kTreeThreads = 256;           // the tree's largest block
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kPInv = 0x2DDACACFu;     // p^{-1} mod 2^32 (-977^{-1})
constexpr uint32_t kC0 = 977u;              // p = 2^256 - 2^32 - kC0
constexpr uint32_t kB3 = 21u;               // b3 = 3b

// p and R mod p (1 in the Montgomery domain)
__device__ __forceinline__ constexpr uint32_t p_word(int j) {
  return j == 0 ? 0xFFFFFC2Fu : (j == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
}
__device__ __forceinline__ constexpr uint32_t one_m_word(int j) {
  return j == 0 ? 0x000003D1u : (j == 1 ? 0x00000001u : 0u);
}

// Differences are sums of the complement: a - b = a + ~b + 1, so every
// borrow chain is a carry chain (an add and a carry a word).

// r = t - p where t >= p, else t; t: 9 words, t < 2p (its ninth word 0 or 1).
__device__ __forceinline__ void reduce_once(uint32_t r[kWords], const uint32_t t[kWords + 1]) {
  uint32_t d[kWords];
  uint64_t c = 1;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)t[j] + (uint32_t)~p_word(j);
    d[j] = (uint32_t)c;
    c >>= 32;
  }
  // t < p exactly where the eight words borrowed (no carry out) and the
  // ninth is 0
  const uint32_t keep = (0u - ((uint32_t)c ^ 1u)) & (0u - (t[kWords] ^ 1u));
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

// T = x * y, 16 words
__device__ __forceinline__ void mul_wide(uint32_t T[2 * kWords], const uint32_t x[kWords],
                                         const uint32_t y[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) T[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint64_t s = (uint64_t)x[j] * y[i] + T[i + j] + c;
      T[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    T[i + kWords] = (uint32_t)c;
  }
}

// T = x * x, 16 words: the 28 products above the diagonal once, doubled,
// then the 8 squares on the diagonal (36 word products where x * y has 64)
__device__ __forceinline__ void sqr_wide(uint32_t T[2 * kWords], const uint32_t x[kWords]) {
#pragma unroll
  for (int j = 0; j < 2 * kWords; ++j) T[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < kWords; ++j) {
      const uint64_t s = (uint64_t)x[i] * x[j] + T[i + j] + c;
      T[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    T[i + kWords] = (uint32_t)c;
  }
#pragma unroll
  for (int j = 2 * kWords - 1; j > 0; --j) T[j] = __funnelshift_l(T[j - 1], T[j], 1);
  T[0] = 0;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t s = (uint64_t)x[i] * x[i] + T[2 * i] + c;
    T[2 * i] = (uint32_t)s;
    s = (uint64_t)T[2 * i + 1] + (s >> 32);
    T[2 * i + 1] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

// r = T * R^{-1} mod p for T < p^2, on p's special form. Word i's
// m = T_i p^{-1} mod 2^32 makes T - m p 2^{32i} vanish in word i; since
// -m p = m kC0 + m 2^32 - m 2^256, the low half only ever gains m kC0 in
// word i and m in word i + 1, an unsigned running carry where the generic
// reduction adds m * p_word(j) word by word. With M = sum m_i 2^{32i} the
// low half of T - M p is then 0 and the carry c its high part's gain, so
// (T - M p) / R = T_hi + c - M, in (-p, p): plus p where it is negative,
// it is the canonical T R^{-1} mod p.
__device__ __forceinline__ void mont_reduce(uint32_t r[kWords], const uint32_t T[2 * kWords]) {
  uint32_t m[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint64_t w = T[i] + c;
    m[i] = (uint32_t)w * kPInv;
    c = ((w + (uint64_t)m[i] * kC0) >> 32) + m[i];
  }
  // T_hi + c + ~M + 1: its ninth word is 1 where T_hi + c - M >= 0, else 0
  uint32_t u[kWords];
  c += 1;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    c += (uint64_t)T[kWords + i] + (uint32_t)~m[i];
    u[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t mask = 0u - ((uint32_t)c ^ 1u);
  c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    c += (uint64_t)u[i] + (p_word(i) & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

// r = x * y * R^{-1} mod p; x, y < p. r may alias x or y.
__device__ __forceinline__ void fmul(uint32_t r[kWords], const uint32_t x[kWords],
                                     const uint32_t y[kWords]) {
  uint32_t T[2 * kWords];
  mul_wide(T, x, y);
  mont_reduce(r, T);
}

// r = x * x * R^{-1} mod p; x < p. r may alias x.
__device__ __forceinline__ void fsqr(uint32_t r[kWords], const uint32_t x[kWords]) {
  uint32_t T[2 * kWords];
  sqr_wide(T, x);
  mont_reduce(r, T);
}

// r = k * x mod p for a small constant k (3 or kB3 = 21: the products by
// b3 R mod p, and t0 + t0 + t0); x < p. k x is 9 words, its ninth h < k;
// 2^256 = c (mod p) folds h back in as h c, and lo + h c < 2^256 + 2^37 <
// 2p takes one conditional subtraction. r may alias x.
__device__ __forceinline__ void fmul_small(uint32_t r[kWords], uint32_t k,
                                           const uint32_t x[kWords]) {
  uint32_t t[kWords + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)x[j] * k;
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  // + h kC0 in word 0, + h in word 1
  c = (uint64_t)t[0] + c * kC0 + ((uint64_t)(uint32_t)c << 32);
  t[0] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    c += t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[kWords] = (uint32_t)c;
  reduce_once(r, t);
}

// r = x + y mod p; x, y < p.
__device__ __forceinline__ void fadd(uint32_t r[kWords], const uint32_t x[kWords],
                                     const uint32_t y[kWords]) {
  uint32_t t[kWords + 1];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)x[j] + y[j] + c;
    t[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  t[kWords] = c;
  reduce_once(r, t);
}

// r = x - y mod p; x, y < p: x - y, plus p where it borrowed (the value
// the JAX package's (x + p) - y and its conditional subtraction give).
__device__ __forceinline__ void fsub(uint32_t r[kWords], const uint32_t x[kWords],
                                     const uint32_t y[kWords]) {
  uint32_t d[kWords];
  uint64_t c = 1;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)x[j] + (uint32_t)~y[j];
    d[j] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t mask = 0u - ((uint32_t)c ^ 1u);
  c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)d[j] + (p_word(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// One thread's complete addition (the tree's): a point's X, Y and Z in
// registers.
struct Pt {
  uint32_t x[kWords], y[kWords], z[kWords];
};

__device__ __forceinline__ uint32_t& coord(Pt& p, int k) {
  return k < kWords ? p.x[k] : (k < 2 * kWords ? p.y[k - kWords] : p.z[k - 2 * kWords]);
}

// out = p + q, the complete formula in the JAX package's statement order.
// out may alias p or q.
__device__ __forceinline__ void padd(Pt& out, const Pt& p, const Pt& q) {
  uint32_t t0[kWords], t1[kWords], t2[kWords], t3[kWords], t4[kWords];
  uint32_t x3[kWords], y3[kWords], z3[kWords], a[kWords], b[kWords];
  fmul(t0, p.x, q.x);
  fmul(t1, p.y, q.y);
  fmul(t2, p.z, q.z);
  fadd(a, p.x, p.y);
  fadd(b, q.x, q.y);
  fmul(t3, a, b);
  fadd(a, t0, t1);
  fsub(t3, t3, a);
  fadd(a, p.y, p.z);
  fadd(b, q.y, q.z);
  fmul(t4, a, b);
  fadd(a, t1, t2);
  fsub(t4, t4, a);
  fadd(a, p.x, p.z);
  fadd(b, q.x, q.z);
  fmul(x3, a, b);
  fadd(a, t0, t2);
  fsub(y3, x3, a);
  fmul_small(x3, 3, t0);
  fmul_small(t2, kB3, t2);
  fadd(z3, t1, t2);
  fsub(t1, t1, t2);
  fmul_small(y3, kB3, y3);
  // p and q are not read below: out may alias either
  fmul(a, t3, t1);
  fmul(b, t4, y3);
  fsub(out.x, a, b);
  fmul(a, y3, x3);
  fmul(b, t1, z3);
  fadd(out.y, a, b);
  fmul(a, z3, t4);
  fmul(b, x3, t3);
  fadd(out.z, a, b);
}

// A row's complete addition on the row's 8 lanes (a lane group of the
// warp). Lane g holds coordinate c = g mod 3 (X, Y, Z) of every point of
// the row; lanes 3-5 repeat lanes 0-2 and lanes 6, 7 lanes 0, 1, so every
// lane takes part in every shuffle.

// r = v of lane `src` of this lane's group
__device__ __forceinline__ void shfl_words(uint32_t r[kWords], const uint32_t v[kWords], int src) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = __shfl_sync(kFull, v[k], src, kRowLanes);
}

// r = c ? a : b, by mask (a select of arrays by a pointer would put them in
// local memory). r may alias a or b.
__device__ __forceinline__ void select(uint32_t r[kWords], bool c, const uint32_t a[kWords],
                                       const uint32_t b[kWords]) {
  const uint32_t m = 0u - (uint32_t)c;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = (a[k] & m) | (b[k] & ~m);
}

// out = coordinate c of P + Q, from coordinate c of P (p) and of Q (q): the
// complete formula, `_padd`'s values, over the row's lanes, each step one
// uniform statement on lane-dependent operands. kSame: q is p (the
// doubling instance: the round-1 products as squarings). out may alias p
// or q. (j + 1 is taken mod 3.)
//
//   round 1, lane g < 3: D_g = P_g Q_g                       t0, t1, t2
//            lane 3 + j: S_j = (P_j + P_j+1)(Q_j + Q_j+1)    (X+Y)(X'+Y'), ...
//   every lane, for its c:  T_c = S_c - (D_c + D_c+1)        t3, t4, y3
//                           W_c = 3 D_0, b3 T_2, b3 D_2      x3, y3, t2
//                           z3 = D_1 + W_2, t1 = D_1 - W_2
//   round 3, lane g < 6 (6, 7 repeat 0, 1): product g of
//            t3 t1, t4 y3, y3 x3, t1 z3, z3 t4, x3 t3
//   every lane: X3 = #0 - #1, Y3 = #2 + #3, Z3 = #4 + #5 for its c.
template <bool kSame>
__device__ __forceinline__ void padd_lanes(uint32_t out[kWords], const uint32_t p[kWords],
                                           const uint32_t q[kWords], int c) {
  const int g = threadIdx.x % kRowLanes;
  const int next = c == 2 ? 0 : c + 1;
  const bool s_lane = g >= 3 && g < 6;
  uint32_t x[kWords], t[kWords];
  shfl_words(t, p, next);
  fadd(t, p, t);
  select(x, s_lane, t, p);
  if (kSame) {
    fsqr(x, x);
  } else {
    uint32_t y[kWords];
    shfl_words(t, q, next);
    fadd(t, q, t);
    select(y, s_lane, t, q);
    fmul(x, x, y);
  }
  // T_c (in tc) and W_c (in w)
  uint32_t tc[kWords], w[kWords], d1[kWords];
  shfl_words(tc, x, c + 3);
  shfl_words(t, x, c);
  shfl_words(w, x, next);
  fadd(t, t, w);
  fsub(tc, tc, t);
  shfl_words(t, tc, 2);
  shfl_words(w, x, c);
  select(w, c == 1, t, w);
  fmul_small(w, c == 0 ? 3u : kB3, w);
  // z3 (in t) and t1 (in d1)
  shfl_words(d1, x, 1);
  shfl_words(x, w, 2);
  fadd(t, d1, x);
  fsub(d1, d1, x);
  // round 3: operand A of product j is T_0, T_1, W_1, t1, z3 or W_0;
  // operand B t1, W_1, W_0, z3, T_1 or T_0
  const int j = g < 6 ? g : g - 6;
  uint32_t a[kWords], b[kWords];
  shfl_words(a, tc, j == 1 ? 1 : 0);
  shfl_words(b, w, j == 2 ? 1 : 0);
  select(a, j < 2, a, b);
  select(b, j == 3, d1, t);
  select(a, j < 3 || j == 5, a, b);
  shfl_words(b, tc, j == 4 ? 1 : 0);
  shfl_words(x, w, j == 1 ? 1 : 0);
  select(b, j >= 4, b, x);
  select(x, j == 0, d1, t);
  select(b, j == 0 || j == 3, x, b);
  fmul(x, a, b);
  shfl_words(a, x, 2 * c);
  shfl_words(b, x, 2 * c + 1);
  fsub(t, a, b);
  fadd(a, a, b);
  select(out, c == 0, t, a);
}

// coordinate c of the identity (0 : R mod p : 0)
__device__ __forceinline__ void identity_coord(uint32_t r[kWords], int c) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = c == 1 ? one_m_word(k) : 0u;
}

// coordinate c of a point from its 16-bit limbs (the point's 48 at
// `limbs`), and back
__device__ __forceinline__ void load_coord(uint32_t r[kWords], const int32_t* limbs, int c) {
  const int32_t* l = limbs + c * kLimbs;
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    r[k] = (uint32_t)l[2 * k] | ((uint32_t)l[2 * k + 1] << 16);
}

__device__ __forceinline__ void store_coord(int32_t* limbs, const uint32_t v[kWords], int c) {
  int32_t* l = limbs + c * kLimbs;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    l[2 * k] = (int32_t)(v[k] & 0xFFFFu);
    l[2 * k + 1] = (int32_t)(v[k] >> 16);
  }
}

__global__ void __launch_bounds__(kMulThreads)
ec_scalar_mul_kernel(const int32_t* __restrict__ points, const int32_t* __restrict__ scalars,
                     int rows, int scalar_limbs, int scalar_bits, int32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const int c = lane % kRowLanes % 3;
  int row = blockIdx.x * kMulRows + lane / kRowLanes;
  const bool live = row < rows;
  // the spare rows of a partly filled block redo the last row, unstored
  if (!live) row = rows - 1;

  // each lane's coordinate of the 16 entries: word k of entry e at (e * 8
  // + k) * 32 + lane (consecutive lanes, consecutive banks)
  __shared__ uint32_t table[kEntries * kWords * kMulThreads];
  uint32_t base[kWords], acc[kWords];
  load_coord(base, points + (size_t)row * kPointLimbs, c);
  identity_coord(acc, c);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    table[k * kMulThreads + lane] = acc[k];
    table[(kWords + k) * kMulThreads + lane] = base[k];
    acc[k] = base[k];
  }
#pragma unroll 1
  for (int e = 2; e < kEntries; ++e) {
    padd_lanes<false>(acc, acc, base, c);
#pragma unroll
    for (int k = 0; k < kWords; ++k) table[(e * kWords + k) * kMulThreads + lane] = acc[k];
  }

  const int32_t* sc = scalars + (size_t)row * scalar_limbs;
  identity_coord(acc, c);
#pragma unroll 1
  for (int shift = scalar_bits - kWindowBits; shift >= 0; shift -= kWindowBits) {
    const uint32_t digit = ((uint32_t)sc[shift >> 4] >> (shift & 15)) & (kEntries - 1);
#pragma unroll 1
    for (int d = 0; d < kWindowBits; ++d) padd_lanes<true>(acc, acc, acc, c);
    // the window's entry: a masked OR over all 16, never indexed by the
    // digit; `base` holds it
#pragma unroll
    for (int k = 0; k < kWords; ++k) base[k] = 0u;
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      const uint32_t mask = 0u - (uint32_t)(digit == (uint32_t)e);
#pragma unroll
      for (int k = 0; k < kWords; ++k) base[k] |= table[(e * kWords + k) * kMulThreads + lane] & mask;
    }
    padd_lanes<false>(acc, acc, base, c);
  }
  if (live && lane % kRowLanes < 3) store_coord(out + (size_t)row * kPointLimbs, acc, c);
  // every entry zeroed (volatile: the stores outlive no read, and must
  // not be dropped)
#pragma unroll 1
  for (int i = 0; i < kEntries * kWords; ++i)
    *(volatile uint32_t*)&table[i * kMulThreads + lane] = 0u;
}

// one level of the tree, one thread a pair: row i (< h) += row i + h, from
// `in` (16-bit limbs, the first level) or the scratch rows (word k of row i
// at k * half + i) into the scratch rows. Each level writes row i in
// place: only its own thread reads row i, and no row of the second half is
// written.
__device__ __forceinline__ void tree_level(const int32_t* in, uint32_t* buf, int half, int h) {
  Pt a, b;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    if (in) {
      const int32_t* la = in + (size_t)i * kPointLimbs;
      const int32_t* lb = in + (size_t)(i + h) * kPointLimbs;
      load_coord(a.x, la, 0);
      load_coord(a.y, la, 1);
      load_coord(a.z, la, 2);
      load_coord(b.x, lb, 0);
      load_coord(b.y, lb, 1);
      load_coord(b.z, lb, 2);
    } else {
#pragma unroll
      for (int k = 0; k < kPointWords; ++k) {
        coord(a, k) = buf[(size_t)k * half + i];
        coord(b, k) = buf[(size_t)k * half + i + h];
      }
    }
    padd(a, a, b);
#pragma unroll
    for (int k = 0; k < kPointWords; ++k) buf[(size_t)k * half + i] = coord(a, k);
  }
}

__global__ void __launch_bounds__(kTreeThreads)
ec_tree_sum_kernel(const int32_t* __restrict__ points, int m, uint32_t* __restrict__ scratch,
                   int32_t* __restrict__ out) {
  const int g = blockIdx.x;
  const int32_t* in = points + (size_t)g * m * kPointLimbs;
  int32_t* dst = out + (size_t)g * kPointLimbs;
  if (m == 1) {
    for (int k = threadIdx.x; k < kPointLimbs; k += blockDim.x) dst[k] = in[k];
    return;
  }
  const int half = m >> 1;
  uint32_t* buf = scratch + (size_t)g * half * kPointWords;
  // one copy of the addition for every level (the first reads `in`)
#pragma unroll 1
  for (int h = half; h >= 1; h >>= 1) {
    if (h < half) __syncthreads();
    tree_level(h == half ? in : nullptr, buf, half, h);
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    uint32_t a[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) a[k] = buf[(size_t)(threadIdx.x * kWords + k) * half];
    store_coord(dst, a, threadIdx.x);
  }
}

}  // namespace

// rows x (P, k) -> k*P, a row on 8 lanes, 4 rows a block. Returns a CUDA
// error code.
extern "C" int fsdkr_ec_scalar_mul(const int32_t* points, const int32_t* scalars, int rows,
                                   int scalar_limbs, int scalar_bits, int32_t* out,
                                   void* stream) {
  if (rows <= 0 || scalar_bits <= 0 || scalar_bits % kWindowBits ||
      scalar_limbs * 16 < scalar_bits)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kMulRows - 1) / kMulRows;
  ec_scalar_mul_kernel<<<blocks, kMulThreads, 0, (cudaStream_t)stream>>>(
      points, scalars, rows, scalar_limbs, scalar_bits, out);
  return (int)cudaGetLastError();
}

// groups x m points (m a power of two) -> groups sums; scratch: groups *
// max(m / 2, 1) * 24 words. Threads a block: the first level's pairs,
// rounded up to a warp, at most kTreeThreads.
extern "C" int fsdkr_ec_tree_sum(const int32_t* points, int groups, int m, uint32_t* scratch,
                                 int32_t* out, void* stream) {
  if (groups <= 0 || m <= 0 || (m & (m - 1))) return (int)cudaErrorInvalidValue;
  int threads = ((m >> 1) + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kTreeThreads) threads = kTreeThreads;
  ec_tree_sum_kernel<<<groups, threads, 0, (cudaStream_t)stream>>>(points, m, scratch, out);
  return (int)cudaGetLastError();
}
