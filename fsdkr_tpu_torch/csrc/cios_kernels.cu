// CIOS Montgomery kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ops/montgomery_kernels.py).
//
// The JAX package's CIOS engine is XLA code, not Pallas: a K-step loop of
// about 16 vector ops per product, fused by XLA into one program. These
// kernels are that program's counterpart, one launch per engine entry:
//   fsdkr_cios_mont_mul -> fsdkr_tpu/ops/montgomery.py:102 mont_mul_limbs
//                          (also _modmul_exit_kernel :917 and the levels of
//                          the inverse tree, _inv_tree_up/_down_kernel :792)
//   fsdkr_cios_modmul   -> fsdkr_tpu/ops/montgomery.py:606 _modmul_kernel
//   fsdkr_cios_modexp   -> fsdkr_tpu/ops/montgomery.py:137 _modexp_kernel
//   fsdkr_cios_comb     -> fsdkr_tpu/ops/montgomery.py:372-446, the fixed-base
//                          comb's accumulation and exit (_shared_modexp_kernel)
//   fsdkr_cios_comb_ladder -> fsdkr_tpu/ops/montgomery.py:323-336, the comb's
//                          power ladder
//
// Numbers cross the boundary as int32 tensors of canonical 16-bit limbs,
// (rows, K), little-endian; K is even, so R = 2^(16K) = 2^(32W) falls on a
// 32-bit word (W = K/2 words) and the products are bit-identical to the
// plain versions' (ops/montgomery.py: x*y*R^{-1} mod n, canonical, < n for
// x, y < n). The engine rounds an odd K up (BatchModExp); that changes R,
// so in-domain intermediates, never a value that leaves the engine.
//
// Layout: one warp per row. Lane l owns the P words l*P .. l*P+P-1 (P a
// power of two with 32P >= W: 1 at K <= 64, 2 at K=128, 4 at K=256, 8 at
// K=512, 16 up to K=1024); words at or above W are zero.
//
// One CIOS product, W outer steps over the words x_i of x:
//   t += x_i * y;  m = t_0 * n' mod 2^32;  t += m * n;  t >>= 32
// - Each 32x32 -> 64-bit product's low half joins word j and its high half
//   word j+1. A lane computes its slot 0's high half from the word just
//   below it (the previous lane's last y / n word, fetched once per
//   product by shuffle), so no high half crosses lanes.
// - Lazy carries in 64-bit accumulators: a word gains at most four terms
//   < 2^32 per step and the carry of word 0 (< 2^32), so after W <= 512
//   steps every accumulator stays below (W+1) * 2^34 + 2^32 < 2^44.
//   tests/test_torch_cios_model.py checks this bound at K = 128, 256, 512.
// - m is computed by lane 0 and broadcast by shuffle; the one-word shift is
//   a register move inside a lane and one 64-bit shuffle across lanes.
// - After the W steps, one carry resolution: each lane ripples its own
//   words, hands its multi-bit carry to the next lane (shuffle), ripples
//   again (now every lane's carry is 0 or 1, and a lane that carries cannot
//   be all ones), and the 1-bit carries are resolved across the warp by a
//   ballot carry-lookahead: with G (carries) and Q (all-ones lanes),
//   the carries in are ((G|Q) + G) ^ Q. No loop runs a value-dependent
//   number of times.
// - The conditional subtraction t - n (t < 2R) is the same ballot
//   lookahead over borrows, then a masked select of t or t - n.
//
// Bound on the H100: operations. A product does 2*K^2 16x16-bit
// multiply-adds (counted as four int8 ones each, as for the RNS kernels);
// the kernels do them as 2*W^2 32x32-bit ones on the CUDA cores, each
// step a latency chain (multiply, shuffle of m, multiply, shift), so the
// design keeps the chain short: one warp per row, every lane busy at
// K >= 64, no shared memory on the product's path.
//
// fsdkr_cios_modexp is the whole 4-bit fixed-window exponentiation of
// _modexp_kernel in one launch: entry by r2 = R^2 mod n, the 16-entry
// window table (entry 0 the Montgomery one R mod n) in the warp's shared
// memory (16 * 32P words, 16 KB at K=512), exp_bits/4 windows of four
// squarings and one table multiply, exit by a product with 1. A launch
// takes a table of up to 32 segments, each with its own K, rows,
// exponent width and tensors (a column call's width batches), as a
// grouped GEMM takes its problems: a block never spans two segments, the
// blocks of the longest chain come first, and a block runs the body of
// its segment's P inside a kernel built for the launch's largest P. A
// row is a chain of 5 * exp_bits / 4 + 16 dependent products, one warp a
// row; a column call's batches hold 256-512 rows each, so one batch a
// launch left at most one warp per scheduler and the launches ran one
// after another, where the segments of one launch now run side by side.
//
// Exponents may be secret (shares, nonces) and bases too (Paillier
// randomness): the loop length is the bucketed exp_bits the caller passes,
// never a row's own bit length; the window entry is a masked sum over all
// 16 table entries; the conditional subtraction is a masked select, with
// no branch or address on limb values; every warp zeroes its shared
// memory before it exits.
//
// The fixed-base comb (rows of a group share a public base and modulus:
// ring-Pedersen's (T, N) per message, PDL's and range's (h1 | h2, N~) per
// receiver) splits the modexp in three. fsdkr_cios_comb_ladder computes
// each group's powers base_m^(16^w), one warp per group: the entry by r2,
// then W times (store the power, four squarings): a chain of 4W dependent
// products on G warps, so latency-bound. The 16-entry table of every
// window is built between the two by four fsdkr_cios_mont_mul launches
// (ops/montgomery.py _comb_table). fsdkr_cios_comb then does per row, one
// warp per row as above, W window steps of a masked sum over the group's
// 16 entries of that window (read from global memory: 16 * K * 4 bytes a
// window, shared by the rows of a group through L1/L2) and one product,
// then the exit by a product with 1: W + 1 products a row where
// fsdkr_cios_modexp does 5W + 17. Rows of a group are contiguous, so the
// warps of a block read the same entries. The exponents may be secret
// (the provers' h1^x mod N~ columns): the loop length is the bucketed
// exp_bits, the digit only sets the select's masks, and no branch or
// address depends on it. Bound: operations, as for the other kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;  // rows per block: one warp per row

// P: the words per lane, a power of two with 32P >= K/2
__host__ __device__ __forceinline__ int words_per_lane(int K) {
  const int W = K / 2;
  int P = 1;
  while (32 * P < W) P *= 2;
  return P;
}

// A lane's P words of one row, from (or to) 16-bit limbs.
template <int P>
__device__ __forceinline__ void load_words(uint32_t (&v)[P], const int32_t* __restrict__ row,
                                           int W, int lane) {
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int j = lane * P + s;
    v[s] = j < W ? ((uint32_t)row[2 * j] & 0xFFFFu) | ((uint32_t)row[2 * j + 1] << 16) : 0u;
  }
}

template <int P>
__device__ __forceinline__ void store_words(const uint32_t (&v)[P], int32_t* __restrict__ row,
                                            int W, int lane) {
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int j = lane * P + s;
    if (j < W) {
      row[2 * j] = (int32_t)(v[s] & 0xFFFFu);
      row[2 * j + 1] = (int32_t)(v[s] >> 16);
    }
  }
}

// acc += a * b over the lane's words, low halves into word j, high halves
// into word j+1; b_below is the word just below the lane's first (0 in
// lane 0). `top` collects the high half of the lane's last word (only lane
// 31's is a word of the number: word 32P).
template <int P>
__device__ __forceinline__ void mul_add(uint64_t (&acc)[P], uint64_t& top, uint32_t a,
                                        const uint32_t (&b)[P], uint32_t b_below) {
  uint32_t hi = __umulhi(a, b_below);
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t p = (uint64_t)a * b[s];
    acc[s] += (uint64_t)(uint32_t)p + hi;
    hi = (uint32_t)(p >> 32);
  }
  top += hi;
}

// Ballot carry-lookahead: lane l's 1-bit carry (or borrow) in, from each
// lane's generate bit g and propagate bit q (never both set); `out` gets
// the carry out of lane 31.
__device__ __forceinline__ uint32_t lookahead(bool g, bool q, int lane, uint32_t& out) {
  const uint32_t G = __ballot_sync(kFull, g);
  const uint32_t Q = __ballot_sync(kFull, q);
  const uint64_t s = (uint64_t)(G | Q) + G;
  out = (uint32_t)(s >> 32);
  return (((uint32_t)s ^ Q) >> lane) & 1u;
}

// r = x * y * R^{-1} mod n (one row, the warp's lanes), R = 2^(32W); x, y
// < R, n odd < R, nprime = -n^{-1} mod 2^32. r may alias x or y.
template <int P>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[P], const uint32_t (&x)[P],
                                         const uint32_t (&y)[P], const uint32_t (&n)[P],
                                         uint32_t nprime, int W, int lane) {
  uint32_t y_below = __shfl_up_sync(kFull, y[P - 1], 1);
  uint32_t n_below = __shfl_up_sync(kFull, n[P - 1], 1);
  if (lane == 0) y_below = n_below = 0u;
  uint64_t acc[P];
#pragma unroll
  for (int s = 0; s < P; ++s) acc[s] = 0;
  uint64_t top = 0;

  const int src_lanes = (W + P - 1) / P;
#pragma unroll 1
  for (int src = 0; src < src_lanes; ++src) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (src * P + s >= W) break;  // warp-uniform: the last lane's padding
      const uint32_t xi = __shfl_sync(kFull, x[s], src);
      mul_add<P>(acc, top, xi, y, y_below);
      const uint32_t m = __shfl_sync(kFull, (uint32_t)acc[0] * nprime, 0);
      mul_add<P>(acc, top, m, n, n_below);
      // word 0 is now 0 mod 2^32: its carry joins word 1, then every word
      // moves down one
      const uint64_t c0 = acc[0] >> 32;
      const uint64_t next = __shfl_down_sync(kFull, acc[0], 1);
#pragma unroll
      for (int q = 0; q + 1 < P; ++q) acc[q] = acc[q + 1];
      acc[P - 1] = lane == 31 ? top : next;
      top = 0;
      if (lane == 0) acc[0] += c0;
    }
  }

  // carry resolution: t = sum acc_j 2^(32j) < 2R over words 0 .. 32P
  uint32_t t[P];
  uint64_t c = 0;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t v = acc[s] + c;
    t[s] = (uint32_t)v;
    c = v >> 32;
  }
  // the multi-bit carry of lane 31 is word 32P of t (nonzero only when W == 32P)
  uint64_t t_top = __shfl_sync(kFull, c, 31);
  uint64_t cin = __shfl_up_sync(kFull, c, 1);
  if (lane == 0) cin = 0;
  bool all_ones = true;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t v = (uint64_t)t[s] + cin;
    t[s] = (uint32_t)v;
    cin = v >> 32;
    all_ones = all_ones && t[s] == kFull;
  }
  uint32_t carry_out;
  uint32_t c1 = lookahead(cin != 0, all_ones, lane, carry_out);
  t_top += carry_out;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t v = (uint64_t)t[s] + c1;
    t[s] = (uint32_t)v;
    c1 = (uint32_t)(v >> 32);
  }

  // d = t - n with the same lookahead over borrows; keep t where t < n
  uint32_t d[P];
  uint32_t b = 0;
  bool all_zero = true;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t v = (uint64_t)t[s] - n[s] - b;
    d[s] = (uint32_t)v;
    b = (uint32_t)(v >> 63);
    all_zero = all_zero && d[s] == 0u;
  }
  uint32_t borrow_out;
  uint32_t b1 = lookahead(b != 0, all_zero, lane, borrow_out);
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t v = (uint64_t)d[s] - b1;
    d[s] = (uint32_t)v;
    b1 = (uint32_t)(v >> 63);
  }
  const uint32_t keep = 0u - (uint32_t)(t_top < borrow_out);  // t < n: all ones
#pragma unroll
  for (int s = 0; s < P; ++s) r[s] = (t[s] & keep) | (d[s] & ~keep);
}

__device__ __forceinline__ uint32_t nprime_of(const int32_t* __restrict__ n_inv, int K, int row) {
  const int32_t* p = n_inv + (size_t)row * K;
  return ((uint32_t)p[0] & 0xFFFFu) | ((uint32_t)p[1] << 16);
}

// ---------------------------------------------------------------------------
// fsdkr_cios_mont_mul: x*y*R^{-1} mod n per row

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
cios_mont_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                     const int32_t* __restrict__ n, const int32_t* __restrict__ n_inv,
                     int rows, int K, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int W = K / 2;
  const size_t off = (size_t)row * K;
  uint32_t xv[P], yv[P], nv[P];
  load_words<P>(xv, x + off, W, lane);
  load_words<P>(yv, y + off, W, lane);
  load_words<P>(nv, n + off, W, lane);
  mont_mul<P>(xv, xv, yv, nv, nprime_of(n_inv, K, row), W, lane);
  store_words<P>(xv, out + off, W, lane);
}

// ---------------------------------------------------------------------------
// fsdkr_cios_modmul: a*b mod n per row, as MontMul(MontMul(a, r2), b)

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
cios_modmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   const int32_t* __restrict__ n, const int32_t* __restrict__ n_inv,
                   const int32_t* __restrict__ r2, int rows, int K,
                   int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int W = K / 2;
  const size_t off = (size_t)row * K;
  uint32_t av[P], bv[P], nv[P], rv[P];
  load_words<P>(av, a + off, W, lane);
  load_words<P>(bv, b + off, W, lane);
  load_words<P>(nv, n + off, W, lane);
  load_words<P>(rv, r2 + off, W, lane);
  const uint32_t np = nprime_of(n_inv, K, row);
  mont_mul<P>(av, av, rv, nv, np, W, lane);
  mont_mul<P>(av, av, bv, nv, np, W, lane);
  store_words<P>(av, out + off, W, lane);
}

// ---------------------------------------------------------------------------
// fsdkr_cios_modexp: base^exp mod n per row, 4-bit fixed windows, over a
// table of segments in one launch

// One segment: its own K, rows, exponent width and tensors. A block never
// spans two segments; first_block is the segment's first block.
struct ModexpSegment {
  const int32_t* base;
  const int32_t* exp;
  const int32_t* n;
  const int32_t* n_inv;
  const int32_t* r2;
  const int32_t* one_mont;
  int32_t* out;
  int rows, K, exp_limbs, exp_bits;
  int first_block;
};

constexpr int kMaxSegments = 32;
constexpr int kSegmentWords = 11;  // int64 words a segment in the caller's table

// The launch's segment table travels as the kernel's parameter (in the
// constant bank; a launch's parameters take at most 4 KB): no allocation,
// no copy ahead of the launch
struct ModexpTable {
  ModexpSegment seg[kMaxSegments];
  int count;
};
static_assert(sizeof(ModexpTable) <= 4096, "the segment table must fit a launch's parameters");

// One warp's row of a segment: the whole exponentiation of _modexp_kernel
template <int P>
__device__ __forceinline__ void modexp_row(const ModexpSegment& sg, int row, int lane,
                                           uint32_t* __restrict__ table) {
  const int K = sg.K;
  const int W = K / 2;
  const size_t off = (size_t)row * K;
  // the warp's window table: entry e, word slot s of lane l at
  // (e * P + s) * 32 + l (consecutive lanes, consecutive banks)
  uint32_t nv[P], acc[P], bm[P], tmp[P];
  load_words<P>(nv, sg.n + off, W, lane);
  const uint32_t np = nprime_of(sg.n_inv, K, row);
  load_words<P>(bm, sg.base + off, W, lane);
  load_words<P>(tmp, sg.r2 + off, W, lane);
  mont_mul<P>(bm, bm, tmp, nv, np, W, lane);  // into the Montgomery domain
  load_words<P>(acc, sg.one_mont + off, W, lane);
#pragma unroll
  for (int s = 0; s < P; ++s) {
    table[(0 * P + s) * 32 + lane] = acc[s];
    table[(1 * P + s) * 32 + lane] = bm[s];
    tmp[s] = bm[s];
  }
  for (int e = 2; e < 16; ++e) {
    mont_mul<P>(tmp, tmp, bm, nv, np, W, lane);
#pragma unroll
    for (int s = 0; s < P; ++s) table[(e * P + s) * 32 + lane] = tmp[s];
  }
  __syncwarp();

  const int32_t* erow = sg.exp + (size_t)row * sg.exp_limbs;
  const int exp_bits = sg.exp_bits;
  for (int wi = 0; wi < exp_bits / 4; ++wi) {
    const int shift = exp_bits - 4 * (wi + 1);
    const uint32_t w = ((uint32_t)erow[shift >> 4] >> (shift & 15)) & 15u;
#pragma unroll 1
    for (int sq = 0; sq < 4; ++sq) mont_mul<P>(acc, acc, acc, nv, np, W, lane);
    // the window's entry: a masked sum over all 16 entries
#pragma unroll
    for (int s = 0; s < P; ++s) tmp[s] = 0u;
#pragma unroll 4
    for (int e = 0; e < 16; ++e) {
      const uint32_t mask = 0u - (uint32_t)(w == (uint32_t)e);
#pragma unroll
      for (int s = 0; s < P; ++s) tmp[s] |= table[(e * P + s) * 32 + lane] & mask;
    }
    mont_mul<P>(acc, acc, tmp, nv, np, W, lane);
  }
  // leave the Montgomery domain: a product with 1
#pragma unroll
  for (int s = 0; s < P; ++s) tmp[s] = (lane == 0 && s == 0) ? 1u : 0u;
  mont_mul<P>(acc, acc, tmp, nv, np, W, lane);
  store_words<P>(acc, sg.out + off, W, lane);
  // the table holds powers of a possibly secret base
  __syncwarp();
  for (int i = lane; i < 16 * P * 32; i += 32) table[i] = 0u;
}

// PMAX: the largest P of the launch's segments; a block runs the body of
// its own segment's P (uniform over the block), so a launch of narrow
// segments does not carry a wide body's registers
template <int PMAX>
__global__ void __launch_bounds__(kWarps * 32)
cios_modexp_kernel(const __grid_constant__ ModexpTable tab) {
  extern __shared__ __align__(16) uint32_t smem_words[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int i = 0;
  while (i + 1 < tab.count && tab.seg[i + 1].first_block <= (int)blockIdx.x) ++i;
  const ModexpSegment& sg = tab.seg[i];
  const int row = ((int)blockIdx.x - sg.first_block) * kWarps + warp;
  if (row >= sg.rows) return;  // the whole warp
  const int p = words_per_lane(sg.K);
#define FSDKR_MODEXP_BODY(PP)                                                  \
  if constexpr (PP <= PMAX) {                                                  \
    if (p == PP) {                                                             \
      modexp_row<PP>(sg, row, lane, smem_words + (size_t)warp * 16 * PP * 32); \
      return;                                                                  \
    }                                                                          \
  }
  FSDKR_MODEXP_BODY(1)
  FSDKR_MODEXP_BODY(2)
  FSDKR_MODEXP_BODY(4)
  FSDKR_MODEXP_BODY(8)
  FSDKR_MODEXP_BODY(16)
#undef FSDKR_MODEXP_BODY
}

// ---------------------------------------------------------------------------
// fsdkr_cios_comb: the comb's accumulation and exit, one warp per row

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
cios_comb_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ exp,
                 int exp_limbs, int windows, const int32_t* __restrict__ n,
                 const int32_t* __restrict__ n_inv, const int32_t* __restrict__ one_mont,
                 int groups, int per_group, int K, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= groups * per_group) return;  // the whole warp
  const int g = row / per_group;
  const int W = K / 2;
  const size_t goff = (size_t)g * K;
  // table layout (16, windows, groups, K): entry e of window w for group g
  const size_t entry_stride = (size_t)windows * groups * K;

  uint32_t nv[P], acc[P], sel[P], v[P];
  load_words<P>(nv, n + goff, W, lane);
  const uint32_t np = nprime_of(n_inv, K, g);
  load_words<P>(acc, one_mont + goff, W, lane);
  const int32_t* erow = exp + (size_t)row * exp_limbs;
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
    const int shift = 4 * w;  // least significant window first
    const uint32_t d = ((uint32_t)erow[shift >> 4] >> (shift & 15)) & 15u;
    const int32_t* ent = table + ((size_t)w * groups + g) * K;
#pragma unroll
    for (int s = 0; s < P; ++s) sel[s] = 0u;
    // the window's entry: a masked sum over all 16 entries
#pragma unroll 4
    for (int e = 0; e < 16; ++e) {
      const uint32_t mask = 0u - (uint32_t)(d == (uint32_t)e);
      load_words<P>(v, ent + e * entry_stride, W, lane);
#pragma unroll
      for (int s = 0; s < P; ++s) sel[s] |= v[s] & mask;
    }
    mont_mul<P>(acc, acc, sel, nv, np, W, lane);
  }
  // leave the Montgomery domain: a product with 1
#pragma unroll
  for (int s = 0; s < P; ++s) v[s] = (lane == 0 && s == 0) ? 1u : 0u;
  mont_mul<P>(acc, acc, v, nv, np, W, lane);
  store_words<P>(acc, out + (size_t)row * K, W, lane);
}

// ---------------------------------------------------------------------------
// fsdkr_cios_comb_ladder: powers[w, g] = base_m^(16^w), one warp per group

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
cios_comb_ladder_kernel(const int32_t* __restrict__ base, const int32_t* __restrict__ n,
                        const int32_t* __restrict__ n_inv, const int32_t* __restrict__ r2,
                        int groups, int K, int windows, int32_t* __restrict__ powers) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= groups) return;
  const int W = K / 2;
  const size_t off = (size_t)g * K;
  uint32_t nv[P], p[P], tmp[P];
  load_words<P>(nv, n + off, W, lane);
  const uint32_t np = nprime_of(n_inv, K, g);
  load_words<P>(p, base + off, W, lane);
  load_words<P>(tmp, r2 + off, W, lane);
  mont_mul<P>(p, p, tmp, nv, np, W, lane);  // into the Montgomery domain
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
    store_words<P>(p, powers + ((size_t)w * groups + g) * K, W, lane);
    if (w + 1 == windows) break;  // no square after the last power
#pragma unroll 1
    for (int sq = 0; sq < 4; ++sq) mont_mul<P>(p, p, p, nv, np, W, lane);
  }
}

size_t modexp_smem(int P) { return (size_t)kWarps * 16 * P * 32 * sizeof(uint32_t); }

template <int P>
int launch_mont_mul(const void* x, const void* y, const void* n, const void* n_inv,
                    int rows, int K, void* out, cudaStream_t stream) {
  cios_mont_mul_kernel<P><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)n, (const int32_t*)n_inv,
      rows, K, (int32_t*)out);
  return (int)cudaGetLastError();
}

template <int P>
int launch_modmul(const void* a, const void* b, const void* n, const void* n_inv,
                  const void* r2, int rows, int K, void* out, cudaStream_t stream) {
  cios_modmul_kernel<P><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)n, (const int32_t*)n_inv,
      (const int32_t*)r2, rows, K, (int32_t*)out);
  return (int)cudaGetLastError();
}

template <int PMAX>
int launch_modexp(const ModexpTable& tab, int blocks, cudaStream_t stream) {
  const size_t smem = modexp_smem(PMAX);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cios_modexp_kernel<PMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cios_modexp_kernel<PMAX><<<blocks, kWarps * 32, smem, stream>>>(tab);
  return (int)cudaGetLastError();
}

template <int P>
int launch_comb(const void* table, const void* exp, int exp_limbs, int windows,
                const void* n, const void* n_inv, const void* one_mont, int groups,
                int per_group, int K, void* out, cudaStream_t stream) {
  const int rows = groups * per_group;
  cios_comb_kernel<P><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      (const int32_t*)table, (const int32_t*)exp, exp_limbs, windows, (const int32_t*)n,
      (const int32_t*)n_inv, (const int32_t*)one_mont, groups, per_group, K,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

template <int P>
int launch_comb_ladder(const void* base, const void* n, const void* n_inv, const void* r2,
                       int groups, int K, int windows, void* powers, cudaStream_t stream) {
  cios_comb_ladder_kernel<P><<<(groups + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      (const int32_t*)base, (const int32_t*)n, (const int32_t*)n_inv, (const int32_t*)r2,
      groups, K, windows, (int32_t*)powers);
  return (int)cudaGetLastError();
}

bool bad_shape(int rows, int K) { return rows < 0 || K < 2 || K % 2 || K > 1024; }

}  // namespace

#define FSDKR_CIOS_DISPATCH(K, CALL)                     \
  switch (words_per_lane(K)) {                           \
    case 1: return CALL(1);                              \
    case 2: return CALL(2);                              \
    case 4: return CALL(4);                              \
    case 8: return CALL(8);                              \
    default: return CALL(16);                            \
  }

extern "C" int fsdkr_cios_mont_mul(const void* x, const void* y, const void* n,
                                   const void* n_inv, int rows, int K, void* out,
                                   void* stream) {
  if (bad_shape(rows, K)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(P) launch_mont_mul<P>(x, y, n, n_inv, rows, K, out, s)
  FSDKR_CIOS_DISPATCH(K, CALL)
#undef CALL
}

extern "C" int fsdkr_cios_modmul(const void* a, const void* b, const void* n,
                                 const void* n_inv, const void* r2, int rows, int K,
                                 void* out, void* stream) {
  if (bad_shape(rows, K)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(P) launch_modmul<P>(a, b, n, n_inv, r2, rows, K, out, s)
  FSDKR_CIOS_DISPATCH(K, CALL)
#undef CALL
}

// segments: `count` rows of kSegmentWords int64 words, (base, exp, n,
// n_inv, r2, one_mont, out, rows, K, exp_limbs, exp_bits), in any order.
// Blocks of the longest chain (products x words) come first, so the
// segment that sets the launch's length starts at once.
extern "C" int fsdkr_cios_modexp(const int64_t* segments, int count, void* stream) {
  if (count < 1 || count > kMaxSegments) return (int)cudaErrorInvalidValue;
  ModexpTable tab = {};
  long long chain[kMaxSegments];
  int pmax = 1;
  for (int i = 0; i < count; ++i) {
    const int64_t* w = segments + (size_t)i * kSegmentWords;
    ModexpSegment sg = {(const int32_t*)w[0], (const int32_t*)w[1], (const int32_t*)w[2],
                        (const int32_t*)w[3], (const int32_t*)w[4], (const int32_t*)w[5],
                        (int32_t*)w[6], (int)w[7], (int)w[8], (int)w[9], (int)w[10], 0};
    if (w[7] > 0x7FFFFFFF || w[9] > 0x7FFFFFFF || bad_shape(sg.rows, sg.K) ||
        sg.exp_bits <= 0 || sg.exp_bits % 4 || (long long)sg.exp_limbs * 16 < sg.exp_bits)
      return (int)cudaErrorInvalidValue;
    const long long c = (16 + 5LL * (sg.exp_bits / 4)) * (sg.K / 2);
    int j = i;  // insertion by chain, longest first (stable)
    while (j > 0 && chain[j - 1] < c) {
      tab.seg[j] = tab.seg[j - 1];
      chain[j] = chain[j - 1];
      --j;
    }
    tab.seg[j] = sg;
    chain[j] = c;
    if (sg.rows > 0 && words_per_lane(sg.K) > pmax) pmax = words_per_lane(sg.K);
  }
  long long blocks = 0;
  int kept = 0;
  for (int i = 0; i < count; ++i) {
    if (tab.seg[i].rows == 0) continue;  // no block
    tab.seg[kept] = tab.seg[i];
    tab.seg[kept].first_block = (int)blocks;
    blocks += (tab.seg[i].rows + kWarps - 1) / kWarps;
    ++kept;
  }
  tab.count = kept;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pmax) {
    case 1: return launch_modexp<1>(tab, (int)blocks, s);
    case 2: return launch_modexp<2>(tab, (int)blocks, s);
    case 4: return launch_modexp<4>(tab, (int)blocks, s);
    case 8: return launch_modexp<8>(tab, (int)blocks, s);
    default: return launch_modexp<16>(tab, (int)blocks, s);
  }
}

extern "C" int fsdkr_cios_comb(const void* table, const void* exp, int exp_limbs,
                               int exp_bits, const void* n, const void* n_inv,
                               const void* one_mont, int groups, int per_group, int K,
                               void* out, void* stream) {
  if (groups < 0 || per_group < 0 || (long long)groups * per_group > 0x7FFFFFFF ||
      bad_shape(groups * per_group, K) || exp_bits <= 0 || exp_bits % 4 ||
      exp_limbs * 16 < exp_bits)
    return (int)cudaErrorInvalidValue;
  if (groups * per_group == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(P) launch_comb<P>(table, exp, exp_limbs, exp_bits / 4, n, n_inv, one_mont, \
                               groups, per_group, K, out, s)
  FSDKR_CIOS_DISPATCH(K, CALL)
#undef CALL
}

extern "C" int fsdkr_cios_comb_ladder(const void* base, const void* n, const void* n_inv,
                                      const void* r2, int groups, int K, int windows,
                                      void* powers, void* stream) {
  if (bad_shape(groups, K) || windows <= 0) return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(P) launch_comb_ladder<P>(base, n, n_inv, r2, groups, K, windows, powers, s)
  FSDKR_CIOS_DISPATCH(K, CALL)
#undef CALL
}
