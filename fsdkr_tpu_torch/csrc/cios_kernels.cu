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
//   fsdkr_cios_multi_modexp -> fsdkr_tpu/ops/montgomery.py:450 _multi_modexp_kernel
//   fsdkr_cios_shared_exp  -> fsdkr_tpu/ops/montgomery.py:183 _shared_exp_kernel
//
// Numbers cross the boundary as int32 tensors of canonical 16-bit limbs,
// (rows, K), little-endian; K is even, so R = 2^(16K) = 2^(32W) falls on a
// 32-bit word (W = K/2 words) and the products are bit-identical to the
// plain versions' (ops/montgomery.py: x*y*R^{-1} mod n, canonical, < n for
// x, y < n). The engine rounds an odd K up (BatchModExp); that changes R,
// so in-domain intermediates, never a value that leaves the engine.
//
// Layout of mont_mul<P> (cios_modexp and the smaller cios_mont_mul and
// cios_modmul launches; the sub-warp product and the ladder's block
// product are below):
// one warp per row. Lane l owns the P words l*P .. l*P+P-1 (P a
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
// each group's powers base_m^(16^w): the entry by r2, then W times (store
// the power, four squarings). The 16-entry table of every window is built
// between the two by four fsdkr_cios_mont_mul launches (ops/montgomery.py
// _comb_table). fsdkr_cios_comb then does per row W window steps of a
// masked sum over the group's 16 entries of that window and one product,
// then the exit by a product with 1: W + 1 products a row where
// fsdkr_cios_modexp does 5W + 17.
//
// The ladder is a chain of 1 + 4(W - 1) dependent products a group (2045
// at 2048-bit exponents) and has nothing else to run: 16 groups on the
// main path. What bounds it is that chain: products x the least time one
// block can take for one product. A CIOS product cannot go under W serial
// steps (each step's digit m needs the previous step's word 0); one warp a
// group ran them at about 150 cycles a step, one warp a scheduler on 4
// SMs. So the ladder runs one block a group (up to 132 groups side by
// side) on mont_mul_block, a separated-operand Montgomery product with a
// full-width digit (n_inv = -n^{-1} mod R, all K limbs):
//   T = x * y;  m = (T mod R) * n_inv mod R;  U = T + m * n;
//   r = U / R, minus n once if r >= n.
// Each of the three products is column sums (product scanning) spread
// over the block: column pair c (columns c and c + W) in S parts of I
// source words, each 32x32 -> 64 product's low half summed into its
// column and its high half into the next, in 64-bit lazy sums (below W *
// 2^33 + 2^33 < 2^44 at W <= 512); m takes only the low W columns. Their
// only serial parts are the normalisations between the products: a local
// carry of at most 12 bits into the next column, then 1-bit carries by a
// two-level ballot lookahead (each warp's bits, then the warps' bits
// through shared memory); the conditional subtraction rides on U's
// normalisation (U - n R normalised beside U, selected by its carry out).
// About 2.5 W^2 word products a product (2 W^2 for CIOS), about W / S of
// them a thread a phase, and nine block barriers. The operands, n, n_inv's
// low W words and the power stay in shared memory from one product to the
// next; each window's power goes to `powers` as 16-bit limbs. The threads a block are a launch rule per K
// (ladder_threads), set by the ladder cells of scripts/cuda_route_sweep.py.
// No branch or address depends on a limb value, the loop lengths depend
// only on K and the window count, and the block zeroes its shared memory
// before it exits. tests/test_torch_ladder_model.py replays the product.
//
// The comb's rows are many and independent (16 groups x 256 rows on the
// main path), so its pace is the schedulers' issue, not a product's
// latency: one warp per row paid the step's fixed work (three shuffles,
// the 64-bit shift, the padding test) in all 32 lanes for P = 2 words of
// real work. It runs instead on the sub-warp product mont_mul_rows<L, P>:
// L lanes a row, P words a lane, 32/L rows a warp, so each shuffle (width
// L) serves 32/L rows. Each lane forms x_i * y_t and m * n_t as IMAD.WIDE
// products with no addend and sums a word's four halves (the low ones of
// word t, the high ones of word t - 1) into its 64-bit lazy accumulator;
// the lane's top high halves go to the word above it, which after the
// shift is the lane's own last slot. The shift keeps each slot-0
// accumulator's high part in its lane (it belongs to the word above, slot
// 0 after the shift) and moves only its low 32 bits down one lane.
// Accumulators stay below (W + 1) * 2^34 + 2^32 < 2^44; the carry
// resolution and conditional subtraction are the ballot lookahead on the
// row's L bits of the warp's ballot. tests/test_torch_cios_model.py
// replays it (rows_mont_mul). Exact per-lane chains (v = a * b_t + h)
// issued more instructions a step (each IMAD.WIDE's {h, 0} addend pair
// is a move), and PTX carry chains (mad.lo.cc / madc.hi.cc) compile to
// two instructions a half-product (PERF.md).
//
// A block (4 warps, 128/L rows) never spans groups: the grid is the row
// tiles of each group in turn, and a ragged last tile masks its rows. A
// group's n, n' and one_mont are loaded once per row. The 16 entries of
// window w (16 * K int32 limbs) go to shared memory once per block by
// cp.async, double-buffered (window w+1 is in flight while window w's
// products run), are packed there to 32-bit words laid out so that lane
// l of every row reads slot s of entry e at (e * P + s) * L + l
// (consecutive lanes, consecutive banks; the block's rows read the same
// words), and every row selects from there. L is a launch rule per K
// (rows_lanes), set by the comb's lanes sweep (scripts/
// cuda_route_sweep.py --cells lanes): the fewest lanes a row that keep P
// <= kCombMaxWords, else 32.
//
// The exponents may be secret (the provers' h1^x mod N~ columns): the
// loop length is the bucketed exp_bits, the select reads all 16 entries
// at addresses that do not depend on the digit, the digit only sets the
// select's masks, no branch depends on it, and every block zeroes its
// shared memory before it exits. Bound: operations (2K^2 16x16-bit
// multiply-adds a product), as for the other kernels; the design cuts
// the instructions a row-step issues, since with thousands of rows those,
// not the chain, set the time.
//
// fsdkr_cios_mont_mul takes the same sub-warp product at launches of at
// least kRowsMinRows rows (the comb table's levels, 8192-57344 rows, and
// the 256-row launches), one product a row, no shared memory, at P <=
// kMontMulMaxWords (one product a row wants more warps than the comb's
// 513); smaller launches, one product's latency plus the launch, keep
// one warp a row. Both are read off the mont_mul cells of the same
// sweep: the sub-warp kernel led at every size measured, 256 rows up.
// fsdkr_cios_modmul (two products a row) runs on the sub-warp product at
// every size: from kRowsMinRows rows at the same lanes, below it at 32
// lanes a row (one row a warp), which led one warp a row at every size
// measured, 16-255 rows, at K=128 and 256.
//
// fsdkr_cios_multi_modexp is the joint (Straus) product prod_t b_t^e_t mod
// n of _multi_modexp_kernel, one warp a row on mont_mul<P>: the T terms'
// 16-entry tables (entry 0 the Montgomery one, entry 1 b_t R) in the
// warp's shared memory, T * 16 * 32P words; then one shared chain of
// exp_bits[0] / 4 windows, each four squarings and one masked table
// product per active term (term t is active in the chain's last
// exp_bits[t] / 4 windows); the exit by a product with 1. A row costs
// E_max + sum_t E_t / 4 + 16 T products where T modexps cost about
// 1.27 sum_t E_t. The widths are the launch's shape, descending, so every
// row of a launch takes the same terms in the same windows: no warp
// diverges on data. The prover's joint rows raise h1, h2 to secret x, rho,
// alpha, gamma, so the select is the masked sum over all 16 entries, the
// loop lengths come from the widths alone, and every warp zeroes its
// tables before it exits. A block holds as many warps (at most 4) as
// their tables fit the opt-in 227 KB: one warp's tables fit up to 16 terms
// at K <= 256, 14 at K=512, 7 at K=1024 (a launch of more is refused;
// backend.powm splits longer rows). Bound: operations, 2K^2 16x16-bit
// multiply-adds a product; like fsdkr_cios_modexp, one warp a row is a
// latency chain.
//
// fsdkr_cios_shared_exp is _shared_exp_kernel: base^E mod n per row for
// one public exponent E and one modulus a segment (the range u-power s^n
// mod n^2: every row of a receiver's group raises its own s to the
// receiver's Paillier n). Its 4-bit digits arrive as a vector; they derive
// from the public n, so the window's entry is read at the digit's address,
// with no masked sum. A launch takes up to 32 segments (a receiver group
// each), with their own moduli and digits, as fsdkr_cios_modexp takes its
// segments: one warp a row, the longest chains' blocks first.

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

// ---------------------------------------------------------------------------
// The sub-warp product: L lanes a row (lane l = lane % L of the row whose
// first lane is `first`), P words a lane (word j at lane j / P, slot j %
// P; words at or above W zero), 32/L rows a warp

// P for L lanes a row: a power of two with L * P >= K/2
__host__ __device__ __forceinline__ int rows_words_per_lane(int K, int L) {
  const int W = K / 2;
  int P = 1;
  while (L * P < W) P *= 2;
  return P;
}

// The ballot carry-lookahead of `lookahead` over each row's L bits of the
// warp's ballot
template <int L>
__device__ __forceinline__ uint32_t row_lookahead(bool g, bool q, int l, int first,
                                                  uint32_t& out) {
  constexpr uint64_t kMask = (1ull << L) - 1;
  const uint64_t G = ((uint64_t)__ballot_sync(kFull, g) >> first) & kMask;
  const uint64_t Q = ((uint64_t)__ballot_sync(kFull, q) >> first) & kMask;
  const uint64_t s = (G | Q) + G;
  out = (uint32_t)(s >> L) & 1u;
  return (uint32_t)((s ^ Q) >> l) & 1u;
}

// a * b as one IMAD.WIDE. Opaque to the compiler's front end, which would
// otherwise fold a product's high half and the next product's low half
// into extra 32-bit multiplies.
__device__ __forceinline__ uint64_t mul_wide(uint32_t a, uint32_t b) {
  uint64_t r;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(r) : "r"(a), "r"(b));
  return r;
}

// One CIOS step of mont_mul_rows on word x_i of x (shuffled to the row):
// t = (t + x_i * y + m * n) / 2^32 over the row's lazy accumulators;
// `last`: the row's last lane
template <int L, int P>
__device__ __forceinline__ void rows_step(uint64_t (&acc)[P], uint32_t xi, const uint32_t (&y)[P],
                                          const uint32_t (&n)[P], uint32_t nprime, bool last) {
  // the lane's products x_i * y_t and m * n_t (IMAD.WIDE, no addend: an
  // addend pair would cost a move a word)
  uint32_t pl[P], ph[P], ql[P], qh[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const uint64_t v = mul_wide(xi, y[t]);
    pl[t] = (uint32_t)v;
    ph[t] = (uint32_t)(v >> 32);
  }
  const uint32_t m = __shfl_sync(kFull, ((uint32_t)acc[0] + pl[0]) * nprime, 0, L);
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const uint64_t v = mul_wide(m, n[t]);
    ql[t] = (uint32_t)v;
    qh[t] = (uint32_t)(v >> 32);
  }
  // low halves join word t, high halves word t + 1 (the lane's top ones
  // the word above it, below)
  acc[0] += (uint64_t)pl[0] + ql[0];
#pragma unroll
  for (int t = 1; t < P; ++t) acc[t] += (uint64_t)pl[t] + ph[t - 1] + ql[t] + qh[t - 1];
  // word 0 of the row is now 0 mod 2^32. Shift down one word: each slot-0
  // accumulator's high part stays in its lane (the word above is slot 0
  // after the shift), its low 32 bits go down one lane
  const uint64_t c0 = acc[0] >> 32;
  uint32_t below = __shfl_down_sync(kFull, (uint32_t)acc[0], 1, L);
  if (last) below = 0u;
#pragma unroll
  for (int t = 0; t + 1 < P; ++t) acc[t] = acc[t + 1];
  acc[P - 1] = (uint64_t)ph[P - 1] + qh[P - 1] + below;
  acc[0] += c0;
}

// r = x * y * R^{-1} mod n for each of the warp's 32/L rows, R = 2^(32W);
// x, y < R, n odd < R, nprime = -n^{-1} mod 2^32. r may alias x or y.
template <int L, int P>
__device__ __forceinline__ void mont_mul_rows(uint32_t (&r)[P], const uint32_t (&x)[P],
                                              const uint32_t (&y)[P], const uint32_t (&n)[P],
                                              uint32_t nprime, int W, int l, int first) {
  uint64_t acc[P];
#pragma unroll
  for (int s = 0; s < P; ++s) acc[s] = 0;
  const bool last = l == L - 1;

  // the source lanes whose P words are all words of x: P steps an
  // iteration, so the accumulators' registers come round unmoved; then
  // the last source lane's W mod P words (warp-uniform)
  const int full = W / P;
#pragma unroll 1
  for (int src = 0; src < full; ++src) {
#pragma unroll
    for (int s = 0; s < P; ++s)
      rows_step<L, P>(acc, __shfl_sync(kFull, x[s], src, L), y, n, nprime, last);
  }
  const int rest = W - full * P;
#pragma unroll
  for (int s = 0; s + 1 < P; ++s) {
    if (s >= rest) break;
    rows_step<L, P>(acc, __shfl_sync(kFull, x[s], full, L), y, n, nprime, last);
  }

  // carry resolution: t = sum acc_j 2^(32j) < 2R over the row's words
  uint32_t t[P];
  uint32_t c = 0;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t v = acc[s] + c;
    t[s] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  // the multi-bit carry of the row's last lane is its top word (nonzero
  // only when W == L * P)
  uint32_t t_top = __shfl_sync(kFull, c, L - 1, L);
  uint32_t cin = __shfl_up_sync(kFull, c, 1, L);
  if (l == 0) cin = 0;
  bool all_ones = true;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const uint64_t v = (uint64_t)t[s] + cin;
    t[s] = (uint32_t)v;
    cin = (uint32_t)(v >> 32);
    all_ones = all_ones && t[s] == kFull;
  }
  uint32_t carry_out;
  uint32_t c1 = row_lookahead<L>(cin != 0, all_ones, l, first, carry_out);
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
  uint32_t b1 = row_lookahead<L>(b != 0, all_zero, l, first, borrow_out);
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
// fsdkr_cios_multi_modexp: prod_t base_t^exp_t mod n per row, the joint
// (Straus) ladder of _multi_modexp_kernel

constexpr int kMaxTerms = 16;                 // backend.powm._DEVICE_MAX_TERMS
constexpr size_t kMaxSmemBytes = 227 * 1024;  // a block's opt-in shared memory

// the window tables of one warp's row: T tables of 16 entries, 32P words each
__host__ __device__ __forceinline__ size_t multi_warp_smem_bytes(int terms, int P) {
  return (size_t)terms * 16 * P * 32 * sizeof(uint32_t);
}

struct MultiArgs {
  const int32_t* bases;  // (T, rows, K)
  const int32_t* exps;   // (T, rows, exp_limbs)
  const int32_t* n;
  const int32_t* n_inv;
  const int32_t* r2;
  const int32_t* one_mont;
  int32_t* out;
  int terms, rows, K, exp_limbs, warps;
  int exp_bits[kMaxTerms];  // descending
};

// One warp's row: T tables, then one shared chain of exp_bits[0] / 4
// windows, each four squarings and one product per active term
template <int P>
__device__ __forceinline__ void multi_modexp_row(const MultiArgs& a, int row, int lane,
                                                 uint32_t* __restrict__ tables) {
  const int K = a.K;
  const int W = K / 2;
  const size_t off = (size_t)row * K;
  const size_t plane = (size_t)a.rows * K;
  uint32_t nv[P], acc[P], bm[P], tmp[P];
  load_words<P>(nv, a.n + off, W, lane);
  const uint32_t np = nprime_of(a.n_inv, K, row);
  load_words<P>(acc, a.one_mont + off, W, lane);  // entry 0 of every table, and acc's start
  for (int t = 0; t < a.terms; ++t) {
    // term t's table: entry e, slot s of lane l at (e * P + s) * 32 + l
    uint32_t* table = tables + (size_t)t * 16 * P * 32;
    load_words<P>(bm, a.bases + t * plane + off, W, lane);
    load_words<P>(tmp, a.r2 + off, W, lane);
    mont_mul<P>(bm, bm, tmp, nv, np, W, lane);  // into the Montgomery domain
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
  }
  __syncwarp();

  const int w_total = a.exp_bits[0] / 4;
  for (int wi = 0; wi < w_total; ++wi) {
#pragma unroll 1
    for (int sq = 0; sq < 4; ++sq) mont_mul<P>(acc, acc, acc, nv, np, W, lane);
    for (int t = 0; t < a.terms; ++t) {
      // term t's digits fill the chain's last exp_bits[t] / 4 windows; the
      // widths are the launch's shape, so every row takes the same terms
      const int start = w_total - a.exp_bits[t] / 4;
      if (wi < start) continue;
      const int shift = a.exp_bits[t] - 4 * (wi - start + 1);
      const int32_t* erow = a.exps + ((size_t)t * a.rows + row) * a.exp_limbs;
      const uint32_t w = ((uint32_t)erow[shift >> 4] >> (shift & 15)) & 15u;
      const uint32_t* table = tables + (size_t)t * 16 * P * 32;
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
  }
  // leave the Montgomery domain: a product with 1
#pragma unroll
  for (int s = 0; s < P; ++s) tmp[s] = (lane == 0 && s == 0) ? 1u : 0u;
  mont_mul<P>(acc, acc, tmp, nv, np, W, lane);
  store_words<P>(acc, a.out + off, W, lane);
  // the tables hold powers of possibly secret bases
  __syncwarp();
  for (int i = lane; i < a.terms * 16 * P * 32; i += 32) tables[i] = 0u;
}

// a.warps warps a block (as many as the tables let a block hold, at most 4)
template <int P>
__global__ void __launch_bounds__(kWarps * 32)
cios_multi_modexp_kernel(const __grid_constant__ MultiArgs a) {
  extern __shared__ __align__(16) uint32_t smem_words[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = (int)blockIdx.x * a.warps + warp;
  if (row >= a.rows) return;  // the whole warp
  multi_modexp_row<P>(a, row, lane, smem_words + (size_t)warp * a.terms * 16 * P * 32);
}

// ---------------------------------------------------------------------------
// fsdkr_cios_shared_exp: base^E mod n per row, one public exponent E (as
// its 4-bit digits) and one modulus a segment, over a table of segments

struct SharedExpSegment {
  const int32_t* base;    // (rows, K)
  const int32_t* digits;  // (windows,), most significant first
  const int32_t* n;       // (1, K): the segment's modulus and its constants
  const int32_t* n_inv;
  const int32_t* r2;
  const int32_t* one_mont;
  int32_t* out;
  int rows, K, windows;
  int first_block;
};

constexpr int kSharedExpWords = 10;  // int64 words a segment in the caller's table

struct SharedExpTable {
  SharedExpSegment seg[kMaxSegments];
  int count;
};
static_assert(sizeof(SharedExpTable) <= 4096, "the segment table must fit a launch's parameters");

// One warp's row of a segment. The digits derive from the receiver's public
// Paillier modulus, so the window's entry is read at the digit's address
template <int P>
__device__ __forceinline__ void shared_exp_row(const SharedExpSegment& sg, int row, int lane,
                                               uint32_t* __restrict__ table) {
  const int K = sg.K;
  const int W = K / 2;
  uint32_t nv[P], acc[P], bm[P], tmp[P];
  load_words<P>(nv, sg.n, W, lane);
  const uint32_t np = nprime_of(sg.n_inv, K, 0);
  load_words<P>(bm, sg.base + (size_t)row * K, W, lane);
  load_words<P>(tmp, sg.r2, W, lane);
  mont_mul<P>(bm, bm, tmp, nv, np, W, lane);
  load_words<P>(acc, sg.one_mont, W, lane);
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
  for (int wi = 0; wi < sg.windows; ++wi) {
    const uint32_t d = (uint32_t)sg.digits[wi] & 15u;
#pragma unroll 1
    for (int sq = 0; sq < 4; ++sq) mont_mul<P>(acc, acc, acc, nv, np, W, lane);
#pragma unroll
    for (int s = 0; s < P; ++s) tmp[s] = table[(d * P + s) * 32 + lane];
    mont_mul<P>(acc, acc, tmp, nv, np, W, lane);
  }
#pragma unroll
  for (int s = 0; s < P; ++s) tmp[s] = (lane == 0 && s == 0) ? 1u : 0u;
  mont_mul<P>(acc, acc, tmp, nv, np, W, lane);
  store_words<P>(acc, sg.out + (size_t)row * K, W, lane);
  __syncwarp();
  for (int i = lane; i < 16 * P * 32; i += 32) table[i] = 0u;
}

template <int PMAX>
__global__ void __launch_bounds__(kWarps * 32)
cios_shared_exp_kernel(const __grid_constant__ SharedExpTable tab) {
  extern __shared__ __align__(16) uint32_t smem_words[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int i = 0;
  while (i + 1 < tab.count && tab.seg[i + 1].first_block <= (int)blockIdx.x) ++i;
  const SharedExpSegment& sg = tab.seg[i];
  const int row = ((int)blockIdx.x - sg.first_block) * kWarps + warp;
  if (row >= sg.rows) return;  // the whole warp
  const int p = words_per_lane(sg.K);
#define FSDKR_SHARED_EXP_BODY(PP)                                                 \
  if constexpr (PP <= PMAX) {                                                     \
    if (p == PP) {                                                                \
      shared_exp_row<PP>(sg, row, lane, smem_words + (size_t)warp * 16 * PP * 32); \
      return;                                                                     \
    }                                                                             \
  }
  FSDKR_SHARED_EXP_BODY(1)
  FSDKR_SHARED_EXP_BODY(2)
  FSDKR_SHARED_EXP_BODY(4)
  FSDKR_SHARED_EXP_BODY(8)
  FSDKR_SHARED_EXP_BODY(16)
#undef FSDKR_SHARED_EXP_BODY
}

// ---------------------------------------------------------------------------
// The sub-warp kernels: fsdkr_cios_comb and fsdkr_cios_mont_mul's large
// launches

// The launch rules, from the lanes and mont_mul cells of
// scripts/cuda_route_sweep.py (PERF.md): each kernel takes the fewest
// lanes a row (8, 16, 32) that keep P at most its words a lane, else 32;
// fsdkr_cios_mont_mul is sub-warp from kRowsMinRows rows
constexpr int kRowsWarps = 4;          // warps a block
constexpr int kCombMaxWords = 8;       // cios_comb: 8 lanes a row at K=128
constexpr int kMontMulMaxWords = 4;    // cios_mont_mul: 16 at K=128, 32 at K=256
constexpr int kRowsMinRows = 256;

// L of a sub-warp kernel at K limbs: 8, 16 or 32 lanes a row
__host__ __device__ __forceinline__ int rows_lanes(int K, int max_words) {
  if (rows_words_per_lane(K, 8) <= max_words) return 8;
  if (rows_words_per_lane(K, 16) <= max_words) return 16;
  return 32;
}

__device__ __forceinline__ void cp_async8(uint32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared memory of a comb block, in 32-bit words: two buffers of a
// window's 16 raw entries (16 * K limbs each), then the packed entries
// (16 * P * L words)
__host__ __device__ __forceinline__ int comb_smem_words(int K, int L, int P) {
  return 2 * 16 * K + 16 * P * L;
}

// fsdkr_cios_comb: the comb's accumulation and exit, L lanes a row
template <int L, int P>
__global__ void __launch_bounds__(kRowsWarps * 32)
cios_comb_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ exp,
                 int exp_limbs, int windows, const int32_t* __restrict__ n,
                 const int32_t* __restrict__ n_inv, const int32_t* __restrict__ one_mont,
                 int groups, int per_group, int K, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int kRows = kRowsWarps * 32 / L;  // rows a block
  const int W = K / 2;
  const int tiles = (per_group + kRows - 1) / kRows;
  const int g = (int)blockIdx.x / tiles;
  const int first_row = ((int)blockIdx.x - g * tiles) * kRows;
  const int lane = threadIdx.x & 31;
  const int l = lane & (L - 1);
  const int first = lane - l;
  const int row = first_row + (int)threadIdx.x / L;  // of the group
  const bool active = row < per_group;                 // a ragged last tile masks the rest
  // a warp with no row of the group skips the products (warp-uniform)
  const bool warp_active = first_row + (int)(threadIdx.x >> 5) * (32 / L) < per_group;
  const size_t goff = (size_t)g * K;
  // table layout (16, windows, groups, K): entry e of window w for group g
  const size_t entry_stride = (size_t)windows * groups * K;
  uint32_t* raw = smem;                 // [2][16][K] limbs
  uint32_t* packed = smem + 2 * 16 * K;  // [16][P][L] words

  // window w's 16 entries into raw buffer w & 1, 8 bytes (one word) a copy
  auto fetch = [&](int w) {
    uint32_t* dst = raw + (w & 1) * 16 * K;
    const int32_t* src = table + ((size_t)w * groups + g) * K;
    for (int c = threadIdx.x; c < 16 * W; c += kRowsWarps * 32) {
      const int e = c / W, j = c - e * W;
      cp_async8(dst + e * K + 2 * j, src + e * entry_stride + 2 * j);
    }
    cp_async_commit();
  };

  uint32_t nv[P], acc[P], sel[P];
  load_words<P>(nv, n + goff, W, l);
  const uint32_t np = nprime_of(n_inv, K, g);
  load_words<P>(acc, one_mont + goff, W, l);
  const int32_t* erow = exp + ((size_t)g * per_group + (active ? row : 0)) * exp_limbs;

  fetch(0);
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
    if (w + 1 < windows) {
      fetch(w + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // window w landed; every row is done with the last packed window
    const uint32_t* rw = raw + (w & 1) * 16 * K;
    for (int i = threadIdx.x; i < 16 * P * L; i += kRowsWarps * 32) {
      const int e = i / (P * L), s = (i / L) % P, j = (i % L) * P + s;
      packed[i] = j < W ? (rw[e * K + 2 * j] & 0xFFFFu) | (rw[e * K + 2 * j + 1] << 16) : 0u;
    }
    __syncthreads();
    const int shift = 4 * w;  // least significant window first
    const uint32_t d = active ? ((uint32_t)erow[shift >> 4] >> (shift & 15)) & 15u : 0u;
    // the window's entry: a masked sum over all 16 entries
#pragma unroll
    for (int s = 0; s < P; ++s) sel[s] = 0u;
#pragma unroll 4
    for (int e = 0; e < 16; ++e) {
      const uint32_t mask = 0u - (uint32_t)(d == (uint32_t)e);
#pragma unroll
      for (int s = 0; s < P; ++s) sel[s] |= packed[(e * P + s) * L + l] & mask;
    }
    if (warp_active) mont_mul_rows<L, P>(acc, acc, sel, nv, np, W, l, first);
  }
  // leave the Montgomery domain: a product with 1
#pragma unroll
  for (int s = 0; s < P; ++s) sel[s] = (l == 0 && s == 0) ? 1u : 0u;
  if (warp_active) mont_mul_rows<L, P>(acc, acc, sel, nv, np, W, l, first);
  if (active) store_words<P>(acc, out + ((size_t)g * per_group + row) * K, W, l);
  // the buffers held the table's entries: zero them before the block exits
  __syncthreads();
  for (int i = threadIdx.x; i < comb_smem_words(K, L, P); i += kRowsWarps * 32) smem[i] = 0u;
}

// fsdkr_cios_mont_mul at kRowsMinRows rows and more: L lanes a row
template <int L, int P>
__global__ void __launch_bounds__(kRowsWarps * 32)
cios_mont_mul_rows_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                          const int32_t* __restrict__ n, const int32_t* __restrict__ n_inv,
                          int rows, int K, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (L - 1);
  const int first = lane - l;
  const int warp_row = ((int)blockIdx.x * kRowsWarps + (int)(threadIdx.x >> 5)) * (32 / L);
  if (warp_row >= rows) return;  // the whole warp
  const int row = warp_row + first / L;
  const int src = row < rows ? row : warp_row;  // a masked row computes its warp's first
  const int W = K / 2;
  const size_t off = (size_t)src * K;
  uint32_t xv[P], yv[P], nv[P];
  load_words<P>(xv, x + off, W, l);
  load_words<P>(yv, y + off, W, l);
  load_words<P>(nv, n + off, W, l);
  mont_mul_rows<L, P>(xv, xv, yv, nv, nprime_of(n_inv, K, src), W, l, first);
  if (row < rows) store_words<P>(xv, out + off, W, l);
}

// fsdkr_cios_modmul: a*b mod n per row, as MontMul(MontMul(a, r2), b), L
// lanes a row
template <int L, int P>
__global__ void __launch_bounds__(kRowsWarps * 32)
cios_modmul_rows_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                        const int32_t* __restrict__ n, const int32_t* __restrict__ n_inv,
                        const int32_t* __restrict__ r2, int rows, int K,
                        int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (L - 1);
  const int first = lane - l;
  const int warp_row = ((int)blockIdx.x * kRowsWarps + (int)(threadIdx.x >> 5)) * (32 / L);
  if (warp_row >= rows) return;  // the whole warp
  const int row = warp_row + first / L;
  const int src = row < rows ? row : warp_row;  // a masked row computes its warp's first
  const int W = K / 2;
  const size_t off = (size_t)src * K;
  uint32_t av[P], bv[P], nv[P], rv[P];
  load_words<P>(av, a + off, W, l);
  load_words<P>(bv, b + off, W, l);
  load_words<P>(nv, n + off, W, l);
  load_words<P>(rv, r2 + off, W, l);
  const uint32_t np = nprime_of(n_inv, K, src);
  mont_mul_rows<L, P>(av, av, rv, nv, np, W, l, first);
  mont_mul_rows<L, P>(av, av, bv, nv, np, W, l, first);
  if (row < rows) store_words<P>(av, out + off, W, l);
}

// ---------------------------------------------------------------------------
// fsdkr_cios_comb_ladder: powers[w, g] = base_m^(16^w), one block a group
// on the full-width-digit product mont_mul_block (see the note at the top)

constexpr int kChunk = 8;   // source words a thread takes at a time
constexpr int kPad = 256;   // zero words below each split operand (see LadderSmem)

// The launch rule: threads a block at K limbs, from the ladder cells of
// scripts/cuda_route_sweep.py (PERF.md): 256 led at K=128 and 256 (512
// within 0.3% there), 512 at K=512 and 1024; 128 trailed at every K
__host__ __device__ __forceinline__ int ladder_threads(int K) { return K <= 256 ? 256 : 512; }

// S, the parts a column pair is split into: the largest power of two at
// most NT / W, W and 32
__host__ __device__ __forceinline__ int ladder_parts(int W, int NT) {
  int s = 1;
  while (2 * s <= 32 && 2 * s <= W && 2 * s * W <= NT) s *= 2;
  return s;
}

// I, the source words of a part: ceil(W / S) rounded up to whole chunks
__host__ __device__ __forceinline__ int ladder_part_words(int W, int S) {
  return ((W + S - 1) / S + kChunk - 1) / kChunk * kChunk;
}

// The block's shared memory, in 32-bit words from a 16-byte aligned base
// (lo, hi and the permuted buffers start 16-byte aligned):
//   lo, hi   2W + 1 uint64 each (2W + 2 kept): column c's sum of its
//            products' low halves (lo) and of the high halves landing in
//            it, from column c - 1 (hi); lo[2W] and hi[0] stay 0
//   xp, tp, mp   S * IP each: x, T's low W words and the digit m, permuted
//   yl, yh   kPad + 2W each: the right operand split by the column its
//            words reach, yl[kPad + k] = y_(k - W) for k >= W (column c:
//            the word for source word i <= c sits at k = W + c - i), and
//            yh[kPad + k] = y_k for k < W (column c + W); zeros elsewhere
//   nl       kPad + 2W: n_inv's low W words laid out as yl
//   nnl, nnh kPad + 2W each: n laid out as yl and as yh
//   t        2W + 4: T = x * y (word 2W is 0)
//   bits     128: each warp's generate and propagate bit of up to two
//            lookaheads at once
struct LadderSmem {
  int W, S, log2S, I, IP;
  uint64_t *lo, *hi;
  uint32_t *xp, *tp, *mp, *yl, *yh, *nl, *nnl, *nnh, *t, *bits;

  __device__ __forceinline__ LadderSmem(uint32_t* base, int W_, int NT) : W(W_) {
    S = ladder_parts(W, NT);
    log2S = __ffs(S) - 1;
    I = ladder_part_words(W, S);
    IP = I + 4;
    lo = (uint64_t*)base;
    hi = lo + 2 * W + 2;
    xp = (uint32_t*)(hi + 2 * W + 2);
    tp = xp + S * IP;
    mp = tp + S * IP;
    yl = mp + S * IP;
    yh = yl + kPad + 2 * W;
    nl = yh + kPad + 2 * W;
    nnl = nl + kPad + 2 * W;
    nnh = nnl + kPad + 2 * W;
    t = nnh + kPad + 2 * W;
    bits = t + 2 * W + 4;
  }
  // The left operand of a product is read a part at a time (part s takes
  // words s, s + S, s + 2S, ...): it is kept permuted, word j at (j mod
  // S) * IP + j / S with IP = I + 4 (a part's words contiguous and 16-byte
  // aligned, the parts' rows on different banks), so a lane loads four of
  // its words at once. Slots of words at or above W stay 0.
  __device__ __forceinline__ int perm(int j) const { return (j & (S - 1)) * IP + (j >> log2S); }
};

// the words of LadderSmem, zeroed at entry and at exit
__host__ __device__ __forceinline__ int ladder_smem_words(int W, int NT) {
  const int S = ladder_parts(W, NT);
  return 8 * (W + 1) + 3 * S * (ladder_part_words(W, S) + 4) + 5 * (kPad + 2 * W) +
         (2 * W + 4) + 128;
}

// Two-level ballot carry-lookahead over the block, for NL independent
// sums at once: thread t's 1-bit carry in of sum k, from each thread's
// generate bit g[k] and propagate bit q[k] (never both set); out[k] gets
// the carry out of the last thread. Each warp's (G, Q) pairs go through
// shared memory (bits: 64 words a sum), and one more lookahead over the
// warps' bits gives each warp its carry in. Every thread of the block
// calls it; a __syncthreads separates its reads of `bits` from the next
// call's writes.
template <int NT, int NL>
__device__ __forceinline__ void block_lookahead(const bool (&g)[NL], const bool (&q)[NL],
                                                uint32_t* bits, uint32_t (&cin)[NL],
                                                uint32_t (&out)[NL]) {
  constexpr int kWarpsNT = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t G[NL], Q[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    G[k] = __ballot_sync(kFull, g[k]);
    Q[k] = __ballot_sync(kFull, q[k]);
    if (lane == 0) {
      bits[64 * k + warp] = (uint32_t)((((uint64_t)(G[k] | Q[k]) + G[k]) >> 32) & 1u);
      bits[64 * k + 32 + warp] = Q[k] == kFull;  // the warp generates; propagates
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint32_t Gw = __ballot_sync(kFull, lane < kWarpsNT && bits[64 * k + lane]);
    const uint32_t Qw = __ballot_sync(kFull, lane < kWarpsNT && bits[64 * k + 32 + lane]);
    const uint64_t sw = (uint64_t)(Gw | Qw) + Gw;
    out[k] = (uint32_t)(sw >> kWarpsNT) & 1u;
    const uint32_t cw = (uint32_t)((sw ^ Qw) >> warp) & 1u;  // into this warp
    const uint64_t s = (uint64_t)(G[k] | Q[k]) + G[k] + cw;
    cin[k] = (uint32_t)((s ^ Q[k]) >> lane) & 1u;
  }
}

// The column sums of x * y (kLow: only the low W columns), as the block's
// threads split them. Column pair c holds columns c and c + W; its S
// parts sit on lanes PW = 32 / S apart (lane = s * PW + c % PW), part s
// taking the source words i = s + S*u, u < I, kChunk at a time. For each
// i, the word of y is y_((c - i) mod W): into column c where i <= c
// (found in yl), else column c + W (found in yh). x is permuted (xp: a
// part's words contiguous), so a lane loads four words of x at once; the
// warp's lanes read at most PW + S - 1 consecutive words of yl or yh at a
// time (no bank conflict). Four sums of each kind shorten the add chains
// (loading the next chunk ahead of this one's products was slower on the
// H100: the copies between them take the multiply pipe). A chunk whose
// source words all lie below (above) the warp's pairs reads yl (yh)
// alone; one across the warp's diagonal reads both, each product against
// the other half's zeros, so no product is selected (kLow reads nl alone
// and stops at the chunks above: all zeros); the warp decides, from
// indices only. Source words at or above W read xp's zero slots. The
// parts are summed by shuffles (a reduce-scatter, so each lane sends at
// most two of its four sums), then written to lo and hi.
template <bool kLow, int NT>
__device__ __forceinline__ void column_sums(const LadderSmem& sm, const uint32_t* xp,
                                            const uint32_t* yl, const uint32_t* yh) {
  constexpr int kWarpsNT = NT / 32;
  const int W = sm.W, S = sm.S, I = sm.I;
  const int pw_log2 = 5 - sm.log2S;
  const int pw = 1 << pw_log2;  // column pairs a warp (all shifts: no division)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = lane >> pw_log2;
  const int rounds = (W * S + NT - 1) / NT;
  const uint32_t* xs = xp + s * sm.IP;
  for (int r = 0; r < rounds; ++r) {
    const int c0 = (r * kWarpsNT + warp) << pw_log2;  // the warp's first pair
    const int c_row = c0 + (lane & (pw - 1));
    const int c = c_row < W ? c_row : W - 1;  // a lane past W repeats the last (discarded)
    const int c_min = c0 < W ? c0 : W - 1;
    const int c_max = c0 + pw - 1 < W ? c0 + pw - 1 : W - 1;
    const int k0 = kPad + W + c - s;  // + -S*u: the y word for i = s + S*u
    uint64_t aL[4] = {0, 0, 0, 0}, aH[4] = {0, 0, 0, 0};
    uint64_t bL[4] = {0, 0, 0, 0}, bH[4] = {0, 0, 0, 0};
    // the chunk's products x_i * y[k] into sums a (low) or b (high)
    auto add = [&](const uint32_t (&xv)[kChunk], const uint32_t* yb, int u0, uint64_t (&sL)[4],
                   uint64_t (&sH)[4]) {
      uint32_t yv[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) yv[u] = yb[k0 - S * (u0 + u)];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const uint64_t p = mul_wide(xv[u], yv[u]);
        sL[u & 3] += (uint32_t)p;
        sH[u & 3] += (uint32_t)(p >> 32);
      }
    };
#pragma unroll 1
    for (int u0 = 0; u0 < I; u0 += kChunk) {
      const bool below = S * (u0 + kChunk) - 1 <= c_min;  // every i <= every c
      const bool above = S * u0 > c_max;                  // every i > every c
      if (kLow && above) break;  // nl's zeros from here on
      uint32_t xv[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const uint4 v4 = *reinterpret_cast<const uint4*>(xs + u0 + 4 * q);
        xv[4 * q] = v4.x;
        xv[4 * q + 1] = v4.y;
        xv[4 * q + 2] = v4.z;
        xv[4 * q + 3] = v4.w;
      }
      // a chunk across the warp's diagonal takes both halves, each
      // against its split operand's zeros
      if (kLow || !above) add(xv, yl, u0, aL, aH);
      if (!kLow && !below) add(xv, yh, u0, bL, bH);
    }
    // the parts' sums: 0 -> column c, 1 -> c + 1, 2 -> c + W, 3 -> c + W + 1
    // (kLow: 0 and 1). The top bits of s reduce-scatter them (the lanes
    // of each half keep half the values and receive the other half's), the
    // lower bits of s add whole.
    uint64_t v0 = aL[0] + aL[1] + aL[2] + aL[3], v1 = aH[0] + aH[1] + aH[2] + aH[3];
    uint64_t v2 = bL[0] + bL[1] + bL[2] + bL[3], v3 = bH[0] + bH[1] + bH[2] + bH[3];
    int q = 0, held = kLow ? 2 : 4, scatter = 0;  // held: values from q on
    if (S >= 2) {
      const bool h1 = lane & 16;  // s's top bit
      if (kLow) {
        v0 = (h1 ? v1 : v0) + __shfl_xor_sync(kFull, h1 ? v0 : v1, 16);
        q = h1;
        held = 1;
        scatter = 1;
      } else {
        const uint64_t send0 = h1 ? v0 : v2, send1 = h1 ? v1 : v3;
        v0 = (h1 ? v2 : v0) + __shfl_xor_sync(kFull, send0, 16);
        v1 = (h1 ? v3 : v1) + __shfl_xor_sync(kFull, send1, 16);
        q = h1 ? 2 : 0;
        held = 2;
        scatter = 1;
        if (S >= 4) {
          const bool h2 = lane & 8;  // s's next bit
          v0 = (h2 ? v1 : v0) + __shfl_xor_sync(kFull, h2 ? v0 : v1, 8);
          q += h2;
          held = 1;
          scatter = 2;
        }
      }
    }
    for (int off = 16 >> scatter; off >= pw; off /= 2) v0 += __shfl_xor_sync(kFull, v0, off);
    if (c_row < W && (s & ((S >> scatter) - 1)) == 0) {
      const uint64_t held_v[4] = {v0, v1, v2, v3};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < held) {
          const int qi = q + i;
          ((qi & 1) ? sm.hi : sm.lo)[c + (qi & 1) + (qi >> 1) * W] = held_v[i];
        }
      }
    }
  }
}

// positions a thread owns at most (2W + 3 <= 1027)
__host__ __device__ constexpr int ladder_qmax(int NT) { return (2 * 512 + 3 + NT - 1) / NT; }

// Normalise column values v_0 .. v_(N-1) (col(c, v) sets v[k] for sum k <
// NL, each below 2^44) into the N + 1 words of their sum (word N the carry
// out), NL sums at once, over NT threads: thread t owns positions t*Q ..
// t*Q + Q - 1 and hands each one's words to put(j, words, out), out[k]
// being the carry out of position N - 1 (from the 1-bit carries; the
// local carry into position N is not in it). Position j takes v_j's low
// 32 bits and v_(j-1)'s high bits (the local carry, below 2^12); the
// thread ripples its positions (1-bit carries now, and a thread that
// carries out cannot be all ones), and one lookahead resolves the 1-bit
// carries between threads. The loops stop at Q, the same for all.
template <int NT, int QMAX, int NL, class Col, class Put>
__device__ __forceinline__ void normalize(int N, const Col& col, uint32_t* bits, const Put& put) {
  const int positions = N + 1;
  const int Q = (positions + NT - 1) / NT;
  const int j0 = (int)threadIdx.x * Q;
  uint32_t w[NL][QMAX];
  bool g[NL], ones[NL];
  uint32_t c[NL], cin[NL], out[NL];
  uint64_t below[NL], v[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) below[k] = 0;
  if (j0 >= 1 && j0 <= N) col(j0 - 1, below);
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    c[k] = 0;
    ones[k] = true;
  }
#pragma unroll
  for (int s = 0; s < QMAX; ++s) {
    if (s == Q) break;
    const int j = j0 + s;
#pragma unroll
    for (int k = 0; k < NL; ++k) v[k] = 0;
    if (j < N) col(j, v);
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const uint64_t sum = (v[k] & 0xFFFFFFFFull) + (below[k] >> 32) + c[k];
      below[k] = v[k];
      w[k][s] = (uint32_t)sum;
      if (j < N) {  // position N: its carries stay out of out[k]
        c[k] = (uint32_t)(sum >> 32);
        ones[k] = ones[k] && w[k][s] == kFull;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) g[k] = c[k] != 0;
  block_lookahead<NT, NL>(g, ones, bits, cin, out);
#pragma unroll
  for (int s = 0; s < QMAX; ++s) {
    if (s == Q) break;
    uint32_t words[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const uint64_t sum = (uint64_t)w[k][s] + cin[k];
      words[k] = (uint32_t)sum;
      cin[k] = (uint32_t)(sum >> 32);
    }
    if (j0 + s < positions) put(j0 + s, words, out);
  }
}

// x * y * R^{-1} mod n for the block's group, R = 2^(32W), x, y < n: x
// permuted in sm.xp, y split in sm.yl and sm.yh; the result goes to both
// (for the next square). T = x * y; m = (T mod R) * n_inv mod R; U = T +
// m * n; U / R, minus n once if it is at least n. The subtraction rides on U's normalisation:
// V = U + (2^(32(2W+2)) - n R), normalised beside U by the same
// lookahead, carries out of its word 2W + 1 exactly when U >= n R, and
// then holds U - n R; each thread that owns a word of the result reads
// that carry from the lookahead and selects by mask.
template <int NT>
__device__ __forceinline__ void mont_mul_block(const LadderSmem& sm) {
  const int W = sm.W;
  // T = x * y: 2W + 1 columns (word 2W of T is 0)
  column_sums<false, NT>(sm, sm.xp, sm.yl, sm.yh);
  __syncthreads();
  normalize<NT, ladder_qmax(NT), 1>(
      2 * W + 1, [&](int c, uint64_t (&v)[1]) { v[0] = sm.lo[c] + sm.hi[c]; }, sm.bits,
      [&](int j, const uint32_t (&v)[1], const uint32_t (&)[1]) {
        if (j <= 2 * W) sm.t[j] = v[0];
        if (j < W) sm.tp[sm.perm(j)] = v[0];
      });
  __syncthreads();
  // m = T_lo * n_inv mod R: the low W columns, the carry out dropped
  column_sums<true, NT>(sm, sm.tp, sm.nl, nullptr);
  __syncthreads();
  normalize<NT, ladder_qmax(NT), 1>(
      W, [&](int c, uint64_t (&v)[1]) { v[0] = sm.lo[c] + sm.hi[c]; }, sm.bits,
      [&](int j, const uint32_t (&v)[1], const uint32_t (&)[1]) {
        if (j < W) sm.mp[sm.perm(j)] = v[0];
      });
  __syncthreads();
  // U = T + m * n over 2W + 2 columns (U < 2nR: words below W are 0, word
  // 2W is 0 or 1, word 2W + 1 is 0), and V = U + the two's complement of
  // n R: 0 below word W, ~n + 1 on words W .. 2W - 1, all ones above.
  // out[1]: V carried out of word 2W + 1, so U >= n R and V holds U - n R
  column_sums<false, NT>(sm, sm.mp, sm.nnl, sm.nnh);
  __syncthreads();
  normalize<NT, ladder_qmax(NT), 2>(
      2 * W + 2,
      [&](int c, uint64_t (&v)[2]) {
        const uint64_t u = c <= 2 * W ? sm.lo[c] + sm.hi[c] + sm.t[c] : 0;
        const uint32_t comp = c < W ? 0u
                              : c < 2 * W ? ~sm.nnh[kPad + c - W] + (c == W ? 1u : 0u)
                                          : kFull;
        v[0] = u;
        v[1] = u + comp;
      },
      sm.bits,
      [&](int j, const uint32_t (&v)[2], const uint32_t (&out)[2]) {
        if (j >= W && j < 2 * W) {
          const uint32_t take = 0u - out[1];
          const uint32_t r = (v[0] & ~take) | (v[1] & take);
          sm.xp[sm.perm(j - W)] = r;
          sm.yh[kPad + j - W] = r;
          sm.yl[kPad + j] = r;
        }
      });
  __syncthreads();
}

__device__ __forceinline__ uint32_t word_at(const int32_t* __restrict__ row, int j) {
  return ((uint32_t)row[2 * j] & 0xFFFFu) | ((uint32_t)row[2 * j + 1] << 16);
}

// One block a group: the entry by r2, then per window the power stored
// and four squarings, every product a mont_mul_block (one call site)
template <int NT>
__global__ void __launch_bounds__(NT)
cios_comb_ladder_kernel(const int32_t* __restrict__ base, const int32_t* __restrict__ n,
                        const int32_t* __restrict__ n_inv, const int32_t* __restrict__ r2,
                        int groups, int K, int windows, int32_t* __restrict__ powers) {
  extern __shared__ __align__(16) uint32_t ladder_smem[];
  const int g = blockIdx.x;
  const int W = K / 2;
  const LadderSmem sm(ladder_smem, W, NT);
  const int words = ladder_smem_words(W, NT);
  for (int i = threadIdx.x; i < words; i += NT) ladder_smem[i] = 0u;
  __syncthreads();
  const size_t off = (size_t)g * K;
  for (int j = threadIdx.x; j < W; j += NT) {
    sm.xp[sm.perm(j)] = word_at(base + off, j);
    sm.yh[kPad + j] = sm.yl[kPad + W + j] = word_at(r2 + off, j);
    sm.nnh[kPad + j] = sm.nnl[kPad + W + j] = word_at(n + off, j);
    sm.nl[kPad + W + j] = word_at(n_inv + off, j);
  }
  __syncthreads();
  // product 0 takes the base into the Montgomery domain; product 4w is
  // power w
  const int products = 1 + 4 * (windows - 1);
#pragma unroll 1
  for (int step = 0; step < products; ++step) {
    mont_mul_block<NT>(sm);
    if (step % 4 == 0) {
      int32_t* out = powers + ((size_t)(step / 4) * groups + g) * K;
      for (int j = threadIdx.x; j < W; j += NT) {
        const uint32_t v = sm.xp[sm.perm(j)];
        out[2 * j] = (int32_t)(v & 0xFFFFu);
        out[2 * j + 1] = (int32_t)(v >> 16);
      }
    }
  }
  // the buffers held powers of the base: zero them before the block exits
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += NT) ladder_smem[i] = 0u;
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
int launch_multi_modexp(MultiArgs a, cudaStream_t stream) {
  const size_t per_warp = multi_warp_smem_bytes(a.terms, P);
  if (per_warp > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  a.warps = (int)(kMaxSmemBytes / per_warp < (size_t)kWarps ? kMaxSmemBytes / per_warp : kWarps);
  const size_t smem = per_warp * a.warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cios_multi_modexp_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cios_multi_modexp_kernel<P><<<(a.rows + a.warps - 1) / a.warps, a.warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int PMAX>
int launch_shared_exp(const SharedExpTable& tab, int blocks, cudaStream_t stream) {
  const size_t smem = modexp_smem(PMAX);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cios_shared_exp_kernel<PMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cios_shared_exp_kernel<PMAX><<<blocks, kWarps * 32, smem, stream>>>(tab);
  return (int)cudaGetLastError();
}

template <int L, int P>
int launch_comb(const void* table, const void* exp, int exp_limbs, int windows,
                const void* n, const void* n_inv, const void* one_mont, int groups,
                int per_group, int K, void* out, cudaStream_t stream) {
  constexpr int kRows = kRowsWarps * 32 / L;
  const long long blocks = (long long)groups * ((per_group + kRows - 1) / kRows);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)comb_smem_words(K, L, P) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cios_comb_kernel<L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cios_comb_kernel<L, P><<<(int)blocks, kRowsWarps * 32, smem, stream>>>(
      (const int32_t*)table, (const int32_t*)exp, exp_limbs, windows, (const int32_t*)n,
      (const int32_t*)n_inv, (const int32_t*)one_mont, groups, per_group, K,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

template <int L, int P>
int launch_mont_mul_rows(const void* x, const void* y, const void* n, const void* n_inv,
                         int rows, int K, void* out, cudaStream_t stream) {
  constexpr int kRows = kRowsWarps * 32 / L;
  cios_mont_mul_rows_kernel<L, P><<<(rows + kRows - 1) / kRows, kRowsWarps * 32, 0, stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)n, (const int32_t*)n_inv, rows, K,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

template <int L, int P>
int launch_modmul_rows(const void* a, const void* b, const void* n, const void* n_inv,
                       const void* r2, int rows, int K, void* out, cudaStream_t stream) {
  constexpr int kRows = kRowsWarps * 32 / L;
  cios_modmul_rows_kernel<L, P><<<(rows + kRows - 1) / kRows, kRowsWarps * 32, 0, stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)n, (const int32_t*)n_inv,
      (const int32_t*)r2, rows, K, (int32_t*)out);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_comb_ladder(const void* base, const void* n, const void* n_inv, const void* r2,
                       int groups, int K, int windows, void* powers, cudaStream_t stream) {
  const size_t smem = (size_t)ladder_smem_words(K / 2, NT) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cios_comb_ladder_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cios_comb_ladder_kernel<NT><<<groups, NT, smem, stream>>>(
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

// the sub-warp kernels' (L, P): P <= kRowsMaxWords at every L, and L = 32
// with P = 16 (K up to 1024)
#define FSDKR_ROWS_DISPATCH(L, P, CALL)               \
  switch ((L) * 100 + (P)) {                          \
    case 801: return CALL(8, 1);                      \
    case 802: return CALL(8, 2);                      \
    case 804: return CALL(8, 4);                      \
    case 808: return CALL(8, 8);                      \
    case 1601: return CALL(16, 1);                    \
    case 1602: return CALL(16, 2);                    \
    case 1604: return CALL(16, 4);                    \
    case 1608: return CALL(16, 8);                    \
    case 3201: return CALL(32, 1);                    \
    case 3202: return CALL(32, 2);                    \
    case 3204: return CALL(32, 4);                    \
    case 3208: return CALL(32, 8);                    \
    case 3216: return CALL(32, 16);                   \
    default: return (int)cudaErrorInvalidValue;       \
  }

// x*y*R^{-1} mod n per row. lanes: 0 for one warp a row, 8, 16 or 32 for
// the sub-warp kernel at that many lanes a row; the launch rule
// (fsdkr_cios_mont_mul) takes the sub-warp kernel from kRowsMinRows rows
extern "C" int fsdkr_cios_mont_mul_lanes(int lanes, const void* x, const void* y,
                                         const void* n, const void* n_inv, int rows, int K,
                                         void* out, void* stream) {
  if (bad_shape(rows, K) || (lanes != 0 && lanes != 8 && lanes != 16 && lanes != 32))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 0) {
#define CALL(P) launch_mont_mul<P>(x, y, n, n_inv, rows, K, out, s)
    FSDKR_CIOS_DISPATCH(K, CALL)
#undef CALL
  }
#define CALL(L, P) launch_mont_mul_rows<L, P>(x, y, n, n_inv, rows, K, out, s)
  FSDKR_ROWS_DISPATCH(lanes, rows_words_per_lane(K, lanes), CALL)
#undef CALL
}

extern "C" int fsdkr_cios_mont_mul(const void* x, const void* y, const void* n,
                                   const void* n_inv, int rows, int K, void* out,
                                   void* stream) {
  return fsdkr_cios_mont_mul_lanes(rows >= kRowsMinRows ? rows_lanes(K, kMontMulMaxWords) : 0,
                                   x, y, n, n_inv, rows, K, out, stream);
}

// a*b mod n per row at `lanes` lanes a row (8, 16 or 32); the launch rule
// (fsdkr_cios_modmul) takes fsdkr_cios_mont_mul's lanes from kRowsMinRows
// rows, 32 below
extern "C" int fsdkr_cios_modmul_lanes(int lanes, const void* a, const void* b, const void* n,
                                       const void* n_inv, const void* r2, int rows, int K,
                                       void* out, void* stream) {
  if (bad_shape(rows, K) || (lanes != 8 && lanes != 16 && lanes != 32))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(L, P) launch_modmul_rows<L, P>(a, b, n, n_inv, r2, rows, K, out, s)
  FSDKR_ROWS_DISPATCH(lanes, rows_words_per_lane(K, lanes), CALL)
#undef CALL
}

extern "C" int fsdkr_cios_modmul(const void* a, const void* b, const void* n,
                                 const void* n_inv, const void* r2, int rows, int K,
                                 void* out, void* stream) {
  return fsdkr_cios_modmul_lanes(rows >= kRowsMinRows ? rows_lanes(K, kMontMulMaxWords) : 32,
                                 a, b, n, n_inv, r2, rows, K, out, stream);
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

// bases (terms, rows, K), exps (terms, rows, exp_limbs), exp_bits[terms]
// descending multiples of 4; n, n_inv, r2, one_mont, out (rows, K)
extern "C" int fsdkr_cios_multi_modexp(const void* bases, const void* exps, int exp_limbs,
                                       const int* exp_bits, int terms, const void* n,
                                       const void* n_inv, const void* r2,
                                       const void* one_mont, int rows, int K, void* out,
                                       void* stream) {
  if (bad_shape(rows, K) || terms < 1 || terms > kMaxTerms || exp_limbs < 1)
    return (int)cudaErrorInvalidValue;
  MultiArgs a = {(const int32_t*)bases, (const int32_t*)exps, (const int32_t*)n,
                 (const int32_t*)n_inv, (const int32_t*)r2, (const int32_t*)one_mont,
                 (int32_t*)out, terms, rows, K, exp_limbs, 1, {}};
  for (int t = 0; t < terms; ++t) {
    a.exp_bits[t] = exp_bits[t];
    if (exp_bits[t] <= 0 || exp_bits[t] % 4 || (t > 0 && exp_bits[t] > exp_bits[t - 1]) ||
        (long long)exp_limbs * 16 < exp_bits[t])
      return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
#define CALL(P) launch_multi_modexp<P>(a, (cudaStream_t)stream)
  FSDKR_CIOS_DISPATCH(K, CALL)
#undef CALL
}

// segments: `count` rows of kSharedExpWords int64 words, (base, digits, n,
// n_inv, r2, one_mont, out, rows, K, windows), in any order; the longest
// chains' blocks come first
extern "C" int fsdkr_cios_shared_exp(const int64_t* segments, int count, void* stream) {
  if (count < 1 || count > kMaxSegments) return (int)cudaErrorInvalidValue;
  SharedExpTable tab = {};
  long long chain[kMaxSegments];
  int pmax = 1;
  for (int i = 0; i < count; ++i) {
    const int64_t* w = segments + (size_t)i * kSharedExpWords;
    SharedExpSegment sg = {(const int32_t*)w[0], (const int32_t*)w[1], (const int32_t*)w[2],
                           (const int32_t*)w[3], (const int32_t*)w[4], (const int32_t*)w[5],
                           (int32_t*)w[6], (int)w[7], (int)w[8], (int)w[9], 0};
    if (w[7] > 0x7FFFFFFF || w[9] > 0x7FFFFFFF || bad_shape(sg.rows, sg.K) || sg.windows < 0)
      return (int)cudaErrorInvalidValue;
    const long long c = (17 + 5LL * sg.windows) * (sg.K / 2);
    int j = i;
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
    if (tab.seg[i].rows == 0) continue;
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
    case 1: return launch_shared_exp<1>(tab, (int)blocks, s);
    case 2: return launch_shared_exp<2>(tab, (int)blocks, s);
    case 4: return launch_shared_exp<4>(tab, (int)blocks, s);
    case 8: return launch_shared_exp<8>(tab, (int)blocks, s);
    default: return launch_shared_exp<16>(tab, (int)blocks, s);
  }
}

// the comb at `lanes` lanes a row (8, 16 or 32); fsdkr_cios_comb takes
// rows_lanes(K, kCombMaxWords). The table must be 8-byte aligned (its words are copied
// 8 bytes at a time).
extern "C" int fsdkr_cios_comb_lanes(int lanes, const void* table, const void* exp,
                                     int exp_limbs, int exp_bits, const void* n,
                                     const void* n_inv, const void* one_mont, int groups,
                                     int per_group, int K, void* out, void* stream) {
  if (groups < 0 || per_group < 0 || (long long)groups * per_group > 0x7FFFFFFF ||
      bad_shape(groups * per_group, K) || exp_bits <= 0 || exp_bits % 4 ||
      exp_limbs * 16 < exp_bits || (uintptr_t)table % 8 ||
      (lanes != 8 && lanes != 16 && lanes != 32))
    return (int)cudaErrorInvalidValue;
  if (groups * per_group == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(L, P) launch_comb<L, P>(table, exp, exp_limbs, exp_bits / 4, n, n_inv, \
                                     one_mont, groups, per_group, K, out, s)
  FSDKR_ROWS_DISPATCH(lanes, rows_words_per_lane(K, lanes), CALL)
#undef CALL
}

extern "C" int fsdkr_cios_comb(const void* table, const void* exp, int exp_limbs,
                               int exp_bits, const void* n, const void* n_inv,
                               const void* one_mont, int groups, int per_group, int K,
                               void* out, void* stream) {
  return fsdkr_cios_comb_lanes(rows_lanes(K, kCombMaxWords), table, exp, exp_limbs, exp_bits,
                               n, n_inv, one_mont, groups, per_group, K, out, stream);
}

// the sub-warp kernels' launch rules at K limbs: the comb's lanes a row,
// fsdkr_cios_mont_mul's, and the rows from which it is sub-warp
extern "C" int fsdkr_cios_rows_rule(int K, int* comb_lanes, int* mont_mul_lanes,
                                    int* min_rows) {
  if (bad_shape(0, K)) return (int)cudaErrorInvalidValue;
  *comb_lanes = rows_lanes(K, kCombMaxWords);
  *mont_mul_lanes = rows_lanes(K, kMontMulMaxWords);
  *min_rows = kRowsMinRows;
  return 0;
}

// the ladder at `threads` threads a block (256 or 512);
// fsdkr_cios_comb_ladder takes ladder_threads(K)
extern "C" int fsdkr_cios_comb_ladder_threads(int threads, const void* base, const void* n,
                                              const void* n_inv, const void* r2, int groups,
                                              int K, int windows, void* powers, void* stream) {
  if (bad_shape(groups, K) || windows <= 0) return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (threads) {
    case 256: return launch_comb_ladder<256>(base, n, n_inv, r2, groups, K, windows, powers, s);
    case 512: return launch_comb_ladder<512>(base, n, n_inv, r2, groups, K, windows, powers, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fsdkr_cios_comb_ladder(const void* base, const void* n, const void* n_inv,
                                      const void* r2, int groups, int K, int windows,
                                      void* powers, void* stream) {
  return fsdkr_cios_comb_ladder_threads(ladder_threads(K), base, n, n_inv, r2, groups, K,
                                        windows, powers, stream);
}

// the ladder's launch rule at K limbs: its threads a block
extern "C" int fsdkr_cios_ladder_rule(int K, int* threads) {
  if (bad_shape(0, K)) return (int)cudaErrorInvalidValue;
  *threads = ladder_threads(K);
  return 0;
}
