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
// every operation: the product is word-level CIOS with n' = -p^{-1} mod
// 2^32 and one conditional subtraction; the sum and the difference end in
// one conditional subtraction or addition of p. A canonical result is
// unique, so every value equals the plain version's and the JAX
// package's bit for bit. Points are homogeneous projective (X : Y : Z),
// the identity (0 : R mod p : 0), added by the complete formula of
// Renes-Costello-Batina 2016, Alg. 7 (a = 0, b3 = 21), in the statement
// order of the JAX package's `_padd` (:100-125): one formula for
// additions, doublings, the identity and inverses, with no branch on the
// data. Every select is a mask.
//
// ec_scalar_mul_kernel: k*P per row, one thread a row. The 16-entry
// table of multiples (table[0] the identity, table[j] = table[j-1] + P),
// then per 4-bit window, MSB first, 4 doublings acc + acc and one add of
// the window's entry. The entry is read as a masked OR over all 16
// entries, never indexed by the digit (the scalars are key shares,
// coefficients and nonces). The table (16 x 24 words, 1.5 KB a row)
// lies in shared memory, 48 KB for a block of 32 threads, word-major
// across the block's threads (no bank conflict), and is zeroed before
// the thread exits. (A table in local memory measured 1-16% slower on
// the H100 as the only layout, by how ptxas allocated it: PERF.md.)
// ptxas spills about 870 bytes of the loop's state (window digits, the
// accumulator, the selected entry) to local memory; those spilled
// copies are not wiped and stay in device memory until it is reused.
//
// ec_tree_sum_kernel: one block a group. Level by level, row i of the
// first half plus row i of the second (the JAX package's lhs = flat[:,
// :m], rhs = flat[:, m:]), the pairs spread over the block's threads, a
// barrier between levels. The levels' sums lie in a global scratch
// buffer the wrapper allocates (group g's word k of row i at k * M/2 + i,
// so neighbouring threads read neighbouring words), so M is not capped by
// the block. Each level writes row i in place: only its own thread reads
// row i, and no row of the second half is written.
//
// What bounds it: integer multiply-adds. A complete addition is 14 field
// products of 8 x 8 32-bit multiply-adds twice (the product and the
// reduction); a 256-bit scalar-mul row is 14 + 5 * 64 = 334 additions.
// One thread a row makes each row's chain of about 4,700 dependent
// products the kernel's time: latency, not the card's multiply rate, sets
// it at the main path's 256-1024 rows. Blocks of one warp spread those
// rows over as many SMs as they fill. Several threads a row, a fixed-base
// comb for G and the special form of p are a later design's.

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
constexpr int kMulThreads = 32;            // the scalar mul's block
constexpr int kTreeThreads = 256;           // the tree's largest block
constexpr uint32_t kNPrime = 0xD2253531u;   // -p^{-1} mod 2^32

// p, R mod p (1 in the Montgomery domain) and 21 R mod p (b3 = 3b)
__device__ __forceinline__ constexpr uint32_t p_word(int j) {
  return j == 0 ? 0xFFFFFC2Fu : (j == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
}
__device__ __forceinline__ constexpr uint32_t one_m_word(int j) {
  return j == 0 ? 0x000003D1u : (j == 1 ? 0x00000001u : 0u);
}
__device__ __forceinline__ constexpr uint32_t b3_m_word(int j) {
  return j == 0 ? 0x00005025u : (j == 1 ? 0x00000015u : 0u);
}

struct Pt {
  uint32_t x[kWords], y[kWords], z[kWords];
};

__device__ __forceinline__ uint32_t& coord(Pt& p, int k) {
  return k < kWords ? p.x[k] : (k < 2 * kWords ? p.y[k - kWords] : p.z[k - 2 * kWords]);
}

// r = t - p where t >= p, else t; t: 9 words, t < 2p (its ninth word 0 or 1).
__device__ __forceinline__ void reduce_once(uint32_t r[kWords], const uint32_t t[kWords + 1]) {
  uint32_t d[kWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)t[j] - p_word(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // t < p exactly where the eight words borrowed and the ninth is 0
  const uint32_t keep = 0u - (borrow & (t[kWords] ^ 1u));
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

// r = x * y * R^{-1} mod p (CIOS, one 32-bit word a step); x, y < p. r may
// alias x or y: it is written after the last read of both.
__device__ __forceinline__ void fmul(uint32_t r[kWords], const uint32_t x[kWords],
                                     const uint32_t y[kWords]) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint64_t s = (uint64_t)x[j] * y[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)s;
    t[kWords + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kNPrime;
    s = (uint64_t)m * p_word(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      s = (uint64_t)m * p_word(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kWords] + c;
    t[kWords - 1] = (uint32_t)s;
    t[kWords] = t[kWords + 1] + (uint32_t)(s >> 32);
  }
  reduce_once(r, t);  // t < 2p
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
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)x[j] - y[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)d[j] + (p_word(j) & mask) + c;
    r[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

// out = p + q, the complete formula in the JAX package's statement order.
// out may alias p or q.
__device__ __forceinline__ void padd(Pt& out, const Pt& p, const Pt& q) {
  uint32_t t0[kWords], t1[kWords], t2[kWords], t3[kWords], t4[kWords];
  uint32_t x3[kWords], y3[kWords], z3[kWords], a[kWords], b[kWords], b3[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) b3[j] = b3_m_word(j);
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
  fadd(a, t0, t0);
  fadd(x3, a, t0);
  fmul(t2, b3, t2);
  fadd(z3, t1, t2);
  fsub(t1, t1, t2);
  fmul(y3, b3, y3);
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

__device__ __forceinline__ void set_identity(Pt& p) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    p.x[j] = 0;
    p.y[j] = one_m_word(j);
    p.z[j] = 0;
  }
}

// a point from its 48 16-bit limbs (X, Y, Z), and back
__device__ __forceinline__ void load_limbs(Pt& p, const int32_t* limbs) {
#pragma unroll
  for (int k = 0; k < kPointWords; ++k)
    coord(p, k) = (uint32_t)limbs[2 * k] | ((uint32_t)limbs[2 * k + 1] << 16);
}

__device__ __forceinline__ void store_limbs(int32_t* limbs, Pt& p) {
#pragma unroll
  for (int k = 0; k < kPointWords; ++k) {
    const uint32_t w = coord(p, k);
    limbs[2 * k] = (int32_t)(w & 0xFFFFu);
    limbs[2 * k + 1] = (int32_t)(w >> 16);
  }
}

// the window table of one thread: entry e's word k at (e * 24 + k) *
// kMulThreads + thread of the block's shared array
struct Table {
  uint32_t* w;

  __device__ __forceinline__ uint32_t& at(int e, int k) {
    return w[(e * kPointWords + k) * kMulThreads + threadIdx.x];
  }

  __device__ __forceinline__ void put(int e, Pt& p) {
#pragma unroll
    for (int k = 0; k < kPointWords; ++k) at(e, k) = coord(p, k);
  }

  // every entry zeroed (volatile: the stores outlive no read, and must
  // not be dropped)
  __device__ __forceinline__ void wipe() {
#pragma unroll 1
    for (int e = 0; e < kEntries; ++e) {
#pragma unroll
      for (int k = 0; k < kPointWords; ++k) *(volatile uint32_t*)&at(e, k) = 0u;
    }
  }
};

__global__ void __launch_bounds__(kMulThreads)
ec_scalar_mul_kernel(const int32_t* __restrict__ points, const int32_t* __restrict__ scalars,
                     int rows, int scalar_limbs, int scalar_bits, int32_t* __restrict__ out) {
  const int row = blockIdx.x * kMulThreads + threadIdx.x;
  if (row >= rows) return;  // no barrier below

  __shared__ uint32_t tables[kEntries * kPointWords * kMulThreads];
  Table table{tables};
  Pt base, cur;
  load_limbs(base, points + (size_t)row * kPointLimbs);
  set_identity(cur);
  table.put(0, cur);
  table.put(1, base);
#pragma unroll
  for (int k = 0; k < kPointWords; ++k) coord(cur, k) = coord(base, k);
#pragma unroll 1
  for (int e = 2; e < kEntries; ++e) {
    padd(cur, cur, base);
    table.put(e, cur);
  }

  const int32_t* sc = scalars + (size_t)row * scalar_limbs;
  Pt acc, sel;
  set_identity(acc);
#pragma unroll 1
  for (int shift = scalar_bits - kWindowBits; shift >= 0; shift -= kWindowBits) {
    const uint32_t digit = ((uint32_t)sc[shift >> 4] >> (shift & 15)) & (kEntries - 1);
#pragma unroll 1
    for (int d = 0; d < kWindowBits; ++d) padd(acc, acc, acc);
#pragma unroll
    for (int k = 0; k < kPointWords; ++k) coord(sel, k) = 0u;
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      const uint32_t mask = 0u - (uint32_t)(digit == (uint32_t)e);
#pragma unroll
      for (int k = 0; k < kPointWords; ++k) coord(sel, k) |= table.at(e, k) & mask;
    }
    padd(acc, acc, sel);
  }
  store_limbs(out + (size_t)row * kPointLimbs, acc);
  table.wipe();
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
  Pt a, b;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    load_limbs(a, in + (size_t)i * kPointLimbs);
    load_limbs(b, in + (size_t)(i + half) * kPointLimbs);
    padd(a, a, b);
#pragma unroll
    for (int k = 0; k < kPointWords; ++k) buf[(size_t)k * half + i] = coord(a, k);
  }
  for (int h = half >> 1; h >= 1; h >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
#pragma unroll
      for (int k = 0; k < kPointWords; ++k) {
        coord(a, k) = buf[(size_t)k * half + i];
        coord(b, k) = buf[(size_t)k * half + i + h];
      }
      padd(a, a, b);
#pragma unroll
      for (int k = 0; k < kPointWords; ++k) buf[(size_t)k * half + i] = coord(a, k);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kPointWords; ++k) coord(a, k) = buf[(size_t)k * half];
    store_limbs(dst, a);
  }
}

}  // namespace

// rows x (P, k) -> k*P, one thread a row. Returns a CUDA error code.
extern "C" int fsdkr_ec_scalar_mul(const int32_t* points, const int32_t* scalars, int rows,
                                   int scalar_limbs, int scalar_bits, int32_t* out,
                                   void* stream) {
  if (rows <= 0 || scalar_bits <= 0 || scalar_bits % kWindowBits ||
      scalar_limbs * 16 < scalar_bits)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kMulThreads - 1) / kMulThreads;
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
