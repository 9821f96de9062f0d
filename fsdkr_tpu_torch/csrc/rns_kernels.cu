// RNS Montgomery kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ops/rns_kernels.py).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   fsdkr_rns_mont_mul -> fsdkr_tpu/ops/pallas_rns.py:184 rns_mont_mul_pallas
//   fsdkr_rns_modexp   -> fsdkr_tpu/ops/pallas_rns.py:317 rns_modexp_pallas
//
// One RNS Montgomery product x*y*A^{-1} mod N per row over 2k+1 16-bit
// prime channels ordered A | B | m_r (Bajard-Plantard full-RNS Montgomery
// with a Shenoy-Kumaresan exact second extension):
//   d    = x .* y                              every channel
//   xi   = d_A .* c1                           A channels
//   q    = xi @ T1        mod (B, m_r)         first base extension
//   r    = (q .* N + d) .* A^{-1}              B and m_r channels
//   zeta = r_B .* c2_B                         B channels
//   s    = zeta @ T2      mod (A, m_r)         second base extension
//   beta = (s_r - r_r) * B^{-1} mod m_r        exact, beta < k
//   r_A  = s_A - beta * (B mod A)              A channels
// Every residue stays canonical (< its prime), so the result is an exact
// function of the inputs: these kernels, the plain PyTorch versions and
// the Pallas kernels give bit-identical residues.
//
// Design (simple and exact first): one block per row, one thread per
// channel (blockDim = 2k+1 rounded up to a warp). xi and zeta go to shared
// memory; each target-channel thread sums k products over its column of
// T1/T2, read row-major from global memory (L2-resident, coalesced across
// threads), accumulating exactly in 64 bits (each product < 2^32, each sum
// < 2^41) and reducing once per channel. beta is computed by the m_r
// thread and broadcast through shared memory.
//
// Bound on the H100: the base extensions do 2*k*(k+1) multiply-adds per
// product per row (k = 131 at the 2048-bit class, 260 at 4096). Here they
// run as 32x32->64-bit integer multiply-adds on the CUDA cores, with every
// T1/T2 entry re-read from L2 by every row (2*k*(k+1)*4 bytes per product
// per row); an int8 tensor-core design (8-bit splits, s32 accumulation,
// row tiles of 64) is the later step.
//
// The modexp kernel is the product inside the 4-bit fixed-window loop:
// Montgomery entry through A^2 mod N, a 16-entry window table per row in
// shared memory, exp_bits/4 windows of 4 squarings + one multiply, exit by
// multiplying with 1. Exponents may be secret (shares, nonces, d): the
// window entry is a masked sum over all 16 table entries (never
// table[w]), there is no early exit, and the loop length is the bucketed
// width the caller passes, never a row's own bit length. Bases may be
// secret too (Paillier randomness), so each block zeroes its shared memory
// before it exits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct RnsConsts {
  const int32_t* m_all;    // (2k+1) channel primes A | B | m_r
  const int32_t* T1;       // (k, k+1) |A/a_i| mod (B, m_r)
  const int32_t* T2;       // (k, k+1) |B/b_j| mod (A, m_r)
  const int32_t* ainv_b;   // (k+1) A^{-1} mod (B, m_r)
  const int32_t* c2_b;     // (k) |(B/b_j)^{-1}| mod b_j
  const int32_t* b_mod_a;  // (k) B mod a_i
  uint32_t binv_r;         // B^{-1} mod m_r
  int k;
};

// per-thread channel constants, loaded once per row
struct Lane {
  uint32_t m;     // this channel's prime
  uint32_t c1;    // c < k: c1[row, c] (folds -N^{-1} and (A/a_i)^{-1})
  uint32_t nb;    // c >= k: N mod (B, m_r)
  uint32_t ainv;  // c >= k: A^{-1} mod (B, m_r)
  uint32_t c2;    // k <= c < 2k: c2_B
  uint32_t bma;   // c < k: B mod a_c
  int t2col;      // target column of the second extension, -1 if none
};

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint32_t m) {
  return (a * b) % m;  // a, b < 2^16: the product fits 32 bits
}

__device__ __forceinline__ Lane load_lane(const RnsConsts& K, const int32_t* c1,
                                          const int32_t* nbmr, int row, int c) {
  const int k = K.k, C = 2 * k + 1;
  Lane L;
  L.m = c < C ? (uint32_t)K.m_all[c] : 1u;
  L.c1 = c < k ? (uint32_t)c1[(size_t)row * k + c] : 0u;
  const bool bmr = c >= k && c < C;
  L.nb = bmr ? (uint32_t)nbmr[(size_t)row * (k + 1) + (c - k)] : 0u;
  L.ainv = bmr ? (uint32_t)K.ainv_b[c - k] : 0u;
  L.c2 = (c >= k && c < 2 * k) ? (uint32_t)K.c2_b[c - k] : 0u;
  L.bma = c < k ? (uint32_t)K.b_mod_a[c] : 0u;
  L.t2col = c < k ? c : (c == 2 * k ? k : -1);
  return L;
}

// One RNS Montgomery product for this thread's channel c. Every thread of
// the block calls it the same number of times (three barriers inside).
__device__ uint32_t mont_mul(uint32_t x, uint32_t y, int c, const Lane& L,
                             const RnsConsts& K, uint32_t* xi_s,
                             uint32_t* zeta_s, uint32_t* beta_s) {
  const int k = K.k, C = 2 * k + 1, kp = k + 1;
  const uint32_t d = c < C ? mulmod(x, y, L.m) : 0u;
  if (c < k) xi_s[c] = mulmod(d, L.c1, L.m);
  __syncthreads();

  uint32_t r = 0;  // r in B | m_r (the m_r thread keeps r_r in a register)
  if (c >= k && c < C) {
    const int32_t* col = K.T1 + (c - k);
    uint64_t acc = 0;
#pragma unroll 4
    for (int i = 0; i < k; ++i) acc += (uint64_t)xi_s[i] * (uint32_t)col[i * kp];
    const uint32_t q = (uint32_t)(acc % L.m);
    uint32_t t = mulmod(q, L.nb, L.m) + d;
    if (t >= L.m) t -= L.m;
    r = mulmod(t, L.ainv, L.m);
    if (c < 2 * k) zeta_s[c - k] = mulmod(r, L.c2, L.m);
  }
  __syncthreads();

  uint32_t s = 0;  // s in A | m_r
  if (L.t2col >= 0) {
    const int32_t* col = K.T2 + L.t2col;
    uint64_t acc = 0;
#pragma unroll 4
    for (int j = 0; j < k; ++j) acc += (uint64_t)zeta_s[j] * (uint32_t)col[j * kp];
    s = (uint32_t)(acc % L.m);
    if (c == 2 * k) {
      const uint32_t diff = s >= r ? s - r : s + L.m - r;
      beta_s[0] = mulmod(diff, K.binv_r, L.m);  // exact: beta < k < m_r
    }
  }
  __syncthreads();

  if (c < k) {
    const uint32_t corr = mulmod(beta_s[0], L.bma, L.m);
    r = s >= corr ? s - corr : s + L.m - corr;
  }
  return r;
}

__global__ void rns_mont_mul_kernel(const int32_t* __restrict__ x,
                                    const int32_t* __restrict__ y,
                                    const int32_t* __restrict__ c1,
                                    const int32_t* __restrict__ nbmr,
                                    RnsConsts K, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int k = K.k, C = 2 * k + 1;
  uint32_t* xi_s = smem;
  uint32_t* zeta_s = smem + k;
  uint32_t* beta_s = smem + 2 * k;
  const int row = blockIdx.x, c = threadIdx.x;
  const size_t base = (size_t)row * C + c;
  const Lane L = load_lane(K, c1, nbmr, row, c);
  const uint32_t xv = c < C ? (uint32_t)x[base] : 0u;
  const uint32_t yv = c < C ? (uint32_t)y[base] : 0u;
  const uint32_t r = mont_mul(xv, yv, c, L, K, xi_s, zeta_s, beta_s);
  if (c < C) out[base] = (int32_t)r;
}

__global__ void rns_modexp_kernel(const int32_t* __restrict__ base_res,
                                  const int32_t* __restrict__ exp,
                                  int exp_limbs, int exp_bits,
                                  const int32_t* __restrict__ a2n_res,
                                  const int32_t* __restrict__ c1,
                                  const int32_t* __restrict__ nbmr,
                                  RnsConsts K, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int k = K.k, C = 2 * k + 1;
  uint32_t* xi_s = smem;
  uint32_t* zeta_s = smem + k;
  uint32_t* beta_s = smem + 2 * k;
  uint32_t* table = smem + 2 * k + 2;  // (16, C): this thread owns column c
  const int row = blockIdx.x, c = threadIdx.x;
  const size_t at = (size_t)row * C + c;
  const Lane L = load_lane(K, c1, nbmr, row, c);
  const uint32_t b = c < C ? (uint32_t)base_res[at] : 0u;
  const uint32_t a2n = c < C ? (uint32_t)a2n_res[at] : 0u;

  // into the A-Montgomery domain: x*A = MontMul(x, A^2 mod N)
  const uint32_t base_m = mont_mul(b, a2n, c, L, K, xi_s, zeta_s, beta_s);
  const uint32_t one_m = mont_mul(1u, a2n, c, L, K, xi_s, zeta_s, beta_s);
  if (c < C) {
    table[c] = one_m;
    table[C + c] = base_m;
  }
  uint32_t prev = base_m;
  for (int j = 2; j < 16; ++j) {
    prev = mont_mul(prev, base_m, c, L, K, xi_s, zeta_s, beta_s);
    if (c < C) table[j * C + c] = prev;
  }

  const int32_t* e = exp + (size_t)row * exp_limbs;
  uint32_t acc = one_m;
  for (int wi = 0; wi < exp_bits / 4; ++wi) {
    const int shift = exp_bits - 4 * (wi + 1);
    const uint32_t w = ((uint32_t)e[shift >> 4] >> (shift & 15)) & 15u;
    for (int s = 0; s < 4; ++s) acc = mont_mul(acc, acc, c, L, K, xi_s, zeta_s, beta_s);
    // constant-time select: a masked sum over all 16 entries
    uint32_t sel = 0;
    if (c < C) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t mask = 0u - (uint32_t)(w == (uint32_t)j);
        sel += table[j * C + c] & mask;
      }
    }
    acc = mont_mul(acc, sel, c, L, K, xi_s, zeta_s, beta_s);
  }
  // leave the Montgomery domain
  const uint32_t r = mont_mul(acc, 1u, c, L, K, xi_s, zeta_s, beta_s);
  if (c < C) out[at] = (int32_t)r;
  // the table holds powers of a possibly secret base: zero all shared
  // memory before the block exits (beta_s is read after mont_mul's last
  // barrier, hence one more)
  __syncthreads();
  if (c < 2 * k + 2) smem[c] = 0u;
  if (c < C) {
#pragma unroll
    for (int j = 0; j < 16; ++j) table[j * C + c] = 0u;
  }
}

RnsConsts make_consts(const void* m_all, const void* T1, const void* T2,
                      const void* ainv_b, const void* c2_b, const void* b_mod_a,
                      unsigned binv_r, int k) {
  RnsConsts K;
  K.m_all = (const int32_t*)m_all;
  K.T1 = (const int32_t*)T1;
  K.T2 = (const int32_t*)T2;
  K.ainv_b = (const int32_t*)ainv_b;
  K.c2_b = (const int32_t*)c2_b;
  K.b_mod_a = (const int32_t*)b_mod_a;
  K.binv_r = binv_r;
  K.k = k;
  return K;
}

int block_threads(int k) { return ((2 * k + 1) + 31) / 32 * 32; }

}  // namespace

extern "C" int fsdkr_rns_mont_mul(const void* x, const void* y, const void* c1,
                                  const void* nbmr, const void* m_all,
                                  const void* T1, const void* T2,
                                  const void* ainv_b, const void* c2_b,
                                  const void* b_mod_a, unsigned binv_r, int k,
                                  int rows, void* out, void* stream) {
  if (rows <= 0) return 0;
  const RnsConsts K = make_consts(m_all, T1, T2, ainv_b, c2_b, b_mod_a, binv_r, k);
  const size_t smem = (size_t)(2 * k + 1) * sizeof(uint32_t);
  rns_mont_mul_kernel<<<rows, block_threads(k), smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)c1,
      (const int32_t*)nbmr, K, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int fsdkr_rns_modexp(const void* base_res, const void* exp,
                                int exp_limbs, int exp_bits,
                                const void* a2n_res, const void* c1,
                                const void* nbmr, const void* m_all,
                                const void* T1, const void* T2,
                                const void* ainv_b, const void* c2_b,
                                const void* b_mod_a, unsigned binv_r, int k,
                                int rows, void* out, void* stream) {
  if (rows <= 0) return 0;
  const RnsConsts K = make_consts(m_all, T1, T2, ainv_b, c2_b, b_mod_a, binv_r, k);
  const size_t smem = (size_t)(2 * k + 2 + 16 * (2 * k + 1)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rns_modexp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rns_modexp_kernel<<<rows, block_threads(k), smem, (cudaStream_t)stream>>>(
      (const int32_t*)base_res, (const int32_t*)exp, exp_limbs, exp_bits,
      (const int32_t*)a2n_res, (const int32_t*)c1, (const int32_t*)nbmr, K,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
