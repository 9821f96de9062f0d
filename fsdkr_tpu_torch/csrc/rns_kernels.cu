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
// One implementation of the product, `mont_mul<RT, W>`, serves both
// kernels. A block holds a tile of RT rows (8; 4 where kernel 2's window
// table would not fit in shared memory: k=454) and W warps:
// - Base extensions on the tensor cores: out^T (k+1 x R_T) = T^T (k+1 x k)
//   * xi^T (k x R_T) with channels on M (m16) and rows on N (n8), as four
//   exact u8 products mma.sync.m16n8k32.u8.u8.s32 of the byte planes
//   (T_lo/T_hi x xi_lo/xi_hi). T1/T2's planes come from the host in the
//   A-operand fragment order (ops/rns_kernels.py::fragment_planes): lane
//   L of M tile mt, K tile kt loads its 16 bytes with one 16-byte load at
//   ((mt*KT + kt)*32 + L)*16. xi and zeta sit in shared memory as byte
//   planes [8 rows][Kp + 16] (the 16-byte pad spreads the B-fragment loads
//   over all 32 banks). Each warp owns M tiles (mt = warp, warp+W, ...)
//   with its four plane products as independent accumulator chains, and
//   finishes its tile's channels itself (the epilogue) from registers.
// - Elementwise steps: a thread owns a channel across all R_T rows, so the
//   channel's constants load once and the rows are R_T independent chains.
// - No %: every channel prime is 2^16 - u with u = 2^16 mod m small, so a
//   reduction folds v -> (v >> 16) * u + (v & 0xFFFF) and ends with one
//   conditional subtraction. The number of folds of each reduction site is
//   computed per width class on the host from the real bounds
//   (ops/rns_kernels.py::fold_counts) and passed in.
// Every step of a product is a dependent latency chain (load, multiply,
// folds) over a tile of 8 rows: a product takes microseconds per tile
// whatever the number of tiles, so what sets a launch's time is how many
// tiles wait behind one another, not the card's rates.
//
// Kernel 1 (the product) is one product per tile: load the rows' x and y
// into u16 tiles, multiply, store. Its bound on the H100 is bytes (each
// row's x, y, c1, N mod B and result once): 5.2 us at k=131 and 4096
// rows, 0.36 us at 256 rows, where a launch's own latency is the floor.
// So the work is spread to finish in one wave of blocks: the launcher
// picks W from the number of tiles (mont_mul_warps) - 16 warps while one
// block per SM holds every tile (the most warps per product), else 4
// (4096 rows: 512 tiles, four 4-warp blocks per SM on 132 SMs).
//
// Kernel 2 (the modexp) is the product inside the 4-bit fixed-window loop,
// 16 warps per block (the loop's chain is long and one block per SM holds
// it): Montgomery entry through A^2 mod N, a 16-entry window table per row
// in shared memory, exp_bits/4 windows of 4 squarings + one multiply, exit
// by multiplying with 1. Its table and accumulator stay in shared memory
// for the whole loop, so device memory sees each row's inputs and result
// once; the products' latency chains bound it, far above its bound in
// operations.
//
// Exponents may be secret (shares, nonces, d): the window entry is a
// masked sum over all 16 table entries (never table[w]), there is no early
// exit, and the loop length is the bucketed width the caller passes, never
// a row's own bit length. Bases and factors may be secret too (Paillier
// randomness), so each block of either kernel zeroes all its shared memory
// before it exits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 8;                // the MMA's n: plane rows (>= R_T)
constexpr size_t kSmemLimit = 232448;

// A kernel's dynamic shared memory ceiling is an attribute of the
// function, shared by every host thread that launches it. Set to each
// launch's own size, another thread could lower it between this thread's
// set and its launch (cudaErrorInvalidValue at the launch): every launch
// sets the same ceiling, the opt-in maximum.
template <typename F>
cudaError_t allow_opt_in_smem(F kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemLimit);
}
constexpr int kModexpWarps = 16;
constexpr int kModexpArrays = 17;    // the window table and the accumulator
constexpr int kMontMulArrays = 2;    // x (then the result) and y

struct ProductConsts {
  const int32_t* m_all;    // (2k+1) channel primes A | B | m_r
  const int32_t* u_all;    // (2k+1) 2^16 mod m (the fold constant)
  const uint4* T1lo;       // T1^T low / high bytes in A-fragment order:
  const uint4* T1hi;       //   (Mp/16, Kp/32, 32 lanes) x 16 bytes
  const uint4* T2lo;
  const uint4* T2hi;
  const int32_t* ainv_b;   // (k+1) A^{-1} mod (B, m_r)
  const int32_t* c2_b;     // (k) |(B/b_j)^{-1}| mod b_j
  const int32_t* b_mod_a;  // (k) B mod a_i
  uint32_t binv_r;         // B^{-1} mod m_r
  int k;
  int f_mul, f_mid, f_hh, f_ext;  // folds per reduction site (fold_counts)
};

// the shared-memory layout of one block; the host mirror is
// ops/rns_kernels.py::tile_smem_bytes
struct Layout {
  int k, C, rt, arrays, KT, MT, SP;
  __host__ __device__ Layout(int k_, int rt_, int arrays_)
      : k(k_), C(2 * k_ + 1), rt(rt_), arrays(arrays_), KT((k_ + 31) / 32),
        MT((k_ + 1 + 15) / 16), SP(KT * 32 + 16) {}
  // four byte planes (xi lo/hi, zeta lo/hi) of kN x SP, beta and the
  // rows' windows (kN u32 each), then u16 arrays: `arrays` tiles (rt, C)
  // and d in B | m_r (rt, k+1)
  __host__ __device__ size_t plane_bytes() const { return (size_t)kN * SP; }
  __host__ __device__ size_t u16_offset() const { return 4 * plane_bytes() + 2 * kN * 4; }
  __host__ __device__ size_t bytes() const {
    return u16_offset() + 2 * ((size_t)arrays * rt * C + (size_t)rt * (k + 1));
  }
};

// (v >> 16) * u + (v & 0xFFFF) == v (mod m), as 2^16 == u; written as
// v - (v >> 16) * m, one shift and one multiply-add (u - 2^16 wraps to -m;
// the result is the same non-negative value)
__device__ __forceinline__ uint32_t fold(uint32_t v, uint32_t u) {
  return v + (v >> 16) * (u - 0x10000u);
}

__device__ __forceinline__ uint32_t csub(uint32_t v, uint32_t m) {
  return v >= m ? v - m : v;
}

// The elementwise steps work on N independent values at once (the rows of
// one channel, or a lane's four extension sums), so every fold step is N
// independent chains and the count n is a loop bound paid once.
template <int N>
__device__ __forceinline__ void fold_all(uint32_t (&v)[N], const uint32_t (&u)[N],
                                         int n) {
  for (int f = 0; f < n; ++f) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = fold(v[i], u[i]);
  }
}

// v = v * b mod m elementwise, for residues v, b < m: v*b <= (m-1)^2 <
// 2^32; f_mul folds bring every channel's bound below 2m, so one
// conditional subtraction finishes
template <int N>
__device__ __forceinline__ void mul_mod(uint32_t (&v)[N], const uint32_t (&b)[N],
                                        const uint32_t (&m)[N],
                                        const uint32_t (&u)[N], int f_mul) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] *= b[i];
  fold_all(v, u, f_mul);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = csub(v[i], m[i]);
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

enum YMode { Y_TILE, Y_ONE, Y_SELECT };

// a block's view of its tile: shared-memory arrays and the rows' inputs
struct Tile {
  Layout L;
  const int32_t* c1;    // (rows, k)
  const int32_t* nbmr;  // (rows, k+1)
  int row0, rows;
  uint8_t *xi_lo, *xi_hi, *ze_lo, *ze_hi;
  uint32_t *beta, *win;
  uint16_t *arr, *dB;

  __device__ Tile(uint8_t* smem, int k, int rt, int arrays, const int32_t* c1_,
                  const int32_t* nbmr_, int rows_)
      : L(k, rt, arrays), c1(c1_), nbmr(nbmr_), row0(blockIdx.x * rt), rows(rows_) {
    const size_t pb = L.plane_bytes();
    xi_lo = smem;
    xi_hi = smem + pb;
    ze_lo = smem + 2 * pb;
    ze_hi = smem + 3 * pb;
    beta = (uint32_t*)(smem + 4 * pb);
    win = beta + kN;
    arr = (uint16_t*)(smem + L.u16_offset());
    dB = arr + (size_t)arrays * rt * L.C;
  }
  // u16 tile j (rt, C)
  __device__ uint16_t* entry(int j) const { return arr + (size_t)j * L.rt * L.C; }
};

// padding (plane columns k..SP, plane rows RT..8, rows past `rows`) must
// read as zero, and nothing may stay behind when the block exits
template <int W>
__device__ __forceinline__ void zero_smem(uint8_t* smem, const Layout& L) {
  uint32_t* words = (uint32_t*)smem;
  const int nwords = (int)(L.bytes() / 4);
  for (int i = threadIdx.x; i < nwords; i += W * 32) words[i] = 0u;
}

// The s32 sums of M tile mt over all K tiles: p[product][c_i], products
// T_lo x_lo, T_lo x_hi, T_hi x_lo, T_hi x_hi (four independent chains).
//
// Fragments (PTX ISA, mma.m16n8k32 with 8-bit operands), with g = lane >> 2,
// t = lane & 3: A (16 x 32, here T^T) register a_i holds row g + 8*(i&1),
// columns 16*(i>>1) + 4t .. +3; B (32 x 8, here src^T) b_0 holds src row
// g, columns 4t .. +3, b_1 columns 16 + 4t .. +3; the s32 sums c_i sit at
// (row g + 8*(i>>1), column 2t + (i&1)).
__device__ __forceinline__ void mma_tile(const Layout& L, const uint4* __restrict__ Tlo,
                                         const uint4* __restrict__ Thi,
                                         const uint8_t* bl, const uint8_t* bh, int mt,
                                         int (&p)[4][4]) {
  const int lane = threadIdx.x & 31;
  const uint4* al = Tlo + (size_t)mt * L.KT * 32 + lane;
  const uint4* ah = Thi + (size_t)mt * L.KT * 32 + lane;
#pragma unroll 4
  for (int kt = 0; kt < L.KT; ++kt) {
    const uint4 a_lo = __ldg(al + kt * 32);
    const uint4 a_hi = __ldg(ah + kt * 32);
    const uint32_t l0 = *(const uint32_t*)(bl + kt * 32);
    const uint32_t l1 = *(const uint32_t*)(bl + kt * 32 + 16);
    const uint32_t h0 = *(const uint32_t*)(bh + kt * 32);
    const uint32_t h1 = *(const uint32_t*)(bh + kt * 32 + 16);
    mma_u8(p[0], a_lo, l0, l1);
    mma_u8(p[1], a_lo, h0, h1);
    mma_u8(p[2], a_hi, l0, l1);
    mma_u8(p[3], a_hi, h0, h1);
  }
}

// Finish M tile mt of an extension from its sums. FIRST: q = xi @ T1 in
// B | m_r, then r = (q * N + d) * A^{-1} into o and zeta = r_B * c2 as
// byte planes. Second: s = zeta @ T2 in A | m_r, s_A into o and, from s_r,
// the exact Shenoy beta = (s_r - r_r) * B^{-1} mod m_r per row. Target
// j < k+1 is channel chan0 + j (chan0 = k, then 0); the last, m_r, is
// channel 2k.
template <int RT, bool FIRST>
__device__ __forceinline__ void finish_tile(const Tile& T, const ProductConsts& K,
                                            uint16_t* o, int mt, const int (&p)[4][4]) {
  const int k = T.L.k, C = T.L.C, SP = T.L.SP, chan0 = FIRST ? k : 0;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // this lane's four sums: target j[i], row n[i]
  int j[4], n[4];
  bool ok[4];
  uint32_t m[4], u[4], a[4], h[4], b[4], nb[4], ainv[4], c2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    j[i] = mt * 16 + g + 8 * (i >> 1);
    n[i] = 2 * t + (i & 1);
    ok[i] = j[i] <= k && n[i] < RT;
    const int ch = j[i] < k ? chan0 + j[i] : 2 * k;  // padding reads m_r
    m[i] = (uint32_t)__ldg(K.m_all + ch);
    u[i] = (uint32_t)__ldg(K.u_all + ch);
    if constexpr (FIRST) {
      const int row = T.row0 + n[i];
      nb[i] = ok[i] && row < T.rows
                  ? (uint32_t)__ldg(T.nbmr + (size_t)row * (k + 1) + j[i]) : 0u;
      ainv[i] = ok[i] ? (uint32_t)__ldg(K.ainv_b + j[i]) : 0u;
      c2[i] = ok[i] && j[i] < k ? (uint32_t)__ldg(K.c2_b + j[i]) : 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // each plane sum is at most P = k*255^2 < 2^28 (k <= 2065); the sum
    // is P_ll + 2^8 (P_lh + P_hl) + 2^16 P_hh, with 2^16 == u (mod m)
    a[i] = (uint32_t)p[1][i] + (uint32_t)p[2][i];  // <= 2P
    h[i] = (uint32_t)p[3][i];
  }
  fold_all(a, u, K.f_mid);  // now 2^8 * a + P < 2^32
  fold_all(h, u, K.f_hh);   // now fold(P_ll + 2^8 a) + u * h < 2^32
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = fold((uint32_t)p[0][i] + (a[i] << 8), u[i]) + u[i] * h[i];
  fold_all(a, u, K.f_ext);  // now below 2m
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = csub(a[i], m[i]);

  if constexpr (FIRST) {  // a = q
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = ok[i] ? T.dB[n[i] * (k + 1) + j[i]] : 0u;
    mul_mod(a, nb, m, u, K.f_mul);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = csub(a[i] + b[i], m[i]);
    mul_mod(a, ainv, m, u, K.f_mul);  // a = r
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ok[i]) o[n[i] * C + k + j[i]] = (uint16_t)a[i];
    mul_mod(a, c2, m, u, K.f_mul);  // a = zeta
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ok[i] && j[i] < k) {
        T.ze_lo[n[i] * SP + j[i]] = (uint8_t)a[i];
        T.ze_hi[n[i] * SP + j[i]] = (uint8_t)(a[i] >> 8);
      }
    }
  } else {  // a = s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ok[i] && j[i] < k) o[n[i] * C + j[i]] = (uint16_t)a[i];
      if (ok[i] && j[i] == k) {  // m_r: r_r came from the first extension
        const uint32_t rr = o[n[i] * C + 2 * k];
        uint32_t d[1] = {a[i] >= rr ? a[i] - rr : a[i] + m[i] - rr};
        const uint32_t bi[1] = {K.binv_r}, mi[1] = {m[i]}, ui[1] = {u[i]};
        mul_mod(d, bi, mi, ui, K.f_mul);
        T.beta[n[i]] = d[0];
      }
    }
  }
}

// One base extension of the tile (see finish_tile). Warp w owns M tiles
// w, w + W, ... and finishes their channels itself.
template <int RT, bool FIRST, int W>
__device__ __forceinline__ void extend(const Tile& T, const ProductConsts& K,
                                       uint16_t* o) {
  const Layout& L = T.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint4* __restrict__ Tlo = FIRST ? K.T1lo : K.T2lo;
  const uint4* __restrict__ Thi = FIRST ? K.T1hi : K.T2hi;
  const uint8_t* bl = (FIRST ? T.xi_lo : T.ze_lo) + g * L.SP + 4 * t;
  const uint8_t* bh = (FIRST ? T.xi_hi : T.ze_hi) + g * L.SP + 4 * t;
  for (int mt = warp; mt < L.MT; mt += W) {
    int p[4][4] = {};
    mma_tile(L, Tlo, Thi, bl, bh, mt, p);
    finish_tile<RT, FIRST>(T, K, o, mt, p);
  }
}

// o = x * y * A^{-1} mod N for every row of the tile, over (RT, C) u16
// tiles, by a block of W warps; o may be x or y. In the elementwise steps
// a thread owns channels (c = thread, thread + 32 W, ...) across all RT
// rows: the channel's constants load once, and the rows are independent
// chains. Four barriers; every thread calls it alike.
template <int RT, int W>
__device__ __forceinline__ void mont_mul(const Tile& T, const ProductConsts& K,
                                         const uint16_t* x, const uint16_t* y,
                                         YMode mode, uint16_t* o) {
  const int k = T.L.k, C = T.L.C, SP = T.L.SP;
  // d = x * y; xi = d_A * c1 as byte planes; d_B|m_r kept for the epilogue
  for (int c = threadIdx.x; c < C; c += W * 32) {
    uint32_t m[RT], u[RT], v[RT], w[RT], cv[RT];
    const uint32_t mc = (uint32_t)__ldg(K.m_all + c);
    const uint32_t uc = (uint32_t)__ldg(K.u_all + c);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = T.row0 + r;
      cv[r] = c < k && row < T.rows ? (uint32_t)__ldg(T.c1 + (size_t)row * k + c) : 0u;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = mc;
      u[r] = uc;
      v[r] = x[r * C + c];
      if (mode == Y_TILE) {
        w[r] = y[r * C + c];
      } else if (mode == Y_ONE) {
        w[r] = 1u;
      } else {  // constant-time select: a masked sum over all 16 entries
        const uint32_t win = T.win[r];
        w[r] = 0u;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          w[r] += (uint32_t)T.entry(e)[r * C + c] & (0u - (uint32_t)(win == (uint32_t)e));
      }
    }
    mul_mod(v, w, m, u, K.f_mul);  // v = d
    if (c < k) {
      mul_mod(v, cv, m, u, K.f_mul);  // v = xi
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        T.xi_lo[r * SP + c] = (uint8_t)v[r];
        T.xi_hi[r * SP + c] = (uint8_t)(v[r] >> 8);
      }
    } else {
#pragma unroll
      for (int r = 0; r < RT; ++r) T.dB[r * (k + 1) + c - k] = (uint16_t)v[r];
    }
  }
  __syncthreads();
  extend<RT, true, W>(T, K, o);
  __syncthreads();
  extend<RT, false, W>(T, K, o);
  __syncthreads();
  // r_A = s_A - beta * (B mod a_i); beta < m_r, the smallest prime
  for (int c = threadIdx.x; c < k; c += W * 32) {
    uint32_t m[RT], u[RT], v[RT], w[RT];
    const uint32_t mc = (uint32_t)__ldg(K.m_all + c);
    const uint32_t uc = (uint32_t)__ldg(K.u_all + c);
    const uint32_t bma = (uint32_t)__ldg(K.b_mod_a + c);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = mc;
      u[r] = uc;
      v[r] = T.beta[r];
      w[r] = bma;
    }
    mul_mod(v, w, m, u, K.f_mul);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const uint32_t s = o[r * C + c];
      o[r * C + c] = (uint16_t)(s >= v[r] ? s - v[r] : s + mc - v[r]);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kernel 1: one product per row

// W warps, at most 128 registers a thread (16 / W blocks per SM)
template <int W>
__global__ void __launch_bounds__(W * 32, 16 / W)
rns_mont_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                    const int32_t* __restrict__ c1, const int32_t* __restrict__ nbmr,
                    const __grid_constant__ ProductConsts K, int rows,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem_tile[];
  const Tile T(smem_tile, K.k, kN, kMontMulArrays, c1, nbmr, rows);
  zero_smem<W>(smem_tile, T.L);
  __syncthreads();
  // the tile's rows lie one after another in x, y and out as in the
  // (kN, C) tiles; rows past `rows` stay zero and are never stored
  const int C = T.L.C;
  const int n = min(kN, rows - T.row0) * C;
  const size_t base = (size_t)T.row0 * C;
  uint16_t* xt = T.entry(0);
  uint16_t* yt = T.entry(1);
  for (int i = threadIdx.x; i < n; i += W * 32) {
    xt[i] = (uint16_t)__ldg(x + base + i);
    yt[i] = (uint16_t)__ldg(y + base + i);
  }
  __syncthreads();
  mont_mul<kN, W>(T, K, xt, yt, Y_TILE, xt);
  for (int i = threadIdx.x; i < n; i += W * 32) out[base + i] = (int32_t)xt[i];
  // x and y may be secret: zero all shared memory before the block exits
  __syncthreads();
  zero_smem<W>(smem_tile, T.L);
}

// Warps per block of kernel 1, a rule on the launch's tiles: 16 (the
// shortest chain per product) while one block per SM holds every tile,
// else 4, four blocks per SM (each at 128 registers a thread). Shared
// memory never limits it (16 KB a block at k=131).
int mont_mul_warps(int rows) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const int tiles = (rows + kN - 1) / kN;
  return tiles <= sms ? 16 : 4;
}

template <int W>
int launch_mont_mul(const void* x, const void* y, const void* c1, const void* nbmr,
                    const ProductConsts& K, int rows, void* out, cudaStream_t stream) {
  const size_t smem = Layout(K.k, kN, kMontMulArrays).bytes();
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_opt_in_smem(rns_mont_mul_kernel<W>);
    if (err != cudaSuccess) return (int)err;
  }
  rns_mont_mul_kernel<W><<<(rows + kN - 1) / kN, W * 32, smem, stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)c1, (const int32_t*)nbmr,
      K, rows, (int32_t*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel 2: base^exp per row

template <int RT>
__global__ void __launch_bounds__(kModexpWarps * 32)
rns_modexp_kernel(const int32_t* __restrict__ base_res,
                  const int32_t* __restrict__ exp, int exp_limbs, int exp_bits,
                  const int32_t* __restrict__ a2n_res,
                  const int32_t* __restrict__ c1,
                  const int32_t* __restrict__ nbmr,
                  const __grid_constant__ ProductConsts K, int rows,
                  int32_t* __restrict__ out) {
  constexpr int W = kModexpWarps, kThreads = W * 32;
  extern __shared__ __align__(16) uint8_t smem_tile[];
  const Tile T(smem_tile, K.k, RT, kModexpArrays, c1, nbmr, rows);
  const int C = T.L.C, row0 = T.row0;

  zero_smem<W>(smem_tile, T.L);
  __syncthreads();
  uint16_t* acc = T.entry(16);
  uint16_t* t0 = T.entry(0);
  uint16_t* t1 = T.entry(1);
  for (int c = threadIdx.x; c < C; c += kThreads) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (row0 + r < rows) {
        t1[r * C + c] = (uint16_t)base_res[(size_t)(row0 + r) * C + c];
        acc[r * C + c] = (uint16_t)a2n_res[(size_t)(row0 + r) * C + c];
      }
    }
  }
  __syncthreads();

  // into the A-Montgomery domain: x*A = MontMul(x, A^2 mod N)
  mont_mul<RT, W>(T, K, t1, acc, Y_TILE, t1);
  mont_mul<RT, W>(T, K, acc, nullptr, Y_ONE, t0);
  for (int j = 2; j < 16; ++j) mont_mul<RT, W>(T, K, T.entry(j - 1), t1, Y_TILE, T.entry(j));
  for (int c = threadIdx.x; c < C; c += kThreads) {
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r * C + c] = t0[r * C + c];
  }
  __syncthreads();

  for (int wi = 0; wi < exp_bits / 4; ++wi) {
    const int shift = exp_bits - 4 * (wi + 1);
    if ((int)threadIdx.x < RT) {
      const int row = row0 + threadIdx.x;
      T.win[threadIdx.x] =
          row < rows ? ((uint32_t)exp[(size_t)row * exp_limbs + (shift >> 4)] >> (shift & 15)) & 15u
                     : 0u;
    }
    // four squarings, then the window's multiply (the squarings' barriers
    // order win[] before the select reads it)
    for (int s = 0; s < 5; ++s)
      mont_mul<RT, W>(T, K, acc, acc, s < 4 ? Y_TILE : Y_SELECT, acc);
  }
  // leave the Montgomery domain
  mont_mul<RT, W>(T, K, acc, nullptr, Y_ONE, acc);
  for (int c = threadIdx.x; c < C; c += kThreads) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (row0 + r < rows) out[(size_t)(row0 + r) * C + c] = (int32_t)acc[r * C + c];
  }
  // the table, planes and accumulator hold powers of a possibly secret
  // base: zero all shared memory before the block exits
  __syncthreads();
  zero_smem<W>(smem_tile, T.L);
}

// R_T: 8 rows per block where the tile fits in shared memory, else 4
int tile_rows(int k) { return Layout(k, 8, kModexpArrays).bytes() <= kSmemLimit ? 8 : 4; }

template <int RT>
int launch_modexp(const void* base_res, const void* exp, int exp_limbs,
                  int exp_bits, const void* a2n_res, const void* c1,
                  const void* nbmr, const ProductConsts& K, int rows, void* out,
                  cudaStream_t stream) {
  const size_t smem = Layout(K.k, RT, kModexpArrays).bytes();
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_opt_in_smem(rns_modexp_kernel<RT>);
  if (err != cudaSuccess) return (int)err;
  rns_modexp_kernel<RT><<<(rows + RT - 1) / RT, kModexpWarps * 32, smem, stream>>>(
      (const int32_t*)base_res, (const int32_t*)exp, exp_limbs, exp_bits,
      (const int32_t*)a2n_res, (const int32_t*)c1, (const int32_t*)nbmr, K, rows,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// folds: f_mul, f_mid, f_hh, f_ext (ops/rns_kernels.py::fold_counts)
ProductConsts product_consts(const void* m_all, const void* u_all, const void* T1lo,
                             const void* T1hi, const void* T2lo, const void* T2hi,
                             const void* ainv_b, const void* c2_b, const void* b_mod_a,
                             unsigned binv_r, int k, const int* folds) {
  ProductConsts K;
  K.m_all = (const int32_t*)m_all;
  K.u_all = (const int32_t*)u_all;
  K.T1lo = (const uint4*)T1lo;
  K.T1hi = (const uint4*)T1hi;
  K.T2lo = (const uint4*)T2lo;
  K.T2hi = (const uint4*)T2hi;
  K.ainv_b = (const int32_t*)ainv_b;
  K.c2_b = (const int32_t*)c2_b;
  K.b_mod_a = (const int32_t*)b_mod_a;
  K.binv_r = binv_r;
  K.k = k;
  K.f_mul = folds[0];
  K.f_mid = folds[1];
  K.f_hh = folds[2];
  K.f_ext = folds[3];
  return K;
}

}  // namespace

extern "C" int fsdkr_rns_mont_mul(const void* x, const void* y, const void* c1,
                                  const void* nbmr, const void* m_all,
                                  const void* u_all, const void* T1lo,
                                  const void* T1hi, const void* T2lo,
                                  const void* T2hi, const void* ainv_b,
                                  const void* c2_b, const void* b_mod_a,
                                  unsigned binv_r, int k, const int* folds,
                                  int rows, void* out, void* stream) {
  if (rows <= 0) return 0;
  const ProductConsts K = product_consts(m_all, u_all, T1lo, T1hi, T2lo, T2hi, ainv_b,
                                         c2_b, b_mod_a, binv_r, k, folds);
  const cudaStream_t s = (cudaStream_t)stream;
  if (mont_mul_warps(rows) == 16)
    return launch_mont_mul<16>(x, y, c1, nbmr, K, rows, out, s);
  return launch_mont_mul<4>(x, y, c1, nbmr, K, rows, out, s);
}

extern "C" int fsdkr_rns_modexp(const void* base_res, const void* exp,
                                int exp_limbs, int exp_bits,
                                const void* a2n_res, const void* c1,
                                const void* nbmr, const void* m_all,
                                const void* u_all, const void* T1lo,
                                const void* T1hi, const void* T2lo,
                                const void* T2hi, const void* ainv_b,
                                const void* c2_b, const void* b_mod_a,
                                unsigned binv_r, int k, const int* folds,
                                int rows, void* out, void* stream) {
  if (rows <= 0) return 0;
  const ProductConsts K = product_consts(m_all, u_all, T1lo, T1hi, T2lo, T2hi, ainv_b,
                                         c2_b, b_mod_a, binv_r, k, folds);
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile_rows(k) == 8)
    return launch_modexp<8>(base_res, exp, exp_limbs, exp_bits, a2n_res, c1,
                            nbmr, K, rows, out, s);
  return launch_modexp<4>(base_res, exp, exp_limbs, exp_bits, a2n_res, c1, nbmr,
                          K, rows, out, s);
}
