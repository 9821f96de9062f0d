// Native host bignum core of the PyTorch port: prime generation and the
// secret-CRT legs.
//
// A trimmed copy of the JAX package's csrc/fsdkr_native.cpp: fixed-width
// Montgomery arithmetic over 64-bit limbs (unsigned __int128 partial
// products), a plain C ABI loaded from
// Python with ctypes (fsdkr_tpu_torch/native). It keeps the entry points
// the port's host paths call: the Miller-Rabin batch of the prime
// pipeline (core/primes.py), the run-grouped CRT leg batch and the
// one-shot fixed-base comb of the secret-CRT engine (backend/crt.py).
// Every Montgomery product runs on GMP's mpn functions (asm basecase
// multiplication, Karatsuba above ~30 limbs, asm REDC), resolved from
// the system libgmp.so.10 at run time; the portable u128 CIOS/SOS loop
// stays as a test hook (fsdkr_set_mpn(0)) and gives the same bits.
//
// All numbers are little-endian uint64 limb arrays of a caller-chosen
// width; moduli must be odd. Maximum width MAXL limbs.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <dlfcn.h>
#include <new>
#include <thread>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

// 8320 bits: the widest CRT leg, p^2 r for an 8192-bit Paillier modulus
static const int MAXL = 130;

// ---------------------------------------------------------------------------
// Row parallelism. Every batch entry point below iterates over rows that
// are mathematically independent (per-row modulus, per-row output slice),
// so splitting the row range across threads is bit-identical to the
// serial loop at any thread count — the per-row computation is exactly
// the same code, and no row reads another row's state. The count is set
// from Python (fsdkr_tpu_torch/native: every core, unless a caller
// sets a count; 0 = auto from hardware_concurrency, 1 = serial).
// Threads are spawned per call: batch calls are milliseconds-to-seconds
// of work, so spawn cost (~tens of us) is noise, and no pool lifecycle
// can leak across fork or library reload.

static std::atomic<int> g_threads{1};

template <class F>
static void parallel_rows(int rows, const F &fn) {
  int nt = g_threads.load(std::memory_order_relaxed);
  if (nt > rows)
    nt = rows;
  if (nt <= 1 || rows <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt - 1);
  const int chunk = rows / nt, rem = rows % nt;
  int lo = 0;
  for (int i = 0; i < nt; i++) {
    const int hi = lo + chunk + (i < rem ? 1 : 0);
    if (i == nt - 1)
      fn(lo, hi); // run the last chunk on the calling thread
    else
      ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
    lo = hi;
  }
  for (auto &t : ts)
    t.join();
}

extern "C" {

// Thread-count control. Returns the applied count.
int fsdkr_set_threads(int n) {
  if (n <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n = hc ? (int)hc : 1;
  }
  g_threads.store(n, std::memory_order_relaxed);
  return n;
}

int fsdkr_get_threads(void) {
  return g_threads.load(std::memory_order_relaxed);
}

} // extern "C" (reopened below; the mpn plumbing is C++)

// ---------------------------------------------------------------------------
// The GMP mpn backend of the Montgomery product. libgmp carries asm
// basecase multiplication and Karatsuba above ~30 limbs: at the 64-limb
// (n^2, 4096-bit) width its mul+REDC-1 is ~2.4x the portable u128 loop
// below, ~2x at 32 limbs. The functions are resolved at RUN TIME with
// dlopen/dlsym (no GMP headers needed; mp_limb_t == uint64_t on every
// LP64 target this builds for), and every mont_mul/mont_sqr dispatches
// on one acquire load: results are BIT-IDENTICAL either way (the same
// canonical residue < n), so the switch is a pure speed choice.

typedef u64 (*mpn_addmul_1_fn)(u64 *, const u64 *, long, u64);
typedef void (*mpn_mul_n_fn)(u64 *, const u64 *, const u64 *, long);
typedef void (*mpn_sqr_fn)(u64 *, const u64 *, long);
typedef u64 (*mpn_sub_n_fn)(u64 *, const u64 *, const u64 *, long);
typedef int (*mpn_cmp_fn)(const u64 *, const u64 *, long);
typedef u64 (*mpn_redc_1_fn)(u64 *, u64 *, const u64 *, long, u64);

static mpn_addmul_1_fn g_mpn_addmul_1 = nullptr;
static mpn_mul_n_fn g_mpn_mul_n = nullptr;
static mpn_sqr_fn g_mpn_sqr = nullptr;
static mpn_sub_n_fn g_mpn_sub_n = nullptr;
static mpn_cmp_fn g_mpn_cmp = nullptr;
// internal-but-exported asm REDC (GMP keeps mpn symbols stable within a
// soname); nullptr takes the addmul_1 loop, the same algorithm ~10%
// slower
static mpn_redc_1_fn g_mpn_redc_1 = nullptr;
static std::atomic<int> g_use_mpn{0};
static std::atomic<int> g_mpn_probed{0};

static int mpn_probe() { // idempotent; races only re-store identical values
  if (g_mpn_probed.load(std::memory_order_acquire))
    return g_mpn_addmul_1 != nullptr;
  void *h = dlopen("libgmp.so.10", RTLD_NOW | RTLD_LOCAL);
  if (!h)
    h = dlopen("libgmp.so", RTLD_NOW | RTLD_LOCAL);
  if (h) {
    mpn_addmul_1_fn am = (mpn_addmul_1_fn)dlsym(h, "__gmpn_addmul_1");
    mpn_mul_n_fn mn = (mpn_mul_n_fn)dlsym(h, "__gmpn_mul_n");
    mpn_sqr_fn sq = (mpn_sqr_fn)dlsym(h, "__gmpn_sqr");
    mpn_sub_n_fn sb = (mpn_sub_n_fn)dlsym(h, "__gmpn_sub_n");
    mpn_cmp_fn cp = (mpn_cmp_fn)dlsym(h, "__gmpn_cmp");
    if (am && mn && sq && sb && cp) {
      g_mpn_mul_n = mn;
      g_mpn_sqr = sq;
      g_mpn_sub_n = sb;
      g_mpn_cmp = cp;
      g_mpn_redc_1 = (mpn_redc_1_fn)dlsym(h, "__gmpn_redc_1"); // optional
      g_mpn_addmul_1 = am; // published last: the dispatch gates on it
    } // a partial symbol set resolves nothing (never dlclose: the
      // handle must outlive every worker thread)
  }
  g_mpn_probed.store(1, std::memory_order_release);
  return g_mpn_addmul_1 != nullptr;
}

extern "C" {

// n != 0: the mpn engine (granted only if libgmp resolves; the Python
// bridge raises when it does not), 0: the portable u128 core. Returns
// the active engine: 1 = mpn, 0 = portable. Release store: pairs with
// the dispatchers' acquire loads, so a thread that reads g_use_mpn == 1
// also sees the g_mpn_* pointers mpn_probe stored.
int fsdkr_set_mpn(int n) {
  int want = (n != 0) && mpn_probe();
  g_use_mpn.store(want ? 1 : 0, std::memory_order_release);
  return want ? 1 : 0;
}

// 1 = GMP mpn inner loop active, 0 = portable u128 CIOS core.
int fsdkr_engine_kind(void) {
  return g_use_mpn.load(std::memory_order_relaxed);
}


// ---------------------------------------------------------------------------
// limb helpers

// Volatile wipe that the optimizer cannot elide: secret-bearing limb
// buffers (exponents, secret-derived bases and their power tables, prime
// candidates) are zeroed before frames return — the native-side
// equivalent of the reference's zeroize discipline
// (src/refresh_message.rs:446-448).
static void secure_wipe(u64 *p, int L) {
  volatile u64 *vp = p;
  for (int i = 0; i < L; i++)
    vp[i] = 0;
}

static int cmp_limbs(const u64 *a, const u64 *b, int L) {
  for (int i = L - 1; i >= 0; i--) {
    if (a[i] < b[i])
      return -1;
    if (a[i] > b[i])
      return 1;
  }
  return 0;
}

static void sub_limbs(u64 *out, const u64 *a, const u64 *b, int L) {
  u64 borrow = 0;
  for (int i = 0; i < L; i++) {
    u64 bi = b[i] + borrow;
    u64 new_borrow = (bi < b[i]) || (a[i] < bi);
    out[i] = a[i] - bi;
    borrow = new_borrow;
  }
}

// -n^{-1} mod 2^64 by Newton iteration (n odd)
static u64 mont_n0inv(u64 n0) {
  u64 x = n0; // 3 correct bits
  for (int i = 0; i < 6; i++)
    x *= 2 - n0 * x; // doubles correct bits each round
  return (u64)0 - x;
}

// ---------------------------------------------------------------------------
// Montgomery CIOS multiplication: out = a * b * R^{-1} mod n, R = 2^(64 L)

static void mont_mul_cios(u64 *out, const u64 *a, const u64 *b, const u64 *n,
                          u64 n0inv, int L) {
  u64 t[MAXL + 2];
  std::memset(t, 0, sizeof(u64) * (L + 2));
  for (int i = 0; i < L; i++) {
    u128 carry = 0;
    const u64 ai = a[i];
    for (int j = 0; j < L; j++) {
      u128 cur = (u128)ai * b[j] + t[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[L] + carry;
    t[L] = (u64)cur;
    t[L + 1] += (u64)(cur >> 64);

    const u64 m = t[0] * n0inv;
    carry = ((u128)m * n[0] + t[0]) >> 64;
    for (int j = 1; j < L; j++) {
      u128 cur2 = (u128)m * n[j] + t[j] + carry;
      t[j - 1] = (u64)cur2;
      carry = cur2 >> 64;
    }
    cur = (u128)t[L] + carry;
    t[L - 1] = (u64)cur;
    t[L] = t[L + 1] + (u64)(cur >> 64);
    t[L + 1] = 0;
  }
  if (t[L] != 0 || cmp_limbs(t, n, L) >= 0)
    sub_limbs(out, t, n, L); // t < 2n always, one subtract suffices
  else
    std::memcpy(out, t, sizeof(u64) * L);
}

// ---------------------------------------------------------------------------
// Dedicated Montgomery squaring: out = a * a * R^{-1} mod n. SOS layout —
// the symmetric half of the schoolbook product is computed once and
// doubled (L(L+1)/2 limb products instead of L^2), then a separate
// Montgomery reduction pass (L^2 products) finishes. Measured 0.66x the
// general mont_mul at 64 limbs, 0.69x at 32, 0.76x at 24 on this class
// of host — and every modexp ladder is ~4 squarings per multiply, so the
// squaring chain is where modexp wall-clock actually lives.

static void mont_sqr_sos(u64 *out, const u64 *a, const u64 *n, u64 n0inv,
                         int L) {
  u64 t[2 * MAXL + 1];
  std::memset(t, 0, sizeof(u64) * (2 * L + 1));
  // cross products a_i * a_j (i < j), each summed once. t[i+L] is
  // provably still zero when row i deposits its final carry there (rows
  // i' < i only reach position i'+L < i+L), so no carry-out can wrap.
  for (int i = 0; i < L; i++) {
    u128 carry = 0;
    const u64 ai = a[i];
    for (int j = i + 1; j < L; j++) {
      u128 cur = (u128)ai * a[j] + t[i + j] + carry;
      t[i + j] = (u64)cur;
      carry = cur >> 64;
    }
    t[i + L] += (u64)carry;
  }
  // double the cross half, then add the diagonal a_i^2 terms
  {
    u64 c = 0;
    for (int i = 0; i < 2 * L; i++) {
      u64 hi = t[i] >> 63;
      t[i] = (t[i] << 1) | c;
      c = hi;
    }
    t[2 * L] = c;
  }
  {
    u128 carry = 0;
    for (int i = 0; i < L; i++) {
      u128 cur = (u128)a[i] * a[i] + t[2 * i] + carry;
      t[2 * i] = (u64)cur;
      carry = cur >> 64;
      cur = (u128)t[2 * i + 1] + carry;
      t[2 * i + 1] = (u64)cur;
      carry = cur >> 64;
    }
    t[2 * L] += (u64)carry;
  }
  // Montgomery reduction of the 2L-word square
  for (int i = 0; i < L; i++) {
    const u64 m = t[i] * n0inv;
    u128 carry = 0;
    for (int j = 0; j < L; j++) {
      u128 cur = (u128)m * n[j] + t[i + j] + carry;
      t[i + j] = (u64)cur;
      carry = cur >> 64;
    }
    for (int j = i + L; carry && j <= 2 * L; j++) {
      u128 cur = (u128)t[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
  }
  // result in t[L..2L]; t[2L] in {0,1} and the value is < 2n. The stack
  // temp is left to be overwritten by the next call, matching mont_mul:
  // the wipe discipline lives in the calling frames' persistent buffers.
  if (t[2 * L] != 0 || cmp_limbs(t + L, n, L) >= 0)
    sub_limbs(out, t + L, n, L);
  else
    std::memcpy(out, t + L, sizeof(u64) * L);
}

// mpn-backed Montgomery product/square: schoolbook/Karatsuba product via
// mpn_mul_n / mpn_sqr, then textbook REDC-1 (L rounds of addmul_1 by
// m = t_i * n0inv, carries rippled into the high half), conditional
// subtract. The intermediate t < 2n * R always fits 2L+1 limbs, and the
// final residue is canonical (< n) exactly like the CIOS/SOS cores:
// the two engines are interchangeable mid-ladder.

static inline void mpn_redc(u64 *out, u64 *t, const u64 *n, u64 n0inv,
                            int L) {
  // t: 2L+1 limbs, t[2L] = 0 on entry; result < n into out
  if (g_mpn_redc_1) {
    u64 c = g_mpn_redc_1(out, t, n, L, n0inv);
    if (c || g_mpn_cmp(out, n, L) >= 0)
      g_mpn_sub_n(out, out, n, L);
    return;
  }
  for (int i = 0; i < L; i++) {
    const u64 m = t[i] * n0inv;
    u64 c = g_mpn_addmul_1(t + i, n, L, m);
    for (int j = i + L; c; j++) {
      u64 s = t[j] + c;
      c = s < c;
      t[j] = s;
    }
  }
  if (t[2 * L] != 0 || g_mpn_cmp(t + L, n, L) >= 0)
    g_mpn_sub_n(out, t + L, n, L);
  else
    std::memcpy(out, t + L, sizeof(u64) * L);
}

static void mont_mul_mpn(u64 *out, const u64 *a, const u64 *b, const u64 *n,
                         u64 n0inv, int L) {
  u64 t[2 * MAXL + 1];
  g_mpn_mul_n(t, a, b, L);
  t[2 * L] = 0;
  mpn_redc(out, t, n, n0inv, L);
}

static void mont_sqr_mpn(u64 *out, const u64 *a, const u64 *n, u64 n0inv,
                         int L) {
  u64 t[2 * MAXL + 1];
  g_mpn_sqr(t, a, L);
  t[2 * L] = 0;
  mpn_redc(out, t, n, n0inv, L);
}

// Every ladder below calls these dispatchers; one acquire load per
// Montgomery operation is noise against the ~L^2 limb products behind
// it (acquire pairs with fsdkr_set_mpn's release so the g_mpn_* pointer
// stores are visible whenever the flag reads 1, on any memory model).
static inline void mont_mul(u64 *out, const u64 *a, const u64 *b,
                            const u64 *n, u64 n0inv, int L) {
  if (g_use_mpn.load(std::memory_order_acquire))
    mont_mul_mpn(out, a, b, n, n0inv, L);
  else
    mont_mul_cios(out, a, b, n, n0inv, L);
}

static inline void mont_sqr(u64 *out, const u64 *a, const u64 *n, u64 n0inv,
                            int L) {
  if (g_use_mpn.load(std::memory_order_acquire))
    mont_sqr_mpn(out, a, n, n0inv, L);
  else
    mont_sqr_sos(out, a, n, n0inv, L);
}

// R mod n and R^2 mod n by doubling (L <= MAXL)
static void mont_constants(const u64 *n, int L, u64 *r_mod, u64 *r2_mod) {
  // r_mod = R mod n: start from 2^(64L - 1) mod n (top bit), double once
  u64 acc[MAXL];
  std::memset(acc, 0, sizeof(u64) * L);
  // set acc = 1, then double 64*L times mod n
  acc[0] = 1;
  for (int bit = 0; bit < 64 * L; bit++) {
    // acc = 2*acc mod n
    u64 carry = 0;
    for (int i = 0; i < L; i++) {
      u64 hi = acc[i] >> 63;
      acc[i] = (acc[i] << 1) | carry;
      carry = hi;
    }
    if (carry || cmp_limbs(acc, n, L) >= 0)
      sub_limbs(acc, acc, n, L);
  }
  std::memcpy(r_mod, acc, sizeof(u64) * L);
  // r2_mod = R^2 mod n: double 64*L more times
  for (int bit = 0; bit < 64 * L; bit++) {
    u64 carry = 0;
    for (int i = 0; i < L; i++) {
      u64 hi = acc[i] >> 63;
      acc[i] = (acc[i] << 1) | carry;
      carry = hi;
    }
    if (carry || cmp_limbs(acc, n, L) >= 0)
      sub_limbs(acc, acc, n, L);
  }
  std::memcpy(r2_mod, acc, sizeof(u64) * L);
}

// ---------------------------------------------------------------------------
// modexp: out = base^exp mod n. n odd, L limbs; exp EL limbs.
// Fixed wbits-wide window (4..8, caller-chosen by exponent width: wider
// windows trade table-build multiplies for fewer per-window lookups, so
// w=6 wins for full-width exponents and w=4 for short ones), MSB-first.

// Core ladder against caller-owned Montgomery constants (n0inv, one_m,
// r2). Wipes every temporary it creates (reduced base, Montgomery base,
// window table, accumulator) but NOT the constants — the CRT leg batch
// amortizes one mont_constants over a run of equal-modulus rows and
// wipes them once per run.
static int modexp_core(const u64 *base, const u64 *exp, const u64 *n,
                       u64 n0inv, const u64 *one_m, const u64 *r2, u64 *out,
                       int L, int EL, int wbits) {
  // wbits capped at 6: the 2^wbits-entry stack table is 32 KB there, and
  // the build-vs-lookup tradeoff already tips back past w=6 for every
  // protocol exponent width
  if (L <= 0 || L > MAXL || EL <= 0 || wbits < 1 || wbits > 6 ||
      !(n[0] & 1))
    return -1;

  // reduce base below n (base < 2^(64L); subtract n a few times if needed —
  // callers pass base < n, this is just a guard)
  u64 b[MAXL];
  std::memcpy(b, base, sizeof(u64) * L);
  while (cmp_limbs(b, n, L) >= 0)
    sub_limbs(b, b, n, L);

  u64 base_m[MAXL];
  mont_mul(base_m, b, r2, n, n0inv, L);

  // window table: t[d] = base^d in Montgomery form (even entries are
  // squares of earlier entries — cheaper than a multiply)
  const int D = 1 << wbits;
  u64 table[64][MAXL];
  std::memcpy(table[0], one_m, sizeof(u64) * L);
  std::memcpy(table[1], base_m, sizeof(u64) * L);
  for (int d = 2; d < D; d++) {
    if (d % 2 == 0)
      mont_sqr(table[d], table[d / 2], n, n0inv, L);
    else
      mont_mul(table[d], table[d - 1], base_m, n, n0inv, L);
  }

  // top set window
  int top_bit = -1;
  for (int i = EL - 1; i >= 0 && top_bit < 0; i--)
    if (exp[i])
      for (int bit = 63; bit >= 0; bit--)
        if ((exp[i] >> bit) & 1) {
          top_bit = i * 64 + bit;
          break;
        }
  u64 acc[MAXL];
  u64 onev[MAXL];
  std::memset(onev, 0, sizeof(u64) * L);
  onev[0] = 1;
  if (top_bit < 0) { // exp == 0
    std::memcpy(out, one_m, sizeof(u64) * L);
    mont_mul(out, out, onev, n, n0inv, L); // leave Montgomery domain -> 1
    secure_wipe(b, L);
    secure_wipe(base_m, L);
    secure_wipe(&table[0][0], D * MAXL);
    return 0;
  }

  int nwin = top_bit / wbits; // highest window index
  const u64 mask = (u64)D - 1;
  std::memcpy(acc, one_m, sizeof(u64) * L);
  for (int w = nwin; w >= 0; w--) {
    for (int s = 0; s < wbits; s++)
      mont_sqr(acc, acc, n, n0inv, L);
    int bit0 = w * wbits; // windows may straddle a 64-bit limb
    u64 d = exp[bit0 / 64] >> (bit0 % 64);
    if (bit0 % 64 + wbits > 64 && bit0 / 64 + 1 < EL)
      d |= exp[bit0 / 64 + 1] << (64 - bit0 % 64);
    d &= mask;
    mont_mul(acc, acc, table[d], n, n0inv, L);
  }

  mont_mul(out, acc, onev, n, n0inv, L);
  secure_wipe(b, L);
  secure_wipe(base_m, L);
  secure_wipe(&table[0][0], D * MAXL);
  secure_wipe(acc, L);
  return 0;
}

// ---------------------------------------------------------------------------
// Miller-Rabin: 1 = probable prime, 0 = composite, -1 = bad input.
// Witness bases are caller-provided (sampled with a CSPRNG in Python) so
// the native side stays deterministic and testable.

int fsdkr_miller_rabin(const u64 *n, int L, const u64 *witnesses, int rounds) {
  if (L <= 0 || L > MAXL || !(n[0] & 1))
    return -1;

  const u64 n0inv = mont_n0inv(n[0]);
  u64 one_m[MAXL], r2[MAXL];
  mont_constants(n, L, one_m, r2);

  // n1 = n - 1 = 2^r * d
  u64 n1[MAXL], d[MAXL];
  u64 onev[MAXL];
  std::memset(onev, 0, sizeof(u64) * L);
  onev[0] = 1;
  sub_limbs(n1, n, onev, L);
  std::memcpy(d, n1, sizeof(u64) * L);
  int r = 0;
  while (!(d[0] & 1)) {
    for (int i = 0; i < L - 1; i++)
      d[i] = (d[i] >> 1) | (d[i + 1] << 63);
    d[L - 1] >>= 1;
    r++;
  }

  u64 n1_m[MAXL]; // n-1 in Montgomery form, for comparisons
  mont_mul(n1_m, n1, r2, n, n0inv, L);

  // Rounds are independent (each witness runs its own power chain from
  // shared read-only constants), so they split across threads; the
  // verdict is "composite iff ANY round found a witness", which is
  // order-independent — identical at every thread count. A found
  // witness short-circuits the remaining rounds on every thread.
  std::atomic<bool> composite{false};
  parallel_rows(rounds, [&](int lo, int hi) {
    u64 a_m[MAXL];
    u64 ared[MAXL];
    u64 x[MAXL];
    for (int round = lo; round < hi; round++) {
      if (composite.load(std::memory_order_relaxed))
        break;
      const u64 *a = witnesses + (size_t)round * L;
      std::memcpy(ared, a, sizeof(u64) * L);
      while (cmp_limbs(ared, n, L) >= 0)
        sub_limbs(ared, ared, n, L);
      mont_mul(a_m, ared, r2, n, n0inv, L);

      // x = a^d mod n (Montgomery domain, square-and-multiply MSB-first)
      int top_bit = -1;
      for (int i = L - 1; i >= 0 && top_bit < 0; i--)
        if (d[i])
          for (int bit = 63; bit >= 0; bit--)
            if ((d[i] >> bit) & 1) {
              top_bit = i * 64 + bit;
              break;
            }
      std::memcpy(x, one_m, sizeof(u64) * L);
      for (int bit = top_bit; bit >= 0; bit--) {
        mont_sqr(x, x, n, n0inv, L);
        if ((d[bit / 64] >> (bit % 64)) & 1)
          mont_mul(x, x, a_m, n, n0inv, L);
      }

      if (cmp_limbs(x, one_m, L) == 0 || cmp_limbs(x, n1_m, L) == 0)
        continue;
      bool witness = true;
      for (int i = 0; i < r - 1; i++) {
        mont_sqr(x, x, n, n0inv, L);
        if (cmp_limbs(x, n1_m, L) == 0) {
          witness = false;
          break;
        }
      }
      if (witness)
        composite.store(true, std::memory_order_relaxed);
    }
    // witness-power state derives from the secret prime candidate
    secure_wipe(x, MAXL);
    secure_wipe(a_m, MAXL);
    secure_wipe(ared, MAXL);
  });
  secure_wipe(d, L);
  secure_wipe(n1, L);
  secure_wipe(n1_m, L);
  // one_m/r2 are R mod n and R^2 mod n with R public: n is recoverable
  // from either (gcd(R - one_m, R^2 - r2)), so they are as secret as
  // the prime candidate itself
  secure_wipe(one_m, L);
  secure_wipe(r2, L);
  return composite.load() ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Secret-CRT leg batch: the prover-owned-modulus engine's half-width
// modexp legs (backend/crt.py). Rows are the p/q legs of CRT-decomposed
// exponentiations — base and exponent already reduced by the Python
// planner (base mod p*r, exponent mod lcm(p-1, r-1) with r the fresh
// 64-bit fault-check prime), so every operand here is SECRET-DERIVED:
// the modulus itself contains a factor of the prover's key. Semantics
// are row-wise modexp exactly like fsdkr_modexp_batch_w, with one
// difference exploited by the planner's row layout: Montgomery
// constants (the ~60-montmul doubling ladder of mont_constants) are
// computed once per RUN of equal consecutive moduli instead of once per
// row — CRT legs arrive grouped per context (a correct-key proof
// submits `rounds` consecutive rows mod the same p*r), so constants
// amortize over each group. Thread-chunk boundaries recompute the run
// constants at their first row, so the split is bit-identical to the
// serial loop. Constants are wiped at every run boundary (they
// reconstruct the secret leg modulus via gcd(R - one_m, R^2 - r2)).

int fsdkr_crt_modexp_batch(const u64 *bases, const u64 *exps, const u64 *mods,
                           u64 *outs, int rows, int L, int EL, int wbits) {
  if (L <= 0 || L > MAXL || EL <= 0 || rows <= 0 || wbits < 1 || wbits > 6)
    return -1;
  for (int r = 0; r < rows; r++)
    if (!(mods[(size_t)r * L] & 1))
      return -1;
  std::atomic<int> rc{0};
  parallel_rows(rows, [&](int lo, int hi) {
    u64 one_m[MAXL], r2[MAXL];
    const u64 *cur_n = nullptr;
    u64 n0inv = 0;
    for (int i = lo; i < hi; i++) {
      if (rc.load(std::memory_order_relaxed) != 0)
        break;
      const u64 *n = mods + (size_t)i * L;
      if (cur_n == nullptr || std::memcmp(n, cur_n, sizeof(u64) * L) != 0) {
        if (cur_n != nullptr) { // run boundary: old constants are secret
          secure_wipe(one_m, L);
          secure_wipe(r2, L);
        }
        n0inv = mont_n0inv(n[0]);
        mont_constants(n, L, one_m, r2);
        cur_n = n;
      }
      int r = modexp_core(bases + (size_t)i * L, exps + (size_t)i * EL, n,
                          n0inv, one_m, r2, outs + (size_t)i * L, L, EL,
                          wbits);
      if (r != 0)
        rc.store(r, std::memory_order_relaxed);
    }
    secure_wipe(one_m, MAXL);
    secure_wipe(r2, MAXL);
  });
  return rc.load();
}

// ---------------------------------------------------------------------------
// Row-parallel Miller-Rabin batch: the prime-generation shape (many
// candidates, each with its own CSPRNG witnesses) — candidates split
// across the row pool, rounds run serially per candidate
// with composite short-circuit. verdicts[i]: 1 probable prime, 0
// composite. The single-candidate entry point (fsdkr_miller_rabin,
// round-parallel) stays for the confirmation call on one candidate;
// this one kills the per-candidate bridge overhead of the generation
// loop (one staging + one native call for a whole sieve window).

static int mr_test_row(const u64 *n, int L, const u64 *wits, int rounds) {
  if (!(n[0] & 1))
    return -1;
  // n == 1 would make d = n-1 = 0 and spin the shift loop below forever;
  // the ABI entry validates nothing beyond oddness, so guard here
  bool gt_one = n[0] > 1;
  for (int i = 1; i < L && !gt_one; i++)
    gt_one = n[i] != 0;
  if (!gt_one)
    return -1;
  const u64 n0inv = mont_n0inv(n[0]);
  u64 one_m[MAXL], r2[MAXL];
  mont_constants(n, L, one_m, r2);

  u64 n1[MAXL], d[MAXL], onev[MAXL];
  std::memset(onev, 0, sizeof(u64) * L);
  onev[0] = 1;
  sub_limbs(n1, n, onev, L);
  std::memcpy(d, n1, sizeof(u64) * L);
  int r = 0;
  while (!(d[0] & 1)) {
    for (int i = 0; i < L - 1; i++)
      d[i] = (d[i] >> 1) | (d[i + 1] << 63);
    d[L - 1] >>= 1;
    r++;
  }
  u64 n1_m[MAXL];
  mont_mul(n1_m, n1, r2, n, n0inv, L);

  int top_bit = -1;
  for (int i = L - 1; i >= 0 && top_bit < 0; i--)
    if (d[i])
      for (int bit = 63; bit >= 0; bit--)
        if ((d[i] >> bit) & 1) {
          top_bit = i * 64 + bit;
          break;
        }

  bool composite = false;
  u64 a_m[MAXL], ared[MAXL], x[MAXL];
  for (int round = 0; round < rounds && !composite; round++) {
    const u64 *a = wits + (size_t)round * L;
    std::memcpy(ared, a, sizeof(u64) * L);
    while (cmp_limbs(ared, n, L) >= 0)
      sub_limbs(ared, ared, n, L);
    mont_mul(a_m, ared, r2, n, n0inv, L);
    std::memcpy(x, one_m, sizeof(u64) * L);
    for (int bit = top_bit; bit >= 0; bit--) {
      mont_sqr(x, x, n, n0inv, L);
      if ((d[bit / 64] >> (bit % 64)) & 1)
        mont_mul(x, x, a_m, n, n0inv, L);
    }
    if (cmp_limbs(x, one_m, L) == 0 || cmp_limbs(x, n1_m, L) == 0)
      continue;
    bool witness = true;
    for (int i = 0; i < r - 1; i++) {
      mont_sqr(x, x, n, n0inv, L);
      if (cmp_limbs(x, n1_m, L) == 0) {
        witness = false;
        break;
      }
    }
    if (witness)
      composite = true;
  }
  // every temporary derives from the secret prime candidate
  secure_wipe(x, MAXL);
  secure_wipe(a_m, MAXL);
  secure_wipe(ared, MAXL);
  secure_wipe(d, L);
  secure_wipe(n1, L);
  secure_wipe(n1_m, L);
  secure_wipe(one_m, L);
  secure_wipe(r2, L);
  return composite ? 0 : 1;
}

int fsdkr_miller_rabin_batch(const u64 *ns, const u64 *witnesses,
                             int *verdicts, int rows, int L, int rounds) {
  if (L <= 0 || L > MAXL || rows <= 0 || rounds <= 0)
    return -1;
  std::atomic<int> rc{0};
  parallel_rows(rows, [&](int lo, int hi) {
    for (int i = lo; i < hi; i++) {
      if (rc.load(std::memory_order_relaxed) != 0)
        return;
      int v = mr_test_row(ns + (size_t)i * L,
                          L, witnesses + (size_t)i * rounds * L, rounds);
      if (v < 0)
        rc.store(-1, std::memory_order_relaxed);
      else
        verdicts[i] = v;
    }
  });
  return rc.load();
}

// Fixed-base comb: out[m] = base^exps[m] mod n for M exponents sharing
// one (base, modulus) — the dominant column shape of the O(n^2) verify
// loop (every receiver checks the same sender's h1/h2/T bases;
// reference loop: src/refresh_message.rs:330-365). Per wbits-wide window
// position w the 2^wbits-entry table holds (base^((2^wbits)^w))^d, so
// each row costs only ~ebits/wbits multiplies and the squaring ladder is
// paid once in the precompute, amortized over M. The window width is a
// caller choice: wider windows cut the per-row multiplies ~linearly but
// grow the per-group table build by 2^wbits, so the bridge picks wbits
// by rows-per-group (w=6 beats w=4 by ~22% at the ring-Pedersen M=256
// shape; w=4 stays optimal for the n-row pair groups).
// Comb geometry validation shared by precompute/apply/one-shot.
// EL is capped: verify-side exponents are adversary-supplied proof
// integers, and the comb table is (64 EL / wbits)*2^wbits*L words — an
// unbounded EL would let one malicious proof force a huge (or throwing)
// allocation where the generic kernel merely computes slowly. 2*MAXL
// limbs covers every protocol exponent incl. range slack.
static int comb_windows(int L, int EL, int wbits, const u64 *n) {
  if (L <= 0 || L > MAXL || EL <= 0 || EL > 2 * MAXL || wbits < 1 ||
      wbits > 8 || !(n[0] & 1))
    return -1;
  return (EL * 64 + wbits - 1) / wbits;
}

// Words needed for a comb window table of this geometry (Python sizes
// the cacheable buffer with this; -1 on bad geometry). Fits int: the
// EL/wbits caps bound the table at (16640/8)*2^8*130 < 2^27 words.
int fsdkr_comb_table_words(int L, int EL, int wbits) {
  u64 odd = 1;
  int W = comb_windows(L, EL, wbits, &odd);
  if (W < 0)
    return -1;
  return W * (1 << wbits) * L;
}

// Build the comb window table for one (base, modulus) into a
// caller-owned buffer of fsdkr_comb_table_words words: per window w the
// 2^wbits entries (base^((2^wbits)^w))^d in Montgomery form. The table
// derives ONLY from (base, modulus, geometry) — no exponent ever enters
// it — so callers may cache it across calls for PUBLIC bases/moduli
// (ring-Pedersen h1/h2/T); secret-base callers must stay on the
// one-shot fsdkr_modexp_shared_w, which wipes the table before free.
int fsdkr_comb_precompute(const u64 *base, const u64 *n, u64 *table, int L,
                          int EL, int wbits) {
  const int W = comb_windows(L, EL, wbits, n);
  if (W < 0)
    return -1;
  const int D = 1 << wbits;
  const u64 n0inv = mont_n0inv(n[0]);
  u64 one_m[MAXL], r2[MAXL];
  mont_constants(n, L, one_m, r2);

  u64 b[MAXL];
  std::memcpy(b, base, sizeof(u64) * L);
  while (cmp_limbs(b, n, L) >= 0)
    sub_limbs(b, b, n, L);

  auto T = [&](int w, int d) { return table + ((size_t)w * D + d) * L; };
  u64 pw[MAXL];  // base^((2^wbits)^w) in Montgomery form
  mont_mul(pw, b, r2, n, n0inv, L);
  for (int w = 0; w < W; w++) {
    std::memcpy(T(w, 0), one_m, sizeof(u64) * L);
    std::memcpy(T(w, 1), pw, sizeof(u64) * L);
    for (int d = 2; d < D; d++) {
      if (d % 2 == 0)
        mont_sqr(T(w, d), T(w, d / 2), n, n0inv, L);
      else
        mont_mul(T(w, d), T(w, d - 1), pw, n, n0inv, L);
    }
    if (w + 1 < W)  // pw <- pw^(2^wbits) = (pw^(2^(wbits-1)))^2
      mont_sqr(pw, T(w, D / 2), n, n0inv, L);
  }
  secure_wipe(b, L);
  secure_wipe(pw, L);
  secure_wipe(one_m, L);
  secure_wipe(r2, L);
  return 0;
}

// Run M rows against a prebuilt comb table (fsdkr_comb_precompute with
// the same geometry). Rows are independent and split across threads.
int fsdkr_comb_apply(const u64 *table, const u64 *exps, const u64 *n,
                     u64 *outs, int M, int L, int EL, int wbits) {
  const int W = comb_windows(L, EL, wbits, n);
  if (W < 0 || M <= 0)
    return -1;
  const int D = 1 << wbits;
  const u64 n0inv = mont_n0inv(n[0]);
  const u64 *one_m = table;  // T(0, 0) is the Montgomery one
  auto T = [&](int w, int d) { return table + ((size_t)w * D + d) * L; };
  const u64 mask = (u64)D - 1;
  parallel_rows(M, [&](int lo, int hi) {
    u64 acc[MAXL];
    u64 onev[MAXL];
    std::memset(onev, 0, sizeof(u64) * MAXL);
    onev[0] = 1;
    for (int m = lo; m < hi; m++) {
      const u64 *e = exps + (size_t)m * EL;
      std::memcpy(acc, one_m, sizeof(u64) * L);
      // one multiply per window unconditionally (d == 0 hits the one_m
      // entry): prover-side exponents are secret key shares and nonces,
      // and a zero-digit skip would make wall time a function of their
      // contents — the generic kernel is uniform per window for the
      // same reason
      for (int w = 0; w < W; w++) {
        int bit0 = w * wbits;  // windows may straddle a 64-bit limb
        u64 d = e[bit0 / 64] >> (bit0 % 64);
        if (bit0 % 64 + wbits > 64 && bit0 / 64 + 1 < EL)
          d |= e[bit0 / 64 + 1] << (64 - bit0 % 64);
        d &= mask;
        mont_mul(acc, acc, T(w, (int)d), n, n0inv, L);
      }
      mont_mul(outs + (size_t)m * L, acc, onev, n, n0inv, L);
    }
    secure_wipe(acc, MAXL);  // exponent-derived accumulator state
  });
  return 0;
}

int fsdkr_modexp_shared_w(const u64 *base, const u64 *exps, const u64 *n,
                          u64 *outs, int M, int L, int EL, int wbits) {
  const int W = comb_windows(L, EL, wbits, n);
  if (W < 0 || M <= 0)
    return -1;
  const int D = 1 << wbits;
  u64 *table = new (std::nothrow) u64[(size_t)W * D * L];
  if (!table)
    return -1;
  int rc = fsdkr_comb_precompute(base, n, table, L, EL, wbits);
  if (rc == 0)
    rc = fsdkr_comb_apply(table, exps, n, outs, M, L, EL, wbits);
  // same wipe discipline as the CRT legs: the table can reconstruct
  // base/modulus state (secret on prover-side uses of this one-shot)
  secure_wipe(table, W * D * L);
  delete[] table;
  return rc;
}

} // extern "C"
