// Native secp256k1 host core of the PyTorch port: the host's Feldman
// and PDL-u1 checks.
//
// A trimmed copy of the JAX package's csrc/fsdkr_ec.cpp, loaded from
// Python with ctypes (fsdkr_tpu_torch/native/ec.py). The reference's EC
// layer is curv's pure-Rust secp256k1 behind the Feldman checks
// (src/refresh_message.rs:177-188) and the PDL u1 equation
// (src/zk_pdl_with_slack.rs:124-127). The port's Python Jacobian points
// (fsdkr_tpu_torch/core/secp256k1.py) carry the semantics; this file is
// the same math in C++ for the host-routed checks, where interpreter
// overhead, not field math, is most of the cost. It exports the two
// entry points the port calls: the Horner batch and the two-term linear
// combination batch.
//
// Variable-time arithmetic, matching the Python points it replaces:
// used on verification-side inputs, which are public broadcast values.
//
// ABI: plain C. Field elements are 4 little-endian u64 limbs; affine
// points are (x, y) limb pairs; (0, 0) encodes the identity (it is not
// on the curve).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = __uint128_t;

namespace {

// Row parallelism (same contract as fsdkr_native.cpp): batch rows are
// independent point equations writing disjoint output slots, so a
// chunked row split is bit-identical to the serial loop at any thread
// count. The shared-inversion batch_to_affine pass stays serial: it is
// one field inversion plus ~5 muls per row, noise next to the per-row
// scalar ladders. Duplicated from fsdkr_native.cpp rather than shared
// through a header: the loader builds and hash-tags exactly one source
// file per core (native/_loader.py), so an #include'd header would not
// enter the library's tag and an edit to it would load a stale build.
std::atomic<int> g_threads{1};

template <class F>
void parallel_rows(int rows, const F &fn) {
  int nt = g_threads.load(std::memory_order_relaxed);
  if (nt > rows) nt = rows;
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
      fn(lo, hi);
    else
      ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
    lo = hi;
  }
  for (auto &t : ts) t.join();
}

// p = 2^256 - 0x1000003D1
const u64 PRIME[4] = {0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                      0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL};
const u64 RED = 0x1000003D1ULL;  // 2^256 mod p

struct fe {
  u64 v[4];
};

inline bool fe_is_zero(const fe &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

inline int fe_cmp(const fe &a, const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] < b[i]) return -1;
    if (a.v[i] > b[i]) return 1;
  }
  return 0;
}

// a -= p (caller guarantees a >= p, or a virtual 2^256 carry)
inline void fe_sub_p(fe &a) {
  u128 d = (u128)a.v[0] - PRIME[0];
  a.v[0] = (u64)d;
  u64 borrow = (d >> 64) ? 1 : 0;
  for (int i = 1; i < 4; ++i) {
    d = (u128)a.v[i] - PRIME[i] - borrow;
    a.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

inline void fe_add(fe &r, const fe &a, const fe &b) {
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a.v[i] + b.v[i];
    r.v[i] = (u64)c;
    c >>= 64;
  }
  if (c || fe_cmp(r, PRIME) >= 0) fe_sub_p(r);
}

inline void fe_sub(fe &r, const fe &a, const fe &b) {
  u128 d = 0;
  u64 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    d = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {  // r += p
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
      c += (u128)r.v[i] + PRIME[i];
      r.v[i] = (u64)c;
      c >>= 64;
    }
  }
}

inline void fe_reduce512(fe &out, const u64 t[8]) {
  // fold hi*2^256 == hi*RED, twice, then one conditional subtract
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)t[i] + (u128)t[i + 4] * RED;
    out.v[i] = (u64)c;
    c >>= 64;
  }
  while (c) {  // c <= ~2^34 after first fold; at most 2 rounds
    u128 d = (u128)out.v[0] + c * RED;
    out.v[0] = (u64)d;
    d >>= 64;
    for (int i = 1; i < 4; ++i) {
      d += out.v[i];
      out.v[i] = (u64)d;
      d >>= 64;
    }
    c = d;
  }
  if (fe_cmp(out, PRIME) >= 0) fe_sub_p(out);
}

inline void fe_mul(fe &r, const fe &a, const fe &b) {
  u64 t[8] = {0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      carry += (u128)a.v[i] * b.v[j] + t[i + j];
      t[i + j] = (u64)carry;
      carry >>= 64;
    }
    t[i + 4] = (u64)carry;
  }
  fe_reduce512(r, t);
}

inline void fe_sqr(fe &r, const fe &a) { fe_mul(r, a, a); }

void fe_inv(fe &r, const fe &a) {
  // Fermat: a^(p-2). Rarely called (once per output batch).
  u64 e[4] = {PRIME[0] - 2, PRIME[1], PRIME[2], PRIME[3]};
  fe acc{{1, 0, 0, 0}};
  fe base = a;
  for (int limb = 0; limb < 4; ++limb)
    for (int bit = 0; bit < 64; ++bit) {
      if ((e[limb] >> bit) & 1) fe_mul(acc, acc, base);
      fe_sqr(base, base);
    }
  r = acc;
}

struct jac {
  fe X, Y, Z;  // Z == 0 -> identity
};

inline bool jac_is_inf(const jac &p) { return fe_is_zero(p.Z); }

inline void jac_set_inf(jac &p) { std::memset(&p, 0, sizeof(p)); }

inline void jac_from_affine(jac &p, const fe &x, const fe &y) {
  p.X = x;
  p.Y = y;
  p.Z = fe{{1, 0, 0, 0}};
}

// dbl-2009-l (a = 0)
void jac_dbl(jac &r, const jac &p) {
  if (jac_is_inf(p) || fe_is_zero(p.Y)) {
    jac_set_inf(r);
    return;
  }
  fe A, B, C, D, E, F, t;
  fe_sqr(A, p.X);
  fe_sqr(B, p.Y);
  fe_sqr(C, B);
  fe_add(t, p.X, B);
  fe_sqr(t, t);
  fe_sub(t, t, A);
  fe_sub(t, t, C);
  fe_add(D, t, t);
  fe_add(E, A, A);
  fe_add(E, E, A);
  fe_sqr(F, E);
  fe X3, Y3, Z3;
  fe_sub(X3, F, D);
  fe_sub(X3, X3, D);
  fe_sub(t, D, X3);
  fe_mul(Y3, E, t);
  fe C8;
  fe_add(C8, C, C);
  fe_add(C8, C8, C8);
  fe_add(C8, C8, C8);
  fe_sub(Y3, Y3, C8);
  fe_mul(Z3, p.Y, p.Z);
  fe_add(Z3, Z3, Z3);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// add-2007-bl (general jac + jac)
void jac_add(jac &r, const jac &p, const jac &q) {
  if (jac_is_inf(p)) {
    r = q;
    return;
  }
  if (jac_is_inf(q)) {
    r = p;
    return;
  }
  fe Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  fe_sqr(Z1Z1, p.Z);
  fe_sqr(Z2Z2, q.Z);
  fe_mul(U1, p.X, Z2Z2);
  fe_mul(U2, q.X, Z1Z1);
  fe_mul(t, q.Z, Z2Z2);
  fe_mul(S1, p.Y, t);
  fe_mul(t, p.Z, Z1Z1);
  fe_mul(S2, q.Y, t);
  if (fe_cmp(U1, U2.v) == 0) {
    if (fe_cmp(S1, S2.v) != 0) {
      jac_set_inf(r);
      return;
    }
    jac_dbl(r, p);
    return;
  }
  fe H, I, J, rr, V;
  fe_sub(H, U2, U1);
  fe_add(I, H, H);
  fe_sqr(I, I);
  fe_mul(J, H, I);
  fe_sub(rr, S2, S1);
  fe_add(rr, rr, rr);
  fe_mul(V, U1, I);
  fe X3, Y3, Z3;
  fe_sqr(X3, rr);
  fe_sub(X3, X3, J);
  fe_sub(X3, X3, V);
  fe_sub(X3, X3, V);
  fe_sub(t, V, X3);
  fe_mul(Y3, rr, t);
  fe_mul(t, S1, J);
  fe_add(t, t, t);
  fe_sub(Y3, Y3, t);
  fe_add(Z3, p.Z, q.Z);
  fe_sqr(Z3, Z3);
  fe_sub(Z3, Z3, Z1Z1);
  fe_sub(Z3, Z3, Z2Z2);
  fe_mul(Z3, Z3, H);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// madd-2007-bl (jac + affine), affine not identity
void jac_madd(jac &r, const jac &p, const fe &qx, const fe &qy) {
  if (jac_is_inf(p)) {
    jac_from_affine(r, qx, qy);
    return;
  }
  fe Z1Z1, U2, S2, t;
  fe_sqr(Z1Z1, p.Z);
  fe_mul(U2, qx, Z1Z1);
  fe_mul(t, p.Z, Z1Z1);
  fe_mul(S2, qy, t);
  if (fe_cmp(p.X, U2.v) == 0) {
    if (fe_cmp(p.Y, S2.v) != 0) {
      jac_set_inf(r);
      return;
    }
    jac_dbl(r, p);
    return;
  }
  fe H, HH, I, J, rr, V;
  fe_sub(H, U2, p.X);
  fe_sqr(HH, H);
  fe_add(I, HH, HH);
  fe_add(I, I, I);
  fe_mul(J, H, I);
  fe_sub(rr, S2, p.Y);
  fe_add(rr, rr, rr);
  fe_mul(V, p.X, I);
  fe X3, Y3, Z3;
  fe_sqr(X3, rr);
  fe_sub(X3, X3, J);
  fe_sub(X3, X3, V);
  fe_sub(X3, X3, V);
  fe_sub(t, V, X3);
  fe_mul(Y3, rr, t);
  fe_mul(t, p.Y, J);
  fe_add(t, t, t);
  fe_sub(Y3, Y3, t);
  fe_add(Z3, p.Z, H);
  fe_sqr(Z3, Z3);
  fe_sub(Z3, Z3, Z1Z1);
  fe_sub(Z3, Z3, HH);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// r = k * p for a small scalar (double-and-add over k's bits)
void jac_mul_small(jac &r, const jac &p, u32 k) {
  if (k == 0 || jac_is_inf(p)) {
    jac_set_inf(r);
    return;
  }
  int top = 31;
  while (!((k >> top) & 1)) --top;
  jac acc = p;
  for (int i = top - 1; i >= 0; --i) {
    jac_dbl(acc, acc);
    if ((k >> i) & 1) jac_add(acc, acc, p);
  }
  r = acc;
}

// r = scalar (4 limbs LE) * affine point, 4-bit fixed window
void jac_mul(jac &r, const fe &px, const fe &py, const u64 s[4]) {
  bool zero = (s[0] | s[1] | s[2] | s[3]) == 0;
  if (zero) {
    jac_set_inf(r);
    return;
  }
  jac tbl[16];
  jac_set_inf(tbl[0]);
  jac_from_affine(tbl[1], px, py);
  for (int i = 2; i < 16; ++i) jac_madd(tbl[i], tbl[i - 1], px, py);
  jac acc;
  jac_set_inf(acc);
  for (int w = 63; w >= 0; --w) {
    int limb = w / 16;
    int shift = (w % 16) * 4;
    unsigned d = (unsigned)((s[limb] >> shift) & 0xF);
    if (!jac_is_inf(acc)) {
      jac_dbl(acc, acc);
      jac_dbl(acc, acc);
      jac_dbl(acc, acc);
      jac_dbl(acc, acc);
    }
    if (d) jac_add(acc, acc, tbl[d]);
  }
  r = acc;
}

// Batch Jacobian -> affine with one shared inversion (Montgomery trick).
// out: (x, y) pairs; identity -> (0, 0).
void batch_to_affine(const jac *pts, int n, u64 *out) {
  fe *prefix = new fe[n];
  fe acc{{1, 0, 0, 0}};
  for (int i = 0; i < n; ++i) {
    prefix[i] = acc;
    if (!jac_is_inf(pts[i])) fe_mul(acc, acc, pts[i].Z);
  }
  fe inv;
  fe_inv(inv, acc);
  for (int i = n - 1; i >= 0; --i) {
    u64 *o = out + (size_t)i * 8;
    if (jac_is_inf(pts[i])) {
      std::memset(o, 0, 64);
      continue;
    }
    fe zinv;
    fe_mul(zinv, inv, prefix[i]);
    fe_mul(inv, inv, pts[i].Z);
    fe zi2, zi3, x, y;
    fe_sqr(zi2, zinv);
    fe_mul(zi3, zi2, zinv);
    fe_mul(x, pts[i].X, zi2);
    fe_mul(y, pts[i].Y, zi3);
    std::memcpy(o, x.v, 32);
    std::memcpy(o + 4, y.v, 32);
  }
  delete[] prefix;
}

inline void load_fe(fe &r, const u64 *p) { std::memcpy(r.v, p, 32); }

inline bool load_affine_jac(jac &r, const u64 *p) {
  // returns false for the (0,0) identity encoding
  fe x, y;
  load_fe(x, p);
  load_fe(y, p + 4);
  if (fe_is_zero(x) && fe_is_zero(y)) {
    jac_set_inf(r);
    return false;
  }
  jac_from_affine(r, x, y);
  return true;
}

}  // namespace

extern "C" {

// Thread-count control (0 = every core). Returns the applied count.
int fsdkr_ec_set_threads(int n) {
  if (n <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n = hc ? (int)hc : 1;
  }
  g_threads.store(n, std::memory_order_relaxed);
  return n;
}

// out[j] = sum_k A_k * idx[j]^k, Horner over the shared commitment
// vector (t1 affine points, A_0 first). The Feldman check's exact
// evaluation order (core/vss.py validate_share_public).
int fsdkr_ec_horner_batch(const u64 *commits, int t1, const u32 *idxs,
                          int m, u64 *out) {
  if (t1 <= 0 || m <= 0) return 1;
  jac *res = new jac[m];
  parallel_rows(m, [&](int lo, int hi) {
    for (int j = lo; j < hi; ++j) {
      jac acc;
      load_affine_jac(acc, commits + (size_t)(t1 - 1) * 8);
      for (int k = t1 - 2; k >= 0; --k) {
        jac t;
        jac_mul_small(t, acc, idxs[j]);
        const u64 *ak = commits + (size_t)k * 8;
        fe x, y;
        load_fe(x, ak);
        load_fe(y, ak + 4);
        if (fe_is_zero(x) && fe_is_zero(y)) {
          acc = t;  // identity commitment: acc*idx + 0
        } else {
          jac_madd(acc, t, x, y);
        }
      }
      res[j] = acc;
    }
  });
  batch_to_affine(res, m, out);
  delete[] res;
  return 0;
}

// out[i] = a[i]*P[i] + b[i]*Q[i] — the PDL u1 shape (s1*G + (q-e)*Q)
int fsdkr_ec_lincomb2_batch(const u64 *P, const u64 *a, const u64 *Q,
                            const u64 *b, int n, u64 *out) {
  if (n <= 0) return 1;
  jac *res = new jac[n];
  parallel_rows(n, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      jac pa, qb;
      fe x, y;
      load_fe(x, P + (size_t)i * 8);
      load_fe(y, P + (size_t)i * 8 + 4);
      if (fe_is_zero(x) && fe_is_zero(y))
        jac_set_inf(pa);
      else
        jac_mul(pa, x, y, a + (size_t)i * 4);
      load_fe(x, Q + (size_t)i * 8);
      load_fe(y, Q + (size_t)i * 8 + 4);
      if (fe_is_zero(x) && fe_is_zero(y))
        jac_set_inf(qb);
      else
        jac_mul(qb, x, y, b + (size_t)i * 4);
      jac_add(res[i], pa, qb);
    }
  });
  batch_to_affine(res, n, out);
  delete[] res;
  return 0;
}

}  // extern "C"
