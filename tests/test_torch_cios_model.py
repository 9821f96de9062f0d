"""A CPU model of the CIOS kernels' word layout (csrc/cios_kernels.cu).

The kernels run only on the card. This model replays, in numpy, what one
warp does for one row, lane by lane: 32-bit words at j = lane * P + s,
the low and high halves of each 32x32-bit product into words j and j+1,
m from lane 0, the one-word shift, 64-bit lazy accumulators, the carry
resolution by a ballot carry-lookahead and the conditional subtraction
by the same lookahead over borrows. It checks:

- the lazy accumulators' bound (below (W+1) * 2^34 + 2^32 < 2^44, far
  inside 64 bits) at K = 128, 256 and 512 on worst-case rows, which is
  where the 8192-bit route's accumulator bound is proved;
- the model's product against the plain version (ops.montgomery.
  mont_mul_limbs) and against Python integers, bit for bit, at widths
  whose words fill the lanes, leave padding slots, or leave idle lanes;
- the lookahead formula against a ripple over random lanes;
- a two-word Montgomery digit, the design of a product that reduces two
  words a step: x taken two words at a time, m = (t mod 2^64) * n'64 mod
  2^64 with n'64 the low four limbs of n_inv, one 64-bit broadcast of m,
  a two-word shift, each lane's slots 0 and 1 completed from the previous
  lane's last two y and n words, and a last one-word step where W is odd:
  its accumulators' bound at K = 128, 256 and 512, and its product bit
  for bit against the plain version and Python integers at K = 128, 130
  (odd W), 256, 512 and 1024. No kernel uses it: built into `cios_modexp`
  and `cios_comb_ladder` and timed on the H100, it was 0.98-1.07x the
  one-word product's speed (PERF.md), below the 1.25x that would
  have kept it. These cases stay as the record of the design.
- the sub-warp product `mont_mul_rows<L, P>` (`cios_comb`, and
  `cios_mont_mul` at large launches): L lanes a row, P words a lane,
  32/L rows a warp, replayed for all the warp's rows at once. x_i and m
  by shuffles of width L; each lane's products x_i * y_t and m * n_t,
  a word's four halves (the low ones of word t, the high ones of word
  t - 1) summed into its 64-bit lazy accumulator, the lane's top high
  halves into the word above it; the shift keeps each slot-0
  accumulator's high part in its lane (it joins the word above, now
  slot 0) and moves only its low 32 bits down one lane;
  the carry resolution and the conditional subtraction by the ballot
  lookahead on the row's L bits of the warp's ballot. Its accumulators'
  bound at K = 128, 256 and 512, its product bit for bit against the
  plain version and Python integers at K = 16, 128, 130, 256, 512 and
  1024 for L = 8, 16 and 32, and the comb's row tiles (a block never
  spans two groups; every row is covered once).
"""

import random

import numpy as np
import pytest
import torch

from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs, limbs_to_ints
from fsdkr_tpu_torch.ops.montgomery import mont_mul_limbs

M32 = (1 << 32) - 1
LANES = 32


def words_per_lane(k):
    """The kernels' P: a power of two with 32P >= K/2."""
    p = 1
    while LANES * p < k // 2:
        p *= 2
    return p


def to_lanes(value, p):
    """A number's 32-bit words as the warp holds them: (32, P), word
    lane * P + s at [lane, s]."""
    return np.array([(value >> (32 * j)) & M32 for j in range(LANES * p)],
                    dtype=np.uint64).reshape(LANES, p)


def from_lanes(words):
    return sum(int(w) << (32 * j) for j, w in enumerate(words.reshape(-1)))


def lookahead(g, q):
    """The kernels' `lookahead`: per-lane carry in and the carry out of
    lane 31, from generate bits g and propagate bits q (never both)."""
    G = sum(1 << l for l in range(LANES) if g[l])
    Q = sum(1 << l for l in range(LANES) if q[l])
    assert not G & Q
    s = (G | Q) + G
    c = (s & M32) ^ Q
    return [(c >> l) & 1 for l in range(LANES)], s >> 32


def _lanes_below(words, s):
    """Each lane's copy of the previous lane's word slot s (0 in lane 0):
    the kernel's shuffle up by one lane."""
    return np.concatenate([[0], words[:-1, s]]).astype(np.uint64)


def warp_mont_mul(x, y, n, k):
    """One warp's product x * y * 2^(-16K) mod n, step for step as
    `mont_mul<P>`; returns (result, largest accumulator seen)."""
    w_cnt, p = k // 2, words_per_lane(k)
    nprime = int(MontgomeryContext([n], k).n_prime32[0])  # the kernels' n'
    assert nprime == (-pow(n, -1, 1 << 32)) % (1 << 32)
    xw, yw, nw = (to_lanes(v, p) for v in (x, y, n))
    y_below = _lanes_below(yw, p - 1)
    n_below = _lanes_below(nw, p - 1)
    acc = np.zeros((LANES, p), np.uint64)
    top = np.zeros(LANES, np.uint64)
    peak = 0
    for i in range(w_cnt):
        _one_word_step(acc, top, int(xw[i // p, i % p]), yw, y_below, nw, n_below, nprime)
        peak = max(peak, int(acc.max()))
    return _resolve(acc, nw, x, y, n, k), peak


def _mul_add(acc, top, a, b, b_below):
    """acc += a * b over the lanes' words (`mul_add<P>`); top collects the
    high half of each lane's last word."""
    p = acc.shape[1]
    prod = np.uint64(a) * b  # exact: < 2^64
    lo, hi = prod & np.uint64(M32), prod >> np.uint64(32)
    below_hi = (np.uint64(a) * b_below) >> np.uint64(32)
    acc[:, 0] += lo[:, 0] + below_hi
    acc[:, 1:] += lo[:, 1:] + hi[:, :-1]
    top += hi[:, p - 1]


def _one_word_step(acc, top, xi, yw, y_below, nw, n_below, nprime):
    """t += x_i * y; m = t_0 * n' mod 2^32; t += m * n; t >>= 32."""
    p = acc.shape[1]
    _mul_add(acc, top, xi, yw, y_below)
    m = (int(acc[0, 0]) & M32) * (nprime & M32) & M32  # lane 0, broadcast
    _mul_add(acc, top, m, nw, n_below)
    assert int(acc[0, 0]) & M32 == 0
    c0 = acc[0, 0] >> np.uint64(32)
    nxt = np.roll(acc[:, 0], -1)
    acc[:, :-1] = acc[:, 1:].copy()
    acc[:, p - 1] = nxt
    acc[LANES - 1, p - 1] = top[LANES - 1]
    top[:] = 0
    acc[0, 0] += c0


def _resolve(acc, nw, x, y, n, k):
    """The carry resolution and conditional subtraction after the steps:
    the canonical product."""
    p = acc.shape[1]
    # carry resolution: ripple in each lane, hand the multi-bit carry to
    # the next lane, ripple again, then the 1-bit lookahead
    t = np.zeros((LANES, p), np.uint64)
    carry = [0] * LANES
    for lane in range(LANES):
        c = 0
        for s in range(p):
            v = int(acc[lane, s]) + c
            t[lane, s], c = v & M32, v >> 32
        carry[lane] = c
    t_top = carry[LANES - 1]
    g, all_ones = [0] * LANES, [False] * LANES
    for lane in range(LANES):
        c = carry[lane - 1] if lane else 0
        for s in range(p):
            v = int(t[lane, s]) + c
            t[lane, s], c = v & M32, v >> 32
        g[lane] = c
        all_ones[lane] = all(int(w) == M32 for w in t[lane])
        assert c <= 1 and not (c and all_ones[lane])
    cin, out = lookahead(g, all_ones)
    t_top += out
    for lane in range(LANES):
        c = cin[lane]
        for s in range(p):
            v = int(t[lane, s]) + c
            t[lane, s], c = v & M32, v >> 32
    assert from_lanes(t) + (t_top << (32 * LANES * p)) == (x * y + n * (
        (-x * y * pow(n, -1, 1 << (16 * k))) % (1 << (16 * k)))) >> (16 * k)

    # d = t - n by the same lookahead over borrows; keep t where t < n
    d = np.zeros((LANES, p), np.uint64)
    bg, all_zero = [0] * LANES, [False] * LANES
    for lane in range(LANES):
        b = 0
        for s in range(p):
            v = int(t[lane, s]) - int(nw[lane, s]) - b
            d[lane, s], b = v & M32, int(v < 0)
        bg[lane] = b
        all_zero[lane] = not d[lane].any()
    bin_, borrow_out = lookahead(bg, all_zero)
    for lane in range(LANES):
        b = bin_[lane]
        for s in range(p):
            v = int(d[lane, s]) - b
            d[lane, s], b = v & M32, int(v < 0)
    keep = t_top < borrow_out
    return from_lanes(t if keep else d)


def _mul_add2(acc, top0, top1, a0, a1, b, b1, b2):
    """acc += (a0 + a1 * 2^32) * b over the lanes' words:
    word j gains lo(a0 b_j) + hi(a0 b_(j-1)) + lo(a1 b_(j-1)) + hi(a1
    b_(j-2)), with b_(j-1), b_(j-2) below a lane's first word the previous
    lane's last two (b1, b2); top0 and top1 collect the two words above
    each lane's last (only lane 31's are words of the number)."""
    p = acc.shape[1]
    m32 = np.uint64(M32)
    sh = np.uint64(32)
    b_m1 = np.concatenate([b1[:, None], b[:, :-1]], axis=1)  # b_(j-1)
    b_m2 = np.concatenate([b2[:, None], b1[:, None], b[:, :-2]], axis=1)[:, :p]  # b_(j-2)
    a0, a1 = np.uint64(a0), np.uint64(a1)
    acc += ((a0 * b) & m32) + ((a0 * b_m1) >> sh) + ((a1 * b_m1) & m32) + ((a1 * b_m2) >> sh)
    top0 += ((a0 * b[:, p - 1]) >> sh) + ((a1 * b[:, p - 1]) & m32) + ((a1 * b[:, p - 2]) >> sh)
    top1 += (a1 * b[:, p - 1]) >> sh


def warp_mont_mul2(x, y, n, k):
    """One warp's product x * y * 2^(-16K) mod n with a two-word digit (P
    >= 2; not used by a kernel, see the module docstring): W // 2 two-word
    steps, then one one-word step where W is odd. Returns (result, largest
    accumulator seen)."""
    w_cnt, p = k // 2, words_per_lane(k)
    assert p >= 2, "at P=1 words 2i and 2i+1 sit in different lanes"
    # n'64: the low four limbs of n_inv = -n^(-1) mod R, as the kernels read it
    nprime = limbs_to_ints(MontgomeryContext([n], k).n_inv[:, :4])[0]
    assert nprime == (-pow(n, -1, 1 << 64)) % (1 << 64)
    xw, yw, nw = (to_lanes(v, p) for v in (x, y, n))
    y_b1, y_b2 = _lanes_below(yw, p - 1), _lanes_below(yw, p - 2)
    n_b1, n_b2 = _lanes_below(nw, p - 1), _lanes_below(nw, p - 2)
    acc = np.zeros((LANES, p), np.uint64)
    top0 = np.zeros(LANES, np.uint64)
    top1 = np.zeros(LANES, np.uint64)
    peak = 0
    for i in range(0, w_cnt - 1, 2):
        # words 2i and 2i+1 of x sit in one lane (P even): two shuffles
        x0, x1 = int(xw[i // p, i % p]), int(xw[i // p, i % p + 1])
        _mul_add2(acc, top0, top1, x0, x1, yw, y_b1, y_b2)
        t = (int(acc[0, 0]) + (int(acc[0, 1]) << 32)) % (1 << 64)  # lane 0
        m = t * nprime % (1 << 64)  # one 64-bit broadcast
        _mul_add2(acc, top0, top1, m & M32, m >> 32, nw, n_b1, n_b2)
        assert (int(acc[0, 0]) + (int(acc[0, 1]) << 32)) % (1 << 64) == 0
        c = ((int(acc[0, 0]) >> 32) + int(acc[0, 1])) >> 32
        nxt0, nxt1 = np.roll(acc[:, 0], -1), np.roll(acc[:, 1], -1)
        acc[:, :-2] = acc[:, 2:].copy()
        acc[:, p - 2], acc[:, p - 1] = nxt0, nxt1
        acc[LANES - 1, p - 2], acc[LANES - 1, p - 1] = top0[LANES - 1], top1[LANES - 1]
        top0[:] = 0
        top1[:] = 0
        acc[0, 0] += np.uint64(c)
        peak = max(peak, int(acc.max()))
    if w_cnt % 2:
        i = w_cnt - 1
        _one_word_step(acc, top0, int(xw[i // p, i % p]), yw, y_b1, nw, n_b1, nprime)
        peak = max(peak, int(acc.max()))
    return _resolve(acc, nw, x, y, n, k), peak


def _plain(x, y, n, k):
    ctx = MontgomeryContext([n], k)
    out = mont_mul_limbs(*(torch.as_tensor(np.asarray(a, np.int64)) for a in (
        ints_to_limbs([x], k), ints_to_limbs([y], k), ctx.n, ctx.n_inv)))
    return limbs_to_ints(out.numpy())[0]


@pytest.mark.parametrize("k", [128, 256, 512])
def test_lazy_accumulators_stay_below_their_bound(k):
    """Worst case for the accumulators: every word of x, y and n at its
    largest (n = R - 1, x = y = n - 1)."""
    n = (1 << (16 * k)) - 1
    got, peak = warp_mont_mul(n - 1, n - 1, n, k)
    w_cnt = k // 2
    assert peak < (w_cnt + 1) * (1 << 34) + (1 << 32) < 1 << 44
    assert got == (n - 1) * (n - 1) * pow(1 << (16 * k), -1, n) % n
    assert got == _plain(n - 1, n - 1, n, k)


@pytest.mark.parametrize("k", [2, 16, 96, 128, 130, 256, 512])
def test_model_matches_plain_product(k):
    """K=2 and 16 leave lanes idle, 96 and 130 leave padding slots in the
    last lanes, 128, 256 and 512 fill every lane; rows at n-1, random,
    and a modulus of 3."""
    rng = random.Random(k)
    n = rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
    rows = [(n - 1, n - 1, n), (rng.randrange(n), rng.randrange(n), n),
            (2, 2, 3), (1, 0, n)]
    for x, y, m in rows:
        r_inv = pow(1 << (16 * k), -1, m)
        got, _ = warp_mont_mul(x, y, m, k)
        assert got == x * y * r_inv % m
        assert got == _plain(x, y, m, k)


def test_lookahead_matches_ripple():
    rng = random.Random(7)
    for _ in range(500):
        g = [rng.random() < 0.3 for _ in range(LANES)]
        q = [not a and rng.random() < 0.6 for a in g]
        cin, out = lookahead(g, q)
        c = 0
        for lane in range(LANES):
            assert cin[lane] == c
            c = int(g[lane] or (q[lane] and c))
        assert out == c


@pytest.mark.parametrize("k", [128, 256, 512])
def test_two_word_accumulators_stay_below_their_bound(k):
    """The two-word step's worst case: a word gains at most eight terms
    below 2^32 a step and lives at most (W + 1) / 2 + 1 steps, word 0 also
    the carry c < 2^32, so every accumulator stays below (W + 3) * 2^34 +
    2^32 < 2^44 at W <= 512."""
    n = (1 << (16 * k)) - 1
    got, peak = warp_mont_mul2(n - 1, n - 1, n, k)
    w_cnt = k // 2
    assert peak < (w_cnt + 3) * (1 << 34) + (1 << 32) < 1 << 44
    assert got == (n - 1) * (n - 1) * pow(1 << (16 * k), -1, n) % n
    assert got == _plain(n - 1, n - 1, n, k)


@pytest.mark.parametrize("k", [128, 130, 256, 512, 1024])
def test_two_word_model_matches_plain_product(k):
    """128, 256, 512 and 1024 fill every lane (P = 2, 4, 8, 16); 130 (W =
    65, P = 4) leaves padding slots and ends in a one-word step; rows at
    n-1, random, a modulus of 3 and an all-ones modulus."""
    rng = random.Random(k + 1)
    n = rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
    top = (1 << (16 * k)) - 1
    rows = [(n - 1, n - 1, n), (rng.randrange(n), rng.randrange(n), n),
            (2, 2, 3), (1, 0, n), (top - 1, rng.randrange(top), top)]
    for x, y, m in rows:
        r_inv = pow(1 << (16 * k), -1, m)
        got, _ = warp_mont_mul2(x, y, m, k)
        assert got == x * y * r_inv % m
        assert got == _plain(x, y, m, k)
        assert got == warp_mont_mul(x, y, m, k)[0]


# ---------------------------------------------------------------------------
# the sub-warp product: L lanes a row, 32/L rows a warp


def rows_words_per_lane(k, lanes):
    """`mont_mul_rows`'s P: a power of two with L * P >= K/2."""
    p = 1
    while lanes * p < k // 2:
        p *= 2
    return p


def _products(a, b):
    """Each lane's products a * b_s (`mont_mul_rows`' IMAD.WIDE): a (R,)
    one word per row, b (R, L, P). Returns their (low, high) halves."""
    v = a[:, None, None] * b  # < 2^64: no wrap
    return v & np.uint64(M32), v >> np.uint64(32)


def _row_lookahead(g, q, lanes):
    """The sub-warp `lookahead`: one 32-bit ballot of g and q over the
    warp, each row taking its L bits (shifted down by its first lane).
    g, q: (R, L) bools. Returns (carry in (R, L), carry out of each
    row's last lane (R,))."""
    rows = LANES // lanes
    G = sum(1 << l for l in range(LANES) if g[l // lanes, l % lanes])
    Q = sum(1 << l for l in range(LANES) if q[l // lanes, l % lanes])
    assert not G & Q
    mask = (1 << lanes) - 1
    cin = np.zeros((rows, lanes), np.uint64)
    out = np.zeros(rows, np.uint64)
    for r in range(rows):
        gr, qr = (G >> (r * lanes)) & mask, (Q >> (r * lanes)) & mask
        s = (gr | qr) + gr
        out[r] = (s >> lanes) & 1
        for l in range(lanes):
            cin[r, l] = ((s ^ qr) >> l) & 1
    return cin, out


def _resolve_rows(acc, nw, lanes):
    """`mont_mul_rows`' carry resolution and conditional subtraction on
    every row of the warp: ripple each lane's words, hand each lane's
    multi-bit carry to the next lane of its row (the last lane's is the
    row's top word), ripple again, the 1-bit carries by the row
    lookahead; then t - n by the same lookahead over borrows, keeping t
    where t < n. Returns each row's canonical value."""
    rows, _, p = acc.shape
    m32, sh = np.uint64(M32), np.uint64(32)
    t = np.zeros(acc.shape, np.uint64)
    c = np.zeros((rows, lanes), np.uint64)
    for s in range(p):
        v = acc[:, :, s] + c  # < 2^45: no wrap
        t[:, :, s], c = v & m32, v >> sh
    t_top = c[:, lanes - 1].copy()
    cin = np.concatenate([np.zeros((rows, 1), np.uint64), c[:, :-1]], axis=1)
    all_ones = np.ones((rows, lanes), bool)
    for s in range(p):
        v = t[:, :, s] + cin
        t[:, :, s], cin = v & m32, v >> sh
        all_ones &= t[:, :, s] == m32
    assert (cin <= 1).all() and not (cin.astype(bool) & all_ones).any()
    c1, out = _row_lookahead(cin.astype(bool), all_ones, lanes)
    t_top += out
    for s in range(p):
        v = t[:, :, s] + c1
        t[:, :, s], c1 = v & m32, v >> sh
    d = np.zeros(acc.shape, np.int64)
    b = np.zeros((rows, lanes), np.int64)
    all_zero = np.ones((rows, lanes), bool)
    for s in range(p):
        v = t[:, :, s].astype(np.int64) - nw[:, :, s].astype(np.int64) - b
        d[:, :, s], b = v & M32, (v < 0).astype(np.int64)
        all_zero &= d[:, :, s] == 0
    b1, borrow_out = _row_lookahead(b.astype(bool), all_zero, lanes)
    b1 = b1.astype(np.int64)
    for s in range(p):
        v = d[:, :, s] - b1
        d[:, :, s], b1 = v & M32, (v < 0).astype(np.int64)
    keep = t_top < borrow_out  # t < n
    return [from_lanes(t[r] if keep[r] else d[r].astype(np.uint64)) for r in range(rows)]


def rows_mont_mul(x, y, n, k, lanes):
    """32/L rows' products x_r * y_r * 2^(-16K) mod n_r at once, step for
    step as `mont_mul_rows<L, P>`: L lanes a row, P words a lane (word j
    of a row at lane j // P, slot j % P; words at or above W zero).
    Returns (results, largest accumulator seen)."""
    rows = LANES // lanes
    assert len(x) == len(y) == len(n) == rows
    w_cnt, p = k // 2, rows_words_per_lane(k, lanes)

    def words(v):
        return np.array([(v >> (32 * j)) & M32 for j in range(lanes * p)],
                        dtype=np.uint64).reshape(lanes, p)

    xw, yw, nw = (np.stack([words(v) for v in vals]) for vals in (x, y, n))
    nprime = np.array([(-pow(m, -1, 1 << 32)) % (1 << 32) for m in n], np.uint64)
    assert (nprime == MontgomeryContext(list(n), k).n_prime32.astype(np.uint64)).all()
    m32, sh = np.uint64(M32), np.uint64(32)
    acc = np.zeros((rows, lanes, p), np.uint64)
    peak = 0
    for i in range(w_cnt):
        xi = xw[:, i // p, i % p]  # shuffle of width L from lane i // P
        pl, ph = _products(xi, yw)
        # m from each row's lane 0, shuffled to its row
        m = ((acc[:, 0, 0] & m32) + pl[:, 0, 0]) * nprime & m32
        ql, qh = _products(m, nw)
        # low halves join word s, high halves word s + 1
        acc += pl + ql
        acc[:, :, 1:] += ph[:, :, :-1] + qh[:, :, :-1]
        e = ph[:, :, p - 1] + qh[:, :, p - 1]  # into the word above the lane
        peak = max(peak, int(acc.max()))
        assert not (acc[:, 0, 0] & m32).any()  # word 0 of every row is 0 mod 2^32
        c0 = acc[:, :, 0] >> sh  # stays in its lane: the word above, slot 0 next
        below = np.zeros((rows, lanes), np.uint64)  # shuffle down of width L
        below[:, :-1] = acc[:, 1:, 0] & m32  # the row's last lane takes 0
        acc[:, :, :-1] = acc[:, :, 1:].copy()
        acc[:, :, p - 1] = e + below
        acc[:, :, 0] += c0
    out = _resolve_rows(acc, nw, lanes)
    R = 1 << (16 * k)
    for r in range(rows):
        assert out[r] == x[r] * y[r] * pow(R, -1, n[r]) % n[r]
    return out, peak


@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("k", [128, 256, 512])
def test_rows_accumulators_stay_below_their_bound(k, lanes):
    """Worst case (n = R - 1, x = y = n - 1 in every row): a word gains
    four halves below 2^32 a step, plus the high part of the word below
    at the shift, and lives at most W + 1 steps, so every accumulator
    stays below (W + 1) * 2^34 + 2^32 < 2^44 at W <= 512."""
    n = (1 << (16 * k)) - 1
    rows = LANES // lanes
    got, peak = rows_mont_mul([n - 1] * rows, [n - 1] * rows, [n] * rows, k, lanes)
    w_cnt = k // 2
    assert peak < (w_cnt + 1) * (1 << 34) + (1 << 32) < 1 << 44
    assert got == [(n - 1) * (n - 1) * pow(1 << (16 * k), -1, n) % n] * rows
    assert got[0] == _plain(n - 1, n - 1, n, k)


@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("k", [16, 128, 130, 256, 512, 1024])
def test_rows_model_matches_plain_product(k, lanes):
    """The warp's 32/L rows hold different moduli: n-1 rows, random rows,
    a modulus of 3, a zero operand and an all-ones modulus. K=16 leaves
    lanes idle at L=32, K=130 (W=65) padding words; every row against
    the plain version and Python integers."""
    rng = random.Random(1000 * k + lanes)
    rows = LANES // lanes
    top = (1 << (16 * k)) - 1
    pool = []
    while len(pool) < max(rows, 5):
        n = rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
        pool += [(n - 1, n - 1, n), (rng.randrange(n), rng.randrange(n), n)]
    cases = [(2, 2, 3), (1, 0, pool[1][2]), (top - 1, rng.randrange(top), top)] + pool
    for at in range(0, len(cases), rows):
        chunk = cases[at:at + rows]
        chunk += pool[:rows - len(chunk)]
        x, y, n = (list(v) for v in zip(*chunk))
        got, _ = rows_mont_mul(x, y, n, k, lanes)
        for r in range(rows):
            assert got[r] == x[r] * y[r] * pow(1 << (16 * k), -1, n[r]) % n[r]
        assert got[0] == _plain(x[0], y[0], n[0], k)
        if k <= 512:
            assert got[0] == warp_mont_mul(x[0], y[0], n[0], k)[0]


def comb_block_rows(block, per_group, rows_per_block):
    """`cios_comb`'s row tile of one block: (group, rows of that group it
    holds, how many of its row slots are masked). Blocks are numbered
    group by group, ceil(per_group / rows_per_block) tiles a group; a
    ragged last tile masks its slots past per_group."""
    tiles = -(-per_group // rows_per_block)
    g, tile = divmod(block, tiles)
    first = tile * rows_per_block
    rows = [first + r for r in range(rows_per_block) if first + r < per_group]
    return g, rows, rows_per_block - len(rows)


@pytest.mark.parametrize("per_group", [1, 13, 256, 257])
def test_comb_row_tiles_cover_each_row_once(per_group):
    """At every launch rule's rows a block (4 warps of 32/L rows), over 3
    groups: each block's rows lie in one group, and the blocks cover
    every (group, row) exactly once."""
    groups = 3
    for lanes in (8, 16, 32):
        rows_per_block = 4 * (LANES // lanes)
        blocks = groups * -(-per_group // rows_per_block)
        seen = []
        for b in range(blocks):
            g, rows, masked = comb_block_rows(b, per_group, rows_per_block)
            assert 0 <= g < groups and rows and masked < rows_per_block
            seen += [(g, m) for m in rows]
        assert sorted(seen) == [(g, m) for g in range(groups) for m in range(per_group)]
