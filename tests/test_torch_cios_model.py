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
- the lookahead formula against a ripple over random lanes.
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


def warp_mont_mul(x, y, n, k):
    """One warp's product x * y * 2^(-16K) mod n, step for step as
    `mont_mul<P>`; returns (result, largest accumulator seen)."""
    w_cnt, p = k // 2, words_per_lane(k)
    nprime = int(MontgomeryContext([n], k).n_prime32[0])  # the kernels' n'
    assert nprime == (-pow(n, -1, 1 << 32)) % (1 << 32)
    xw, yw, nw = (to_lanes(v, p) for v in (x, y, n))
    y_below = np.concatenate([[0], yw[:-1, p - 1]]).astype(np.uint64)
    n_below = np.concatenate([[0], nw[:-1, p - 1]]).astype(np.uint64)
    acc = np.zeros((LANES, p), np.uint64)
    top = np.zeros(LANES, np.uint64)
    peak = 0

    def mul_add(a, b, b_below):
        nonlocal top
        prod = np.uint64(a) * b  # exact: < 2^64
        lo, hi = prod & np.uint64(M32), prod >> np.uint64(32)
        below_hi = (np.uint64(a) * b_below) >> np.uint64(32)
        acc[:, 0] += lo[:, 0] + below_hi
        acc[:, 1:] += lo[:, 1:] + hi[:, :-1]
        top += hi[:, p - 1]

    for i in range(w_cnt):
        mul_add(int(xw[i // p, i % p]), yw, y_below)
        m = (int(acc[0, 0]) & M32) * nprime & M32  # lane 0, broadcast
        mul_add(m, nw, n_below)
        assert int(acc[0, 0]) & M32 == 0
        c0 = acc[0, 0] >> np.uint64(32)
        nxt = np.roll(acc[:, 0], -1)
        acc[:, :-1] = acc[:, 1:].copy()
        acc[:, p - 1] = nxt
        acc[LANES - 1, p - 1] = top[LANES - 1]
        top[:] = 0
        acc[0, 0] += c0
        peak = max(peak, int(acc.max()))

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
    return from_lanes(t if keep else d), peak


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
