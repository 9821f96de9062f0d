"""A CPU model of the ladder's block product (csrc/cios_kernels.cu,
`mont_mul_block`, under `cios_comb_ladder_kernel`).

The kernel runs only on the card. This model replays, in numpy and
Python integers, what one block does for one group, thread by thread:

- the column sums of each of the three products (T = x * y, the digit
  m = (T mod R) * n_inv mod R, and m * n) as the threads split them:
  column pair c holds columns c and c + W, in S parts (a power of two)
  of I source words (whole chunks of 8), part s taking i = s + S*u for
  u < I; the word of y is y_((c - i) mod W), into column c where i <= c
  and column c + W otherwise, read from the operand's two halves (the
  words reaching the low columns, and the high ones, each beside zeros
  where the other half's words would be); each
  32x32 -> 64 product's low half into its column's lazy sum and its high
  half into the next column's; source words at or above W read zero
  padding; the parts' sums are added (by shuffles in the kernel);
- the normalisation of column values into words: each thread's
  positions take a column's low 32 bits and the column below's high
  bits, ripple with 1-bit carries, and the carries between threads come
  from the two-level ballot lookahead (each warp's bits, then the warps'
  bits);
- the digit, U = T + m * n and the conditional subtraction: V = U plus
  the two's complement of n * R over 2W + 2 words, normalised beside U
  by the same lookahead, whose carry out of word 2W + 1 says U >= n * R
  (and V then holds U - n * R).

It checks the lazy sums' bound on worst-case inputs, the product bit for
bit against Python integers and the port's plain product
(`ops.montgomery.mont_mul_limbs`) at every threads-a-block the kernel
is built for, the two-level lookahead against a ripple carry, and a
16-window ladder on the model against `_comb_ladder` and CPython pow.
"""

import random

import numpy as np
import pytest
import torch

from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs, limbs_to_ints
from fsdkr_tpu_torch.ops.montgomery import _comb_ladder, mont_mul_limbs

M32 = (1 << 32) - 1
PAD = 256  # the kernel's kPad
CHUNK = 8  # the kernel's kChunk
THREADS = (256, 512)  # the kernel's layouts (launch_comb_ladder)


def ladder_parts(w, threads):
    """The kernel's S (parts a column pair: the largest power of two at
    most threads / W, W and 32) and I (source words a part, whole
    chunks)."""
    s = 1
    while 2 * s <= 32 and 2 * s <= w and 2 * s * w <= threads:
        s *= 2
    return s, -(-(-(-w // s)) // CHUNK) * CHUNK


def words(value, count):
    return [(value >> (32 * j)) & M32 for j in range(count)]


def value(ws):
    return sum(int(v) << (32 * j) for j, v in enumerate(ws))


def column_sums(x, yl, yh, w, threads):
    """`column_sums<kLow, NT>`: x is the left operand's buffer (read at
    i < S*I), yl and yh the right one split (read at PAD + W + c - i; yh
    None for kLow). Every product is taken against both halves, the other
    half's zeros dropping it, as the kernel does in a chunk across the
    diagonal. Returns the parts' lazy sums lo, hi, each (S, 2W + 1)
    uint64 (the kernel adds the parts by shuffles before it writes one
    row of each)."""
    s_cnt, i_cnt = ladder_parts(w, threads)
    assert s_cnt * i_cnt - 1 < len(x)  # the source words a part reads
    item = np.arange(w * s_cnt)
    s, c = item // w, item % w
    xa = np.asarray(x, np.uint64)
    halves = [np.asarray(b, np.uint64) for b in (yl, yh) if b is not None]
    sums = [[np.zeros(w * s_cnt, np.uint64) for _ in range(2)] for _ in halves]
    for u in range(i_cnt):
        i = s + s_cnt * u
        k = PAD + w + c - i
        for ya, (s_lo, s_hi) in zip(halves, sums):
            assert (k >= 0).all() and (k < len(ya)).all()
            p = xa[i] * ya[k]  # below 2^64
            s_lo += p & np.uint64(M32)
            s_hi += p >> np.uint64(32)
    cols = 2 * w + 1
    lo, hi = np.zeros((s_cnt, cols), np.uint64), np.zeros((s_cnt, cols), np.uint64)
    lo[s, c], hi[s, c + 1] = sums[0]
    if len(sums) == 2:
        lo[s, c + w], hi[s, c + w + 1] = sums[1]
    return lo, hi


def lookahead(g, q, cin=0):
    """The ballot lookahead over up to 32 lanes: each lane's carry in, and
    the carry out of the last, from generate bits g and propagate bits q
    (never both)."""
    assert not any(a and b for a, b in zip(g, q))
    G = sum(1 << l for l, b in enumerate(g) if b)
    Q = sum(1 << l for l, b in enumerate(q) if b)
    s = (G | Q) + G + cin
    return [((s ^ Q) >> l) & 1 for l in range(len(g))], (s >> len(g)) & 1


def block_lookahead(g, q):
    """`block_lookahead<NT, NL>`: each warp's lookahead with no carry in,
    the warps' (generate, propagate) bits through shared memory, one more
    lookahead over them, then each warp's with its carry in."""
    warps = len(g) // 32
    gen, prop = [], []
    for wi in range(warps):
        gw, qw = g[32 * wi : 32 * wi + 32], q[32 * wi : 32 * wi + 32]
        gen.append(lookahead(gw, qw)[1] == 1)
        prop.append(all(qw))
    cw, out = lookahead(gen, prop)
    cin = []
    for wi in range(warps):
        cin += lookahead(g[32 * wi : 32 * wi + 32], q[32 * wi : 32 * wi + 32], cw[wi])[0]
    return cin, out


def normalize(v, threads):
    """`normalize<NT, QMAX, NL>` of column values v_0 .. v_(N-1): the N + 1
    words of their sum (word N the carry out), and the lookahead's carry
    out of word N - 1 (word N's own position stays out of the generate
    and propagate bits)."""
    n = len(v)
    positions = n + 1
    q = -(-positions // threads)
    u = [((v[j] & M32) if j < n else 0) + ((v[j - 1] >> 32) if j else 0)
         for j in range(positions)]
    out = [0] * positions
    g, p = [False] * threads, [True] * threads
    for t in range(threads):
        c, ones = 0, True
        for j in range(t * q, min(t * q + q, positions)):
            s = u[j] + c
            out[j] = s & M32
            if j < n:
                c = s >> 32
                assert c <= 1  # a 1-bit carry from the first position on
                ones = ones and out[j] == M32
        g[t], p[t] = c == 1, ones
    cin, carry_out = block_lookahead(g, p)
    for t in range(threads):
        c = cin[t]
        for j in range(t * q, min(t * q + q, positions)):
            s = out[j] + c
            out[j], c = s & M32, s >> 32
        # the top position never carries out (a thread past it passes the
        # carry out of word N - 1 on)
        assert c == 0 or t * q + q < positions or t * q >= positions
    return out, carry_out


def column_values(lo, hi, extra=None, count=None):
    v = [int(a) + int(b) for a, b in zip(lo.sum(0, dtype=object), hi.sum(0, dtype=object))]
    if extra is not None:
        v = [a + b for a, b in zip(v, extra)]
    return v[:count] if count else v


def split(ws):
    """An operand as the kernel's yl and yh hold it: after PAD zero words,
    yl has W zeros and then the words (the low columns' words, i <= c),
    yh the words and then W zeros (the high columns')."""
    w = len(ws)
    return [0] * (PAD + w) + list(ws), [0] * PAD + list(ws) + [0] * w


def block_mont_mul(x, y, n, k, threads, stats=None):
    """x * y * 2^(-16K) mod n (x, y < n, n odd), step for step as
    `mont_mul_block<NT>`; `stats` collects the largest column value."""
    w = k // 2
    r = 1 << (32 * w)
    n_inv = (-pow(n, -1, r)) % r
    n_words = words(n, w)
    xs = words(x, w) + [0] * PAD
    nl = [0] * (PAD + w) + words(n_inv, w)
    peak = 0

    # T = x * y: 2W + 1 columns
    lo, hi = column_sums(xs, *split(words(y, w)), w, threads)
    v = column_values(lo, hi)
    peak = max(peak, max(v))
    t_words = normalize(v, threads)[0][: 2 * w + 1]
    assert value(t_words) == x * y
    # m = T_lo * n_inv mod R: the kernel reads T's own words above W, which
    # meet nl's zeros
    lo, hi = column_sums(t_words + [0] * PAD, nl, None, w, threads)
    v = column_values(lo, hi, count=w)
    peak = max(peak, max(v))
    m = normalize(v, threads)[0][:w]
    assert value(m) == (x * y % r) * n_inv % r
    # U = T + m * n: words W .. 2W
    lo, hi = column_sums(m + [0] * PAD, *split(n_words), w, threads)
    v = column_values(lo, hi, extra=t_words) + [0]  # 2W + 2 columns
    comp = [0] * w + [(~a) & M32 for a in n_words] + [M32, M32]
    comp[w] += 1  # n is odd: no carry out of word W
    v2 = [a + b for a, b in zip(v, comp)]
    peak = max(peak, max(v), max(v2))
    u_words, _ = normalize(v, threads)
    v_words, take = normalize(v2, threads)
    u_val = x * y + value(m) * n
    assert value(u_words) == u_val
    assert not any(u_words[:w]) and u_words[2 * w] <= 1 and u_words[2 * w + 1] == 0
    assert take == (u_val >= n << (32 * w))
    if take:
        assert value(v_words[: 2 * w + 2]) == u_val - (n << (32 * w))
    out = value((v_words if take else u_words)[w : 2 * w])
    if stats is not None:
        stats["peak"] = max(stats.get("peak", 0), peak)
    return out


def _plain(x, y, n, k):
    ctx = MontgomeryContext([n], k)
    out = mont_mul_limbs(*(torch.as_tensor(np.asarray(a, np.int64)) for a in (
        ints_to_limbs([x], k), ints_to_limbs([y], k), ctx.n, ctx.n_inv)))
    return limbs_to_ints(out.numpy())[0]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", [128, 130, 256, 512, 1022, 1024])
def test_block_column_sums_stay_below_their_bound(k, threads):
    """Worst case (n = R - 1, x = y = n - 1): a column value gathers at
    most W low halves and W high halves below 2^32 (and, in U, a word of
    T; in V, also a word of the two's complement of n R), so every value
    stays below W * 2^33 + 2^33 < 2^44 at W <= 512, and its high part, the
    local carry, below 2^12."""
    w = k // 2
    n = (1 << (16 * k)) - 1
    stats = {}
    got = block_mont_mul(n - 1, n - 1, n, k, threads, stats)
    assert stats["peak"] < w * (1 << 33) + (1 << 33) < 1 << 44
    assert stats["peak"] >> 32 < 1 << 12
    assert got == (n - 1) * (n - 1) * pow(1 << (16 * k), -1, n) % n


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", [2, 16, 64, 128, 130, 256, 512, 1022, 1024])
def test_block_model_matches_plain_product(k, threads):
    """K=2 (one word) and 16 leave most threads idle, 130 (W=65), 1022
    (W=511) and odd W split the column pairs into unequal parts, 1024
    gives each thread several positions; random, worst-case (x = y = n - 1, and an all-ones
    modulus), a modulus of 3 and a zero operand, each as a general
    product and a square."""
    rng = random.Random(10 * k + threads)
    n = rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
    top = (1 << (16 * k)) - 1
    cases = [(rng.randrange(n), rng.randrange(n), n), (n - 1, n - 1, n), (2, 2, 3),
             (1, 0, n), (top - 1, top - 1, top), (rng.randrange(top), top - 1, top)]
    for x, y, m in cases:
        for a, b in ((x, y), (y, y)):
            got = block_mont_mul(a, b, m, k, threads)
            assert got == a * b * pow(1 << (16 * k), -1, m) % m
            assert got == _plain(a, b, m, k)


def test_block_lookahead_matches_ripple():
    """The two-level lookahead against a ripple carry over 8 and 16
    warps: random generate / propagate bits, all propagating, and all
    propagating but a generate at the bottom."""
    rng = random.Random(12)
    for threads in THREADS:
        cases = []
        for _ in range(200):
            g = [rng.random() < 0.2 for _ in range(threads)]
            dense = rng.random() < 0.5
            cases.append((g, [not a and rng.random() < (0.97 if dense else 0.5) for a in g]))
        cases.append(([False] * threads, [True] * threads))
        cases.append(([True] + [False] * (threads - 1), [False] + [True] * (threads - 1)))
        for g, q in cases:
            cin, out = block_lookahead(g, q)
            c = 0
            for t in range(threads):
                assert cin[t] == c
                c = int(g[t] or (q[t] and c))
            assert out == c


@pytest.mark.parametrize("threads", THREADS)
def test_normalize_matches_integer_sum(threads):
    """Normalisation against Python integers on random column values,
    on columns whose words come out all ones (carries through the whole
    block), and up to 1025 columns (several positions a thread)."""
    rng = random.Random(threads)
    for count in (3, 129, 130, 257, 287, 288, 1025):
        cases = [[rng.getrandbits(42) for _ in range(count)],
                 [M32] * count,
                 [M32 + (1 << 32)] + [M32] * (count - 1),
                 [(M32 << 32) + M32 if j == 0 else M32 for j in range(count)]]
        cases[3][0] = (1 << 43) - 1
        for v in cases:
            got, carry_out = normalize(v, threads)
            total = sum(c << (32 * j) for j, c in enumerate(v))
            assert value(got) == total
            # the 1-bit carry out of the last column's word: the total's
            # bits from 32 * count up, less the last column's local carry
            assert carry_out == (total >> (32 * count)) - (v[-1] >> 32)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", [16, 128])
def test_ladder_on_the_block_model_matches_comb_ladder(k, threads):
    """A 16-window ladder (the entry by r2, then per window the power and
    four squarings) on the model against the plain `_comb_ladder` and
    CPython pow, over groups with a random, a worst-case and a
    modulus-3 base."""
    w_cnt = 16
    rng = random.Random(k)
    r = 1 << (16 * k)
    moduli = [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)), r - 1, 3]
    bases = [rng.randrange(moduli[0]), moduli[1] - 1, 2]
    ctx = MontgomeryContext(moduli, k)
    want = _comb_ladder(*(torch.as_tensor(np.asarray(a, np.int64)) for a in (
        ints_to_limbs(bases, k), ctx.n, ctx.n_inv, ctx.r2)), w_cnt)
    for g, (base, n) in enumerate(zip(bases, moduli)):
        p = block_mont_mul(base, r * r % n, n, k, threads)
        for wi in range(w_cnt):
            assert p == pow(base, 16 ** wi, n) * r % n
            assert p == limbs_to_ints(want[wi, g : g + 1].numpy())[0]
            if wi + 1 < w_cnt:
                for _ in range(4):
                    p = block_mont_mul(p, p, n, k, threads)
