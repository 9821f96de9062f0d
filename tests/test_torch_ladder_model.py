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

It also replays the joint kernels' row body (`joint_row<NT, kPublic>`,
under `cios_multi_modexp_kernel` and `cios_shared_exp_kernel`) on the
model: the general product with the other operand written into the
split yl / yh at the kernel's indices, the table build (entry 1 the base
by r2, each next one a product by entry 1), the masked select over all
16 entries (the Straus kernel's secret digits) and the addressed one
(the shared exponent's public digits), the chain's start at the
Montgomery one and the exit by a product with 1; a Straus chain and a
shared-exponent chain against the plain versions (`_multi_modexp_kernel`,
`_shared_exp_kernel`) and CPython pow.
"""

import random

import numpy as np
import pytest
import torch

from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs, limbs_to_ints
from fsdkr_tpu_torch.ops.montgomery import (_comb_ladder, _multi_modexp_kernel,
                                            _shared_exp_kernel, exp_digits, mont_mul_limbs)

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


def column_sums(x, yl, yh, w, threads, square=False):
    """`column_sums<kLow, NT>`: x is the left operand's buffer (read at
    i < S*I), yl and yh the right one split (read at PAD + W + c - i; yh
    None for kLow). Every product is taken against both halves, the other
    half's zeros dropping it, as the kernel does in a chunk across the
    diagonal. Returns the parts' lazy sums lo, hi, each (S, 2W + 1)
    uint64 (the kernel adds the parts by shuffles before it writes one
    row of each).

    The kernel runs the low half as a loop over a prefix of the chunks
    and the high half as one over a suffix from a first chunk it finds by
    a shift: checked here against the chunks each half's columns take.

    square (y = x): as the kernel decides per warp (pw = 32 / S column
    pairs, c_min .. c_max) and chunk (source words i_lo .. i_hi): the low
    half is read where 2 i_lo < c_max, each word masked to 0 unless 2i <
    c (no mask where 2 i_hi < c_min), the high half where 2 i_hi > c_min +
    W, masked unless 2i > c + W (none where 2 i_lo > c_max + W); a chunk
    read by neither half is skipped (checked: no lane's column takes a
    word of it). The part-0 rows then hold each sum doubled plus the
    diagonal's halves x_(j/2)^2 of each even column j."""
    s_cnt, i_cnt = ladder_parts(w, threads)
    assert s_cnt * i_cnt - 1 < len(x)  # the source words a part reads
    item = np.arange(w * s_cnt)
    s, c = item // w, item % w
    pw = 32 // s_cnt
    c_min = c // pw * pw
    c_max = np.minimum(c_min + pw - 1, w - 1)
    xa = np.asarray(x, np.uint64)
    halves = [np.asarray(b, np.uint64) for b in (yl, yh) if b is not None]
    sums = [[np.zeros(w * s_cnt, np.uint64) for _ in range(2)] for _ in halves]
    # the kernel's two loops: the low half over a prefix of chunks (while
    # some lane's column c takes a word), the high half over a suffix from
    # its first chunk, found by a shift from the warp's first pair
    log2s, log2chunk = s_cnt.bit_length() - 1, CHUNK.bit_length() - 1
    first = ((c_min + w + 2) >> (log2s + log2chunk + 1) if square
             else (c_min + 1) >> (log2s + log2chunk))
    for j in range(-(-i_cnt // CHUNK)):
        i_lo, i_hi = s_cnt * CHUNK * j, s_cnt * CHUNK * (j + 1) - 1
        low = 2 * i_lo < c_max if square else i_lo <= c_max
        high = 2 * i_hi > c_min + w if square else i_hi > c_min
        assert (high == (j >= first)).all()  # the high loop's start
        if j:  # the low loop stops at its first chunk no lane takes
            prev = 2 * (i_lo - s_cnt * CHUNK) < c_max if square else i_lo - s_cnt * CHUNK <= c_max
            assert not (low & ~prev).any()
    for u in range(i_cnt):
        i = s + s_cnt * u
        k = PAD + w + c - i
        if square:
            i_lo, i_hi = s_cnt * (u // CHUNK * CHUNK), s_cnt * (u // CHUNK * CHUNK + CHUNK) - 1
            sq_lo, sq_hi = 2 * i_lo < c_max, 2 * i_hi > c_min + w
            keep = [sq_lo & ((2 * i_hi < c_min) | (2 * i < c)),
                    sq_hi & ((2 * i_lo > c_max + w) | (2 * i > c + w))]
            assert not ((2 * i < c) & ~sq_lo).any() and not ((2 * i > c + w) & ~sq_hi).any()
        for h, (ya, (s_lo, s_hi)) in enumerate(zip(halves, sums)):
            assert (k >= 0).all() and (k < len(ya)).all()
            p = xa[i] * ya[k]  # below 2^64
            if square:
                p = np.where(keep[h], p, np.uint64(0))
            s_lo += p & np.uint64(M32)
            s_hi += p >> np.uint64(32)
    cols = 2 * w + 1
    lo, hi = np.zeros((s_cnt, cols), np.uint64), np.zeros((s_cnt, cols), np.uint64)
    lo[s, c], hi[s, c + 1] = sums[0]
    if len(sums) == 2:
        lo[s, c + w], hi[s, c + w + 1] = sums[1]
    if square:
        lo, hi = 2 * lo, 2 * hi
        for j in range(0, 2 * w, 2):
            d = int(xa[j // 2]) ** 2
            lo[0, j] += np.uint64(d & M32)
            hi[0, j + 1] += np.uint64(d >> 32)
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


def block_mont_mul(x, y, n, k, threads, stats=None, square=False):
    """x * y * 2^(-16K) mod n (x, y < n, n odd), step for step as
    `mont_mul_block<NT>`; `stats` collects the largest column value;
    square (y = x): T's square column sums."""
    w = k // 2
    return block_product(words(x, w) + [0] * PAD, *split(words(y, w)), n, k, threads, stats,
                         square)


def block_product(xs, yl, yh, n, k, threads, stats=None, square=False):
    """`mont_mul_block<NT>` on the operands as the block holds them: x's
    words (then zero padding), y split in yl and yh (`split`); square:
    the kernel's square column sums of T (y = x)."""
    w = k // 2
    x, y = value(xs[:w]), value(yh[PAD : PAD + w])
    assert not square or x == y
    assert (list(yl), list(yh)) == tuple(split(yh[PAD : PAD + w]))
    r = 1 << (32 * w)
    n_inv = (-pow(n, -1, r)) % r
    n_words = words(n, w)
    nl = [0] * (PAD + w) + words(n_inv, w)
    peak = 0

    # T = x * y: 2W + 1 columns
    lo, hi = column_sums(xs, yl, yh, w, threads, square)
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
    for square in (False, True):  # the square's doubled sums and diagonal too
        stats = {}
        got = block_mont_mul(n - 1, n - 1, n, k, threads, stats, square)
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
        for a, b, square in ((x, y, False), (y, y, False), (y, y, True)):
            got = block_mont_mul(a, b, m, k, threads, square=square)
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


class JointBlock:
    """What a joint block holds in shared memory: x (the kernel keeps it
    permuted in xp; word j at slot j here), y split in yl and yh at the
    kernel's indices, and the tables (entry e of term t, word j at (16 t
    + e) W + j). `product` is `mont_mul_block`: its result goes to both
    operands."""

    def __init__(self, n, k, threads, terms):
        self.n, self.k, self.threads, self.w = n, k, threads, k // 2
        self.x = [0] * (self.w + PAD)
        self.yl, self.yh = [0] * (PAD + 2 * self.w), [0] * (PAD + 2 * self.w)
        self.tables = [0] * (terms * 16 * self.w)

    def put_x(self, j, v):
        self.x[j] = v

    def put_y(self, j, v):  # the kernel's sm.yh[kPad + j] = sm.yl[kPad + W + j]
        self.yh[PAD + j] = self.yl[PAD + self.w + j] = v

    def y_words(self):
        return self.yh[PAD : PAD + self.w]

    def product(self, square=False):
        r = block_product(self.x, self.yl, self.yh, self.n, self.k, self.threads, square=square)
        for j, v in enumerate(words(r, self.w)):
            self.put_x(j, v)
            self.put_y(j, v)
        return r


def joint_row(block, bases, r2, one, windows, active, digit, public, trace=None):
    """`joint_row<NT, kPublic>` for one row, step for step: the tables
    (term t's entry 1 = base_t by r2, entries 2..15 each a product by
    entry 1, entry 0 the Montgomery one), then per window four squarings
    (on the square's column sums, the operands left in place by the
    product before) and one product per active term by its digit's entry
    (kPublic: read at the digit's address; else the masked sum over all
    16), then the exit by a product with 1. `trace` collects (kind, product) of every
    step. Returns the row's result."""
    w, terms = block.w, len(bases)
    table_steps = 15 * terms
    wi = q = 0
    act = active(0) if windows else 0
    step = 0
    while True:
        last = step >= table_steps and wi == windows
        t, e = step // 15, step % 15 + 1
        square = step >= table_steps and not last and q < 4
        select = step >= table_steps and not last and q >= 4
        d = digit(q - 4, wi) if select else 0
        base = 16 * (q - 4) * w if select else 0
        # a square finds its operands in place, but for the chain's first
        for j in range(w) if not square or step == table_steps else ():
            y = 0
            if step < table_steps:
                if e == 1:
                    block.put_x(j, words(bases[t], w)[j])
                    y = words(r2, w)[j]
                else:
                    y = block.tables[(16 * t + 1) * w + j]
            else:
                if step == table_steps:  # the accumulator starts at the one
                    y = words(one, w)[j]
                    block.put_x(j, y)
                if last:
                    y = 1 if j == 0 else 0
                elif select:
                    if public:
                        y = block.tables[base + d * w + j]
                    else:
                        for en in range(16):
                            y |= block.tables[base + en * w + j] & (M32 if d == en else 0)
            block.put_y(j, y)
        r = block.product(square)
        if trace is not None:
            kind = ("table" if step < table_steps else "exit" if last
                    else "select" if select else "square")
            trace.append((kind, r))
        if step < table_steps:
            for j in range(w):
                block.tables[(16 * t + e) * w + j] = block.y_words()[j]
                if e == 1:
                    block.tables[16 * t * w + j] = words(one, w)[j]
        elif last:
            return r
        else:
            q += 1
            if q == 4 + act:
                q, wi = 0, wi + 1
                if wi < windows:
                    act = active(wi)
        step += 1


JOINT_K = [16, 130, 256]


def _joint_modulus(rng, k):
    return rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", JOINT_K)
def test_joint_general_product_on_split_operand(k, threads):
    """A general product: x written word by word into the left operand,
    y into the split yl / yh at the kernel's indices; the result lands in
    both, so the next product is a square; then the selected entry of a
    16-entry table (masked over all 16, and addressed) as the next y."""
    rng = random.Random(k + threads)
    n = _joint_modulus(rng, k)
    r = 1 << (16 * k)
    w = k // 2
    block = JointBlock(n, k, threads, 1)
    x, y = rng.randrange(n), rng.randrange(n)
    for j in range(w):
        block.put_x(j, words(x, w)[j])
        block.put_y(j, words(y, w)[j])
    got = block.product()
    assert got == x * y * pow(r, -1, n) % n == _plain(x, y, n, k)
    assert value(block.x[:w]) == value(block.y_words()) == got
    assert block.product() == got * got * pow(r, -1, n) % n  # the square
    entries = [rng.randrange(n) for _ in range(16)]
    for e, v in enumerate(entries):
        block.tables[e * w : (e + 1) * w] = words(v, w)
    for d in range(16):
        masked = [0] * w
        for j in range(w):
            for en in range(16):
                masked[j] |= block.tables[en * w + j] & (M32 if d == en else 0)
        assert value(masked) == value(block.tables[d * w : (d + 1) * w]) == entries[d]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", JOINT_K)
def test_straus_row_on_the_block_model(k, threads):
    """A short Straus chain (T=3, widths (32, 16, 8), term 1's exponent 0)
    on the model against `_multi_modexp_kernel` and CPython pow; the
    tables, the entry by r2, the chain's start at the one and the exit
    checked on the way. The rows' bases: random, and n - 1."""
    rng = random.Random(3 * k + threads)
    r = 1 << (16 * k)
    widths = (32, 16, 8)
    windows = widths[0] // 4
    for worst in (False, True):
        n = r - 1 if worst else _joint_modulus(rng, k)
        bases = [n - 1 if worst else rng.randrange(n) for _ in widths]
        exps = [(1 << wb) - 1 if worst else rng.getrandbits(wb) for wb in widths]
        exps[1] = 0
        block = JointBlock(n, k, threads, len(widths))
        trace = []
        got = joint_row(
            block, bases, r * r % n, r % n, windows,
            lambda wi: sum(wb > 4 * (windows - 1 - wi) for wb in widths),
            lambda t, wi: (exps[t] >> (4 * (windows - 1 - wi))) & 15, False, trace)
        want = 1
        for b, e in zip(bases, exps):
            want = want * pow(b, e, n) % n
        assert got == want
        for t, b in enumerate(bases):
            for e in range(16):
                assert value(block.tables[(16 * t + e) * (k // 2) : (16 * t + e + 1) * (k // 2)]) \
                    == pow(b, e, n) * r % n
            assert trace[15 * t] == ("table", b * r % n)  # the entry by r2
        chain = trace[15 * len(widths):]
        assert chain[0] == ("square", 1 * r % n)  # the one's square is the one
        assert chain[-1] == ("exit", want)
        assert len(chain) == widths[0] + sum(widths) // 4 + 1
        ctx = MontgomeryContext([n], k)
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
        plain = _multi_modexp_kernel(
            t(np.stack([ints_to_limbs([b], k) for b in bases])),
            t(np.stack([ints_to_limbs([e], widths[0] // 16) for e in exps])),
            t(ctx.n), t(ctx.n_inv), t(ctx.r2), t(ctx.one_mont), exp_bits_seq=widths)
        assert limbs_to_ints(plain.numpy()) == [got]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", JOINT_K)
def test_shared_exp_row_on_the_block_model(k, threads):
    """A shared-exponent row (one table, 8 windows of a 32-bit public
    exponent, each entry read at the digit's address) on the model
    against `_shared_exp_kernel` and CPython pow, random and worst-case
    (n = R - 1, base n - 1, every digit 15); and a zero-window exponent
    (the exit straight after the table: 1 mod n)."""
    rng = random.Random(5 * k + threads)
    r = 1 << (16 * k)
    for worst in (False, True):
        n = r - 1 if worst else _joint_modulus(rng, k)
        base = n - 1 if worst else rng.randrange(n)
        e = (1 << 32) - 1 if worst else rng.getrandbits(32)
        digits = exp_digits(e, 32)
        block = JointBlock(n, k, threads, 1)
        got = joint_row(block, [base], r * r % n, r % n, len(digits), lambda wi: 1,
                        lambda t, wi: digits[wi], True)
        assert got == pow(base, e, n)
        ctx = MontgomeryContext([n], k)
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa: E731
        plain = _shared_exp_kernel(t(ints_to_limbs([base], k)), digits, t(ctx.n), t(ctx.n_inv),
                                   t(ctx.r2), t(ctx.one_mont))
        assert limbs_to_ints(plain.numpy()) == [got]
    n = _joint_modulus(rng, k)
    block = JointBlock(n, k, threads, 1)
    assert joint_row(block, [rng.randrange(n)], r * r % n, r % n, 0, lambda wi: 1,
                     lambda t, wi: 0, True) == 1
