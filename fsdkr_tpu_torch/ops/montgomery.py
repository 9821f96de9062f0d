"""Batched multi-modulus CIOS Montgomery arithmetic (the port of the JAX
package's `ops/montgomery.py`, cut to the generic engine, the fixed-base
comb, the joint (Straus) and shared-exponent modexp, the modmul and the
batched inverse).

Each batch row carries its own modulus. Numbers are base-2^16 limbs,
little-endian along the last axis, R = 2^(16 K). The engine's entry
points (`BatchModExp.modexp` / `.modmul`, `modexp_batches`,
`shared_base_modexp`, `multi_modexp`, `shared_exp_batches`,
`batch_mod_inv_grouped`) run
the hand-written Hopper kernels of `ops.montgomery_kernels` on a CUDA
device; on the CPU those wrappers run the plain versions of this module:

- `mont_mul_limbs`: x*y*R^{-1} mod n per row, canonical (< n for x, y <
  n). The JAX package computes it as a K-step CIOS loop with lazy
  carries; the plain version computes the same integer in a few
  whole-row steps, because a K-step loop of torch ops costs K launches
  per product (about 2,700 at K=128). CIOS's digits m_i are the base-2^16
  digits of M = -x*y*n^{-1} mod R, so here M comes from one truncated
  product with n_inv = -n^{-1} mod R, then (x*y + M*n)/R and the same
  conditional subtraction: bit-identical to the K-step loop for any x, y
  < R (held against it in tests/test_torch_montgomery.py). Each of the
  three products is one batched float64 product of 8-limb blocks.
- `_modexp_kernel`, `_shared_modexp_kernel` (the comb: `_comb_ladder`,
  `_comb_table`, `_comb_accumulate`), `_multi_modexp_kernel` (the joint
  Straus ladder), `_shared_exp_kernel` (one public exponent a batch),
  `_modmul_kernel`, `_modmul_exit_kernel` and the inverse tree follow the
  JAX package step for step (the Straus fold sequentially, where the JAX
  package folds four or more terms in a tree: the same integers).

Limbs are int64 in the plain versions (torch's CPU kernels have no
uint32 add or shift); int32 tensors of canonical 16-bit limbs cross the
kernel boundary. The kernels work in 32-bit words, so the engine rounds
an odd limb count up to even: R changes, and with it the in-domain
intermediates, never a value that leaves the engine.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import intops
from . import montgomery_kernels
from .limbs import (
    LIMB_BITS,
    LIMB_MASK,
    WINDOW_BITS,
    MontgomeryContext,
    bucket_exp_bits,
    ints_to_limbs,
    limbs_to_ints,
    to_device,
    wipe_array,
)

__all__ = [
    "mont_mul_limbs",
    "batch_modexp",
    "batch_modmul",
    "shared_base_modexp",
    "batch_mod_inv_grouped",
    "BatchModExp",
    "modexp_batches",
    "multi_modexp",
    "shared_exp_batches",
    "exp_digits",
]


# ---------------------------------------------------------------------------
# plain versions


def _carry_pass(t: torch.Tensor) -> None:
    """One pass of delayed carries (non-negative int64 limbs), in place:
    each limb keeps its low 16 bits and takes the high bits of the limb
    below; the top limb's carry out is dropped."""
    hi = t[:, :-1] >> LIMB_BITS
    t &= LIMB_MASK
    t[:, 1:].add_(hi)


def _normalize_carries(t: torch.Tensor) -> torch.Tensor:
    """Propagate pending carries to canonical base-2^16, in place; the
    top limb's carry out is dropped (on a slice of K limbs that is the
    reduction mod 2^(16K)). The limbs are non-negative and below 2^48
    (every sum of the engine stays below 2^44), so three passes leave
    every limb at most 2^16, with no data-dependent loop (nothing waits
    on the device). The 1-bit carries left may ripple through a run of
    0xFFFF limbs (as in t plus the complement of n, where t >= n); one
    carry-lookahead step resolves them: a limb takes a carry when the
    nearest limb below it that is not 0xFFFF is 2^16."""
    for _ in range(3):
        _carry_pass(t)
    gen = t > LIMB_MASK
    if not t.is_cuda and not bool(gen.any()):
        return t  # no carry left (a check that would wait on the card)
    idx = torch.arange(t.shape[1] - 1, device=t.device)
    last_gen = torch.where(gen[:, :-1], idx, -1).cummax(dim=1).values
    last_stop = torch.where(t[:, :-1] < LIMB_MASK, idx, -1).cummax(dim=1).values
    t[:, 1:].add_(last_gen > last_stop)
    t &= LIMB_MASK
    return t


def _cond_subtract(t: torch.Tensor, n_comp: torch.Tensor) -> torch.Tensor:
    """t - n if t >= n else t, as canonical (B, K) limbs; t: (B, K+2)
    delayed-carry limbs below 2^44 (value < 2n), n_comp: the complement
    of n (`_Reducer.n_comp`). t and t + n_comp are normalized together;
    the carry out of the latter, in limb K+1, is 1 exactly where t >= n.
    The choice is a masked select."""
    rows, k = t.shape[0], t.shape[1] - 2
    both = _normalize_carries(torch.cat([t, t + n_comp]))
    keep = (both[rows:, k + 1] == 0)[:, None]  # no carry out: t < n
    return torch.where(keep, both[:rows, :k], both[rows:, :k])


# limbs per block of the plain products' operands
_BLOCK = 8


@functools.lru_cache(maxsize=None)
def _block_layout(k: int, device: str):
    """For a K-limb operand split into nb blocks of b = _BLOCK limbs:
    (nb, the gather index of its block Toeplitz matrices, the output limb
    of each block product's entries). Toeplitz entry [I, q, j] is limb
    I*b + q - j of the operand when 0 <= q - j < b (a zero pad limb, at
    nb*b, otherwise); block product entry [I, q, J] lands on output limb
    b*(I + J) + q."""
    b = _BLOCK
    nb = -(-k // b)
    i = torch.arange(nb)[:, None, None]
    q = torch.arange(2 * b - 1)[None, :, None]
    d = q - torch.arange(b)[None, None, :]
    gather = torch.where((d >= 0) & (d < b), i * b + d, nb * b).reshape(-1)
    pos = (b * (i + torch.arange(nb)[None, None, :]) + q).reshape(-1)
    return nb, gather.to(device), pos.to(device)


def _toeplitz_blocks(v: torch.Tensor) -> torch.Tensor:
    """(B, K) limbs as (B, nb * (2b - 1), b) float64 matrices, one
    (2b - 1, b) Toeplitz matrix per block of b limbs (`_block_layout`)."""
    rows, k = v.shape
    nb, gather, _ = _block_layout(k, str(v.device))
    padded = torch.nn.functional.pad(v.to(torch.float64), (0, nb * _BLOCK + 1 - k))
    return padded.index_select(1, gather).view(rows, nb * (2 * _BLOCK - 1), _BLOCK)


def _block_product(toe: torch.Tensor, w: torch.Tensor, width: int) -> torch.Tensor:
    """sum over i + j = p of v_i * w_j for p < width (width <= 2K + 2),
    with v given as `_toeplitz_blocks(v)`: (B, width) int64 delayed-carry
    limbs. Every block of v times every block of w is one batched float64
    product, and the block products add into their output limbs, exactly:
    every sum stays below K * 2^33 < 2^53. O(K^2 / b) values per row,
    where a Toeplitz matrix of all of v would take O(K^2)."""
    rows, k = w.shape
    nb, _, pos = _block_layout(k, str(w.device))
    blocks = torch.nn.functional.pad(w.to(torch.float64), (0, nb * _BLOCK - k))
    prod = torch.bmm(toe, blocks.view(rows, nb, _BLOCK).transpose(1, 2))
    out = torch.zeros((rows, 2 * nb * _BLOCK + 2), dtype=torch.float64, device=w.device)
    out.index_add_(1, pos, prod.view(rows, -1))
    return out[:, :width].to(torch.int64)


class _Reducer:
    """A modulus row's constants for the plain product: n (B, K) int64;
    n and n_inv as block Toeplitz matrices (`_toeplitz_blocks`); and the
    complement of n in K+2 limbs, 2^(16(K+1)) - n, with delayed borrows
    (limb i is 0xFFFF - n_i, plus 1 at limb 0), for `_cond_subtract`.
    Built once per modulus vector and reused by every product of a
    modexp."""

    def __init__(self, n, n_inv):
        self.n = n.to(torch.int64)
        rows, k = self.n.shape
        self.n_toe = _toeplitz_blocks(self.n)
        self.n_inv_toe = _toeplitz_blocks(n_inv.to(torch.int64))
        self.n_comp = torch.zeros((rows, k + 2), dtype=torch.int64, device=self.n.device)
        self.n_comp[:, : k + 1] = LIMB_MASK
        self.n_comp[:, :k] -= self.n
        self.n_comp[:, 0] += 1

    def mont_mul(self, x, y):
        k = x.shape[1]
        # T = x*y in 2K+2 limbs (the top two 0), delayed carries
        t = _block_product(_toeplitz_blocks(x), y, 2 * k + 2)
        # T mod R with limbs below 2^17 (two passes, carries out of limb
        # K-1 dropped), then M = T * n_inv mod R, canonical
        low = t[:, :k].clone()
        _carry_pass(low)
        _carry_pass(low)
        m = _normalize_carries(_block_product(self.n_inv_toe, low, k))
        t += _block_product(self.n_toe, m, 2 * k + 2)
        # T + M*n < 2nR is a multiple of R: its low half is c*R, and c,
        # the carry into limb K, is read off the low half's top two limbs
        # (each limb is below K * 2^33 <= 2^42, so the limbs under them
        # add less than 2^-5 to (top * 2^16 + next) / 2^32, whose ceiling
        # is c)
        hi = t[:, k:]
        hi[:, 0] += ((t[:, k - 1] << LIMB_BITS) + t[:, k - 2] + (1 << 32) - 1) >> 32
        return _cond_subtract(hi, self.n_comp)


def mont_mul_limbs(x, y, n, n_inv) -> torch.Tensor:
    """Batched Montgomery product x*y*R^{-1} mod n, R = 2^(16K).

    x, y, n, n_inv: (B, K) canonical base-2^16 limbs (any integer dtype),
    x, y < n; n_inv = -n^{-1} mod R (`MontgomeryContext.n_inv`). Returns
    canonical (B, K) int64 limbs < n.
    """
    return _Reducer(n, n_inv).mont_mul(x, y)


def _replayed(mont_mul, rows: int, k: int, device):
    """`mont_mul` on (rows, K) limbs, captured once as a CUDA graph and
    replayed for each product. A plain product is about a hundred small
    launches, and on the card their host-side dispatch, not the device,
    bounds the plain modexp's time; the replay runs the same kernels on
    the same values (nothing in the product branches on them)."""
    x = torch.zeros((rows, k), dtype=torch.int64, device=device)
    y = torch.zeros_like(x)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        mont_mul(x, y)  # warm-up outside the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mont_mul(x, y)

    def replay(a, b):
        x.copy_(a)
        y.copy_(b)
        graph.replay()
        return out.clone()

    # the graph reads the constants that `mont_mul` holds: they must live
    # as long as it does
    replay.mont_mul = mont_mul
    return replay


def _modexp_kernel(base, exp, n, n_inv, r2, one_mont, *, exp_bits) -> torch.Tensor:
    """result = base^exp mod n, per row; exp: (B, EL) 16-bit limbs.

    Fixed-window exponentiation, MSB-first: per 4-bit window, 4
    Montgomery squarings and one branchless table multiply (the w=0 entry
    is the Montgomery one, so every window costs the same). exp_bits is a
    multiple of 4 (`bucket_exp_bits`), so a window never straddles a
    16-bit exponent limb."""
    assert exp_bits % WINDOW_BITS == 0
    exp = exp.to(torch.int64)
    one_mont = one_mont.to(torch.int64)
    mul = _plain_mul(n, n_inv, base.device)

    base_m = mul(base, r2)  # to Montgomery domain
    # table[j] = base_m^j (Montgomery domain), j = 0..15
    table = [one_mont, base_m]
    for _ in range(2, 1 << WINDOW_BITS):
        table.append(mul(table[-1], base_m))
    table = torch.stack(table)
    idx = torch.arange(1 << WINDOW_BITS, device=exp.device)[:, None, None]
    acc = one_mont
    for wi in range(exp_bits // WINDOW_BITS):
        shift = exp_bits - WINDOW_BITS * (wi + 1)
        w = (exp[:, shift // LIMB_BITS] >> (shift % LIMB_BITS)) & ((1 << WINDOW_BITS) - 1)
        for _ in range(WINDOW_BITS):
            acc = mul(acc, acc)
        # branchless table select: sum over the one-hot window match
        sel = (table * (w[None, :, None] == idx)).sum(dim=0)
        acc = mul(acc, sel)
    # leave Montgomery domain: multiply by 1
    one = torch.zeros_like(acc)
    one[:, 0] = 1
    return mul(acc, one)


def _window_table(base_m, one_mont, mul) -> torch.Tensor:
    """table[j] = base_m^j in the Montgomery domain, j = 0..15, (16, B, K):
    entry 0 the Montgomery one, each next entry one product more."""
    table = [one_mont, base_m]
    for _ in range(2, 1 << WINDOW_BITS):
        table.append(mul(table[-1], base_m))
    return torch.stack(table)


def _multi_modexp_kernel(bases, exps, n, n_inv, r2, one_mont, *,
                         exp_bits_seq) -> torch.Tensor:
    """Joint (Straus) multi-exponentiation: result[b] = prod_t
    bases[t, b]^exps[t, b] mod n[b].

    bases: (T, B, K); exps: (T, B, EL) 16-bit limbs; n, n_inv, r2,
    one_mont: (B, K). exp_bits_seq: each term's bucketed width, descending,
    each a multiple of 4. One 16-entry table per term; one shared chain of
    exp_bits_seq[0] / 4 windows, each four squarings and then one masked
    table product per active term: term t's digits fill the last
    exp_bits_seq[t] / 4 windows. The widths are launch shape, so the
    schedule does not depend on the data.

    The JAX package folds the selected entries of four or more terms in a
    log-depth tree (one XLA launch a level); each combine there adds one
    R^{-1}, as a sequential product does, and its padding is the
    Montgomery one, so this sequential fold gives the same canonical
    integers, and so does the kernel."""
    t_cnt = bases.shape[0]
    assert len(exp_bits_seq) == t_cnt and t_cnt >= 1
    assert all(eb % WINDOW_BITS == 0 and eb > 0 for eb in exp_bits_seq)
    assert list(exp_bits_seq) == sorted(exp_bits_seq, reverse=True)
    exps = exps.to(torch.int64)
    one_mont = one_mont.to(torch.int64)
    mul = _plain_mul(n, n_inv, bases.device)
    tables = [_window_table(mul(bases[t], r2), one_mont, mul) for t in range(t_cnt)]
    idx = torch.arange(1 << WINDOW_BITS, device=bases.device)[:, None, None]
    w_total = exp_bits_seq[0] // WINDOW_BITS
    starts = [w_total - eb // WINDOW_BITS for eb in exp_bits_seq]
    acc = one_mont
    for wi in range(w_total):
        for _ in range(WINDOW_BITS):
            acc = mul(acc, acc)
        for t in range(t_cnt):
            if wi < starts[t]:
                continue
            shift = exp_bits_seq[t] - WINDOW_BITS * (wi - starts[t] + 1)
            d = (exps[t, :, shift // LIMB_BITS] >> (shift % LIMB_BITS)) & ((1 << WINDOW_BITS) - 1)
            acc = mul(acc, (tables[t] * (d[None, :, None] == idx)).sum(dim=0))
    one = torch.zeros_like(acc)
    one[:, 0] = 1
    return mul(acc, one)


def exp_digits(exp: int, exp_bits: int) -> List[int]:
    """The 4-bit window digits of `exp` over `exp_bits` bits, most
    significant first."""
    return [(exp >> (exp_bits - WINDOW_BITS * (w + 1))) & ((1 << WINDOW_BITS) - 1)
            for w in range(exp_bits // WINDOW_BITS)]


def _shared_exp_kernel(base, digits, n, n_inv, r2, one_mont) -> torch.Tensor:
    """result[b] = base[b]^E mod n for ONE shared public exponent E, given
    as its 4-bit window digits, most significant first (`exp_digits`).
    base: (B, K); n, n_inv, r2, one_mont: (1, K), the segment's one
    modulus. Each window is four squarings and one product by the table
    entry the digit names: the digits derive from the receiver's public
    Paillier n, so the table is indexed by them directly."""
    rows = base.shape[0]
    n, n_inv, r2, one_mont = (t.expand(rows, -1).to(torch.int64)
                              for t in (n, n_inv, r2, one_mont))
    mul = _plain_mul(n.contiguous(), n_inv.contiguous(), base.device)
    table = _window_table(mul(base, r2), one_mont, mul)
    acc = one_mont
    for d in (digits.tolist() if isinstance(digits, torch.Tensor) else digits):
        for _ in range(WINDOW_BITS):
            acc = mul(acc, acc)
        acc = mul(acc, table[int(d)])
    one = torch.zeros_like(acc)
    one[:, 0] = 1
    return mul(acc, one)


def _modmul_kernel(a, b, n, n_inv, r2) -> torch.Tensor:
    """a*b mod n per row (via a*R * b * R^{-1})."""
    red = _Reducer(n, n_inv)
    return red.mont_mul(red.mont_mul(a, r2), b)


def _plain_mul(n, n_inv, device):
    """The plain product over fixed (rows, K) moduli; on the card replayed
    from a CUDA graph (`_replayed`)."""
    mul = _Reducer(n, n_inv).mont_mul
    return _replayed(mul, *n.shape, device) if n.is_cuda else mul


def _comb_ladder(base, n, n_inv, r2, w_cnt) -> torch.Tensor:
    """The comb's power ladder: powers[w] = base_m^(16^w), (W, G, K), in
    the Montgomery domain. base, n, n_inv, r2: (G, K). The entry by r2,
    then per window the power stored and four squarings (the JAX package
    squares once more after the last store; nothing reads that value)."""
    mul = _plain_mul(n, n_inv, base.device)
    p = mul(base, r2)
    powers = []
    for w in range(w_cnt):
        powers.append(p)
        if w + 1 < w_cnt:
            for _ in range(WINDOW_BITS):
                p = mul(p, p)
    return torch.stack(powers)


def _comb_table(powers, n, n_inv, one_mont, mul) -> torch.Tensor:
    """The comb's window tables: entry c of window w is powers[w]^c, (16,
    W, G, K), entry 0 the Montgomery one. Built over the flattened (W*G)
    rows in the JAX package's four levels {2}, {3,4}, {5..8}, {9..15},
    one batched product `mul(a, b, n, n_inv)` per level (the kernel
    wrapper on the engine's path, `mont_mul_limbs` in the plain
    version)."""
    w_cnt, g, k = powers.shape
    nf = n.repeat(w_cnt, 1)  # row w*G + g holds n[g]
    nif = n_inv.repeat(w_cnt, 1)
    p1 = powers.reshape(w_cnt * g, k)

    def mul_many(pairs):
        a = torch.cat([x for x, _ in pairs])
        b = torch.cat([y for _, y in pairs])
        out = mul(a, b, nf.repeat(len(pairs), 1), nif.repeat(len(pairs), 1))
        return list(out.split(w_cnt * g))

    (p2,) = mul_many([(p1, p1)])
    p3, p4 = mul_many([(p2, p1), (p2, p2)])
    p5, p6, p7, p8 = mul_many([(p4, p1), (p4, p2), (p4, p3), (p4, p4)])
    upper = mul_many([(p8, p) for p in (p1, p2, p3, p4, p5, p6, p7)])
    one_f = one_mont.repeat(w_cnt, 1).to(p2.dtype)
    entries = [one_f, p1.to(p2.dtype), p2, p3, p4, p5, p6, p7, p8, *upper]
    return torch.stack(entries).reshape(1 << WINDOW_BITS, w_cnt, g, k)


def _comb_accumulate(table, exp, n, n_inv, one_mont, *, exp_bits) -> torch.Tensor:
    """The comb's accumulation and exit: result[g, m] = prod over windows
    w of table[d_w, w, g] (d_w the row's 4-bit digit w, least significant
    first, as in the JAX package), leaving the Montgomery domain by a
    product with 1. table: (16, W, G, K); exp: (G, M, EL) 16-bit limbs;
    n, n_inv, one_mont: (G, K). Returns (G, M, K).

    The JAX package may tree-reduce chunks of windows (`_comb_tree_chunk`,
    its knobs FSDKR_COMB_TREE / FSDKR_COMB_TREE_BUDGET). That sets the
    depth of an XLA program, not the result: every Montgomery product is
    exact, so this sequential form (its C == 1 branch) gives the same
    canonical integers, and so does the kernel."""
    g, m, _ = exp.shape
    k = n.shape[1]
    exp = exp.to(torch.int64)
    mul = _plain_mul(n.repeat_interleave(m, dim=0), n_inv.repeat_interleave(m, dim=0),
                     exp.device)
    acc = one_mont.to(torch.int64).repeat_interleave(m, dim=0)
    idx = torch.arange(1 << WINDOW_BITS, device=exp.device)[:, None, None, None]
    for w in range(exp_bits // WINDOW_BITS):
        shift = WINDOW_BITS * w
        d = (exp[:, :, shift // LIMB_BITS] >> (shift % LIMB_BITS)) & ((1 << WINDOW_BITS) - 1)
        entries = table[:, w].to(torch.int64)  # (16, G, K)
        # branchless pick of entries[d[g, m], g] -> (G, M, K)
        sel = (entries[:, :, None, :] * (d[None, :, :, None] == idx)).sum(dim=0)
        acc = mul(acc, sel.reshape(g * m, k))
    one = torch.zeros_like(acc)
    one[:, 0] = 1
    return mul(acc, one).reshape(g, m, k)


def _shared_modexp_kernel(base, exp, n, n_inv, r2, one_mont, powers=None, *,
                          exp_bits) -> torch.Tensor:
    """result[g, m] = base[g]^exp[g, m] mod n[g], the fixed-base comb.

    Rows of a group share (base, modulus): ring-Pedersen's (T, N) per
    message, PDL's and range's (h1 | h2, N~) per receiver. The base's
    window powers are computed once per group (the ladder, unless
    `powers` is given), its 16-entry window tables once per window
    (`_comb_table`), and each row then costs one table multiply per
    window (`_comb_accumulate`) where the generic engine pays four
    squarings and a multiply.

    base, n, n_inv, r2, one_mont: (G, K); exp: (G, M, EL) limbs; powers:
    (W, G, K) in the Montgomery domain, W = exp_bits / 4. Returns (G, M,
    K)."""
    assert exp_bits % WINDOW_BITS == 0
    if powers is None:
        powers = _comb_ladder(base, n, n_inv, r2, exp_bits // WINDOW_BITS)
    table = _comb_table(powers, n, n_inv, one_mont, mont_mul_limbs)
    return _comb_accumulate(table, exp, n, n_inv, one_mont, exp_bits=exp_bits)


# ---------------------------------------------------------------------------
# the engine


def _download(t: torch.Tensor) -> List[int]:
    """Python ints of a (B, K) limb tensor; the host copy and the tensor
    are zeroed afterwards (results may be secret)."""
    return _download_all([t])[0]


def _download_all(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """`_download` of several (B, K) limb tensors in one copy to the host."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = flat.cpu().numpy()
    out, lo = [], 0
    for t in tensors:
        rows, k = t.shape
        out.append(limbs_to_ints(host[lo : lo + rows * k].reshape(rows, k)))
        lo += rows * k
    wipe_array(host, flat, *tensors)
    return out


class BatchModExp:
    """Reusable multi-modulus batch context on one torch device: fix the
    moduli once (they are per-party constants of a refresh), then run
    modexp / modmul batches. Holds only values derived from the public
    moduli (the Montgomery constants and their device copies)."""

    def __init__(self, moduli: Sequence[int], num_limbs: int, device="cuda"):
        self.device = torch.device(device)
        # an even limb count, so that R falls on the kernels' 32-bit words
        self.ctx = MontgomeryContext(moduli, num_limbs + (num_limbs & 1))
        self._n = to_device(self.ctx.n, self.device)
        self._n_inv = to_device(self.ctx.n_inv, self.device)
        self._r2 = to_device(self.ctx.r2, self.device)
        self._one_mont = to_device(self.ctx.one_mont, self.device)

    def nbytes(self) -> int:
        """Host and device bytes of the constants (the cache's estimate)."""
        return len(self.ctx.moduli) * self.ctx.num_limbs * 4 * 10

    def submit_modexp(self, bases: Sequence[int], exps: Sequence[int]) -> tuple:
        """Upload one modexp batch over this context's moduli: its segment
        (base, exp, n, n_inv, r2, one_mont, exp_bits) of
        `montgomery_kernels.modexp_segments`."""
        k = self.ctx.num_limbs
        bases = [b % n for b, n in zip(bases, self.ctx.moduli)]
        exp_bits = bucket_exp_bits(exps)
        exp_limbs = ints_to_limbs(exps, -(-exp_bits // LIMB_BITS))
        base_limbs = ints_to_limbs(bases, k)
        exp_t = to_device(exp_limbs, self.device)
        base_t = to_device(base_limbs, self.device)
        # exponents (and sometimes bases) are prover secrets
        wipe_array(exp_limbs, base_limbs)
        return base_t, exp_t, self._n, self._n_inv, self._r2, self._one_mont, exp_bits

    def modexp(self, bases: Sequence[int], exps: Sequence[int]) -> List[int]:
        return modexp_batches([(self, bases, exps)])[0]

    def modmul(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        k = self.ctx.num_limbs
        a_t = to_device(ints_to_limbs([x % n for x, n in zip(a, self.ctx.moduli)], k),
                         self.device)
        b_t = to_device(ints_to_limbs([x % n for x, n in zip(b, self.ctx.moduli)], k),
                         self.device)
        out = montgomery_kernels.modmul(a_t, b_t, self._n, self._n_inv, self._r2)
        res = _download(out)
        wipe_array(a_t, b_t)
        return res


def modexp_batches(jobs) -> List[List[int]]:
    """`BatchModExp.modexp` over several batches at once: jobs is a list of
    (ctx, bases, exps), each on its own context, all on one device, at
    most `montgomery_kernels.MAX_SEGMENTS`. Each batch is uploaded
    (`submit_modexp`) as one segment of a single `cios_modexp` launch;
    the results come back in one copy to the host, and every input and
    result tensor is wiped."""
    segments = [ctx.submit_modexp(bases, exps) for ctx, bases, exps in jobs]
    outs = montgomery_kernels.modexp_segments(segments)
    for seg in segments:
        wipe_array(seg[0], seg[1])  # queued behind the launch on its stream
    return _download_all(outs)


def multi_modexp(
    bases_rows: Sequence[Sequence[int]],
    exps_rows: Sequence[Sequence[int]],
    moduli: Sequence[int],
    num_limbs: int,
    exp_bits_seq: Sequence[int],
    ctx: Optional[BatchModExp] = None,
    device="cuda",
) -> List[int]:
    """prod_t bases_rows[r][t] ^ exps_rows[r][t] mod moduli[r] through the
    joint (Straus) kernel on `device` (or `ctx.device`), one launch.
    exp_bits_seq gives each term position's bucketed width (the launch's
    shape); the terms are sorted widest first here, so the shared chain is
    as deep as the first. Every row has len(exp_bits_seq) terms."""
    rows = len(moduli)
    if rows == 0:
        return []
    t_cnt = len(exp_bits_seq)
    order = sorted(range(t_cnt), key=lambda t: -exp_bits_seq[t])
    eb = tuple(exp_bits_seq[t] for t in order)
    el = -(-eb[0] // LIMB_BITS)
    if ctx is None:
        ctx = BatchModExp(moduli, num_limbs, device)
    device, k = ctx.device, ctx.ctx.num_limbs
    base_limbs = ints_to_limbs(
        [bases_rows[r][t] % m for t in order for r, m in enumerate(ctx.ctx.moduli)], k)
    exp_limbs = ints_to_limbs([exps_rows[r][t] for t in order for r in range(rows)], el)
    base_t = to_device(base_limbs, device).reshape(t_cnt, rows, k)
    exp_t = to_device(exp_limbs, device).reshape(t_cnt, rows, el)
    wipe_array(base_limbs, exp_limbs)  # exponents and bases may be secret
    out = montgomery_kernels.multi_modexp(base_t, exp_t, ctx._n, ctx._n_inv, ctx._r2,
                                          ctx._one_mont, eb)
    wipe_array(base_t, exp_t)
    return _download(out)


def shared_exp_batches(jobs) -> List[List[int]]:
    """bases[r]^exp mod modulus for several (ctx, bases, exp) jobs in one
    `cios_shared_exp` launch: ctx a context of the job's one modulus (a
    one-row `BatchModExp`), exp a public non-negative exponent shared by
    the job's rows. Each job is a segment with its own modulus and window
    digits; at most `montgomery_kernels.MAX_SEGMENTS` jobs, on one
    device."""
    segments = []
    for ctx, bases, exp in jobs:
        if exp < 0:
            raise ValueError("shared_exp_batches: exponent must be non-negative")
        (modulus,) = ctx.ctx.moduli
        digits = exp_digits(exp, bucket_exp_bits([exp]))
        base_t = to_device(ints_to_limbs([b % modulus for b in bases], ctx.ctx.num_limbs),
                           ctx.device)
        digits_t = torch.tensor(digits, dtype=torch.int32).to(ctx.device)
        segments.append((base_t, digits_t, ctx._n, ctx._n_inv, ctx._r2, ctx._one_mont))
    return _download_all(montgomery_kernels.shared_exp_segments(segments))


def shared_base_modexp(
    bases: Sequence[int],
    exps_per_group: Sequence[Sequence[int]],
    moduli: Sequence[int],
    num_limbs: int,
    ctx: Optional[BatchModExp] = None,
    device="cuda",
) -> List[List[int]]:
    """bases[g]^exps_per_group[g][m] mod moduli[g] via the fixed-base comb
    on `device` (or `ctx.device`): the power ladder in one launch, the
    table in four product launches, then one comb launch.

    The JAX package can also run the ladder on the host (CPython pow,
    cached per (base, modulus), up to its _HOST_LADDER_MAX_GROUPS
    groups). The port has no such path: in the H100 comb sweep (PERF.md
    section 6, "The comb sweep") the card's ladder had the shorter wall
    than the host's in every cell, from 1 group up, with the cache cold
    as it is in each round of a refresh.

    Groups may have unequal row counts; rows are padded to the widest
    group with exponent 0 (base^0 = 1, dropped on the way out). Callers
    with a stable modulus vector pass a cached context
    (backend.powm._cached_ctx)."""
    g_cnt = len(bases)
    if g_cnt == 0:
        return []
    m_max = max(len(e) for e in exps_per_group)
    exp_bits = bucket_exp_bits([e for grp in exps_per_group for e in grp])
    el = -(-exp_bits // LIMB_BITS)
    w_cnt = exp_bits // WINDOW_BITS

    if ctx is None:
        ctx = BatchModExp(moduli, num_limbs, device)
    device, k = ctx.device, ctx.ctx.num_limbs
    flat_exps: List[int] = []
    for grp in exps_per_group:
        flat_exps.extend(list(grp) + [0] * (m_max - len(grp)))
    exp_limbs = ints_to_limbs(flat_exps, el)
    exp_t = to_device(exp_limbs, device).reshape(g_cnt, m_max, el)
    wipe_array(exp_limbs)  # exponents may be prover secrets

    base_t = to_device(
        ints_to_limbs([b % n for b, n in zip(bases, ctx.ctx.moduli)], k), device)
    powers = montgomery_kernels.comb_ladder(base_t, ctx._n, ctx._n_inv, ctx._r2, w_cnt)
    table = _comb_table(powers, ctx._n, ctx._n_inv, ctx._one_mont,
                        montgomery_kernels.mont_mul)
    out = montgomery_kernels.comb(table, exp_t, ctx._n, ctx._n_inv, ctx._one_mont, exp_bits)
    wipe_array(exp_t)
    flat = _download(out.reshape(g_cnt * m_max, k))
    return [flat[g * m_max : g * m_max + len(exps_per_group[g])] for g in range(g_cnt)]


def _per_row(n, n_inv, rows_per_group):
    """(G, K) group constants repeated for each of a group's rows:
    contiguous (G * rows_per_group, K) tensors."""
    return tuple(
        t.repeat_interleave(rows_per_group, dim=0) for t in (n, n_inv)
    )


def _inv_tree_up_kernel(vals_m, n, n_inv, *, levels):
    """Product tree ascent, all groups batched. vals_m: (G, M, K) values
    in the Montgomery domain (x*R mod n), M = 2^levels; n / n_inv: (G, K)
    per group, broadcast over the M axis. Returns the per-level tensors
    (for the descent), the last being the (G, 1, K) roots. Montgomery
    products of domain values stay in domain. One product launch per
    level."""
    g, _, k = vals_m.shape
    lvls = [vals_m]
    cur = vals_m
    for _ in range(levels):
        half = cur.shape[1] // 2
        a = cur[:, 0::2].reshape(g * half, k).contiguous()
        b = cur[:, 1::2].reshape(g * half, k).contiguous()
        cur = montgomery_kernels.mont_mul(a, b, *_per_row(n, n_inv, half))
        cur = cur.reshape(g, half, k)
        lvls.append(cur)
    return tuple(lvls)


def _inv_tree_down_kernel(lvls, root_inv_m, n, n_inv, *, levels):
    """Descent: inv(left child) = inv(parent) * right sibling, and vice
    versa. root_inv_m: (G, 1, K) Montgomery-domain inverse of each
    group's root. Returns (G, M, K) per-leaf inverses (Montgomery
    domain). Both children of a level are one product launch."""
    g, _, k = root_inv_m.shape
    inv = root_inv_m
    for lvl in range(levels - 1, -1, -1):
        sib = lvls[lvl]  # (G, 2*half, K)
        half = sib.shape[1] // 2
        left = sib[:, 0::2].reshape(g * half, k)
        right = sib[:, 1::2].reshape(g * half, k)
        par = inv.reshape(g * half, k)
        nn, ni = _per_row(n, n_inv, half)
        both = montgomery_kernels.mont_mul(
            torch.cat([par, par]), torch.cat([right, left]),
            torch.cat([nn, nn]), torch.cat([ni, ni]),
        )
        inv_left = both[: g * half].reshape(g, half, k)
        inv_right = both[g * half :].reshape(g, half, k)
        inv = torch.stack([inv_left, inv_right], dim=2).reshape(g, 2 * half, k)
    return inv


def _modmul_exit_kernel(a_m, one, n, n_inv):
    """Leave the Montgomery domain: MontMul(x_m, 1) = x."""
    return montgomery_kernels.mont_mul(a_m, one, n, n_inv)


def batch_mod_inv_grouped(
    groups: Sequence[Tuple[int, Sequence[int]]],
    num_limbs: int,
    device="cuda",
    ctx: Optional[BatchModExp] = None,
):
    """Batched modular inversion via a Montgomery product tree on
    `device`: for each (modulus, values) group, ONE host inversion of the
    tree root replaces len(values) serial `pow(v, -1, m)` calls. Callers
    with a stable modulus vector pass a cached context of the groups'
    moduli (backend.powm._cached_ctx).

    Returns a list of per-group lists; a non-invertible value poisons
    only its own group, which falls back to per-row host inversion (None
    where a value has no inverse): an adversarial input can force the
    slow path for its group, never a wrong result."""
    if not groups:
        return []
    g_cnt = len(groups)
    m_max = max(len(vs) for _, vs in groups)
    levels = max(1, (m_max - 1).bit_length())
    m_pad = 1 << levels

    if ctx is None:
        ctx = BatchModExp([m for m, _ in groups], num_limbs, device)
    device = ctx.device
    n, n_inv = ctx._n, ctx._n_inv
    k = ctx.ctx.num_limbs
    flat: List[int] = []
    for mod, vs in groups:
        flat.extend(v % mod for v in vs)
        flat.extend([1] * (m_pad - len(vs)))  # padding: the product's identity
    nn, ni = _per_row(n, n_inv, m_pad)
    # into the Montgomery domain (x*R mod n) by one product with R^2 mod n
    vals_m = montgomery_kernels.mont_mul(
        to_device(ints_to_limbs(flat, k), device),
        ctx._r2.repeat_interleave(m_pad, dim=0), nn, ni,
    ).reshape(g_cnt, m_pad, k)

    lvls = _inv_tree_up_kernel(vals_m, n, n_inv, levels=levels)
    # roots are x*R mod n; R^{-1} factors cancel in pairs up the tree so
    # root_m = (prod v_i) * R mod n, and the root's inverse in the domain,
    # (prod v_i)^{-1} * R, is root_m^{-1} * R^2 mod n: one host inversion
    # per group
    roots = limbs_to_ints(lvls[-1].reshape(g_cnt, k).cpu().numpy())
    r2 = limbs_to_ints(ctx.ctx.r2)
    out: List[Optional[List]] = [None] * g_cnt
    root_inv_m: List[int] = []
    live: List[int] = []
    for gi, ((mod, vs), rt) in enumerate(zip(groups, roots)):
        try:
            root_inv_m.append(pow(rt, -1, mod) * r2[gi] % mod)
            live.append(gi)
        except ValueError:  # some value in the group not invertible
            out[gi] = [intops.mod_inv(v, mod) for v in vs]
            root_inv_m.append(0)  # dummy, discarded

    inv_leaves = _inv_tree_down_kernel(
        lvls[:-1],
        to_device(ints_to_limbs(root_inv_m, k), device).reshape(g_cnt, 1, k),
        n,
        n_inv,
        levels=levels,
    )
    flat_m = inv_leaves.reshape(g_cnt * m_pad, k)
    one = torch.zeros_like(flat_m)
    one[:, 0] = 1
    leaf_ints = limbs_to_ints(_modmul_exit_kernel(flat_m, one, nn, ni).cpu().numpy())
    for gi in live:
        mod, vs = groups[gi]
        out[gi] = leaf_ints[gi * m_pad : gi * m_pad + len(vs)]
    return out


def batch_modexp(
    bases: Sequence[int], exps: Sequence[int], moduli: Sequence[int], num_limbs: int,
    device="cuda",
) -> List[int]:
    """One-shot convenience wrapper: bases^exps mod moduli, row-wise."""
    return BatchModExp(moduli, num_limbs, device).modexp(bases, exps)


def batch_modmul(
    a: Sequence[int], b: Sequence[int], moduli: Sequence[int], num_limbs: int,
    device="cuda",
) -> List[int]:
    return BatchModExp(moduli, num_limbs, device).modmul(a, b)
