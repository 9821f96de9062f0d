"""A CPU model of the kernels' shared RNS Montgomery product
(csrc/rns_kernels.cu, `mont_mul<RT, W>`, which both `rns_mont_mul_kernel`
and `rns_modexp_kernel` run), held against the plain versions.

The CUDA kernel runs only on the card, so what it relies on is modelled
here in Python, step by step as the kernel does it:

- The fragment map. T1/T2 reach the kernel as u8 planes in the A-operand
  fragment order of mma.m16n8k32 (`rns_kernels.fragment_planes`). The
  model reads them as the kernel's lanes load them (lane L of tile (mt,
  kt) takes the 16 bytes at ((mt*KT + kt)*32 + L)*16; register r, byte b
  is T^T[16 mt + L//4 + 8 (r & 1), 32 kt + 16 (r >> 1) + 4 (L % 4) + b])
  and must give back T exactly, zero-padded, at k = 18, 131, 260, 454.
- One RNS Montgomery product done the kernel's way: u8 planes of xi and
  zeta as the B operand (rows on N), four s32 plane products, the combine
  P_ll + 2^8 (P_lh + P_hl) + 2^16 P_hh, and fold reductions with the
  class's fold counts, every intermediate checked to fit its 32-bit
  register. Its residues must equal `rns_kernels._mont_mul_i64`, bit for
  bit, on random and worst-case rows at k = 18, 131 and 260.
- Kernel 1's tile: int32 rows loaded into zero-padded 8-row u16 tiles,
  one product per tile, and only rows < `rows` stored. Its output must
  equal `rns_kernels.mont_mul_plain` bit for bit at k = 18, 131, 260 and
  454, for 1, 8 and 13 rows (a tile of one, a full tile, a partial last
  tile), random and worst-case rows.
- The fold counts (`rns_kernels.fold_counts`): for every width class and
  every channel prime, the bound of each reduction site's largest input
  falls below 2m after its folds (so one conditional subtraction leaves a
  residue < m), and that largest input itself, run through the folds,
  ends below m.

Inputs are made with numpy from fixed seeds; the arithmetic is exact,
so the tolerance is bit-identical residues.
"""

import math
import random

import numpy as np
import pytest
import torch

from fsdkr_tpu_torch.ops import rns, rns_kernels

U32 = 1 << 32
CLASS_BITS = (256, 512, 1024, 1536, 2048, 3072, 4096, 5120, 6144, 7168)
BITS_OF_K = {18: 256, 131: 2048, 260: 4096, 454: 7168}


def _bases(k):
    bits = BITS_OF_K[k]
    rb = rns.rns_bases_for_bits(bits, bits // 16)
    assert rb.k == k
    return rb


def _consts(rb):
    return rns._device_consts(rb, torch.device("cpu")).kernel


# ---------------------------------------------------------------------------
# the fragment map, as the kernel's lanes load it


def _a_operand(planes, k):
    """Dense T^T (Mp, Kp) from fragment-ordered planes, read the way the
    kernel's lanes load them."""
    mt_n, kt_n = -(-(k + 1) // 16), -(-k // 32)
    frag = np.asarray(planes).reshape(mt_n, kt_n, 32, 4, 4)  # lane, reg, byte
    out = np.full((16 * mt_n, 32 * kt_n), -1, np.int64)
    mt = 16 * np.arange(mt_n)[:, None]
    kt = 32 * np.arange(kt_n)[None, :]
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r in range(4):
            for b in range(4):
                out[mt + g + 8 * (r & 1), kt + 16 * (r >> 1) + 4 * t + b] = frag[:, :, lane, r, b]
    assert (out >= 0).all()  # every element is loaded by exactly one lane
    return out


def _b_operand(src, kp):
    """The kernel's B operand (Kp, 8) for a tile of rows: src (R, k)
    residues written to the shared byte planes [8][Kp + 16] (rows and
    columns past the data are zero) and read the way the lanes load them
    (lane L, register r, byte b: plane row L//4, column 32 kt + 16 r +
    4 (L % 4) + b). Returns (lo, hi)."""
    sp = kp + 16
    out = []
    for plane in (src & 0xFF, src >> 8):
        smem = np.zeros((8, sp), np.int64)
        smem[: src.shape[0], : src.shape[1]] = plane
        b = np.full((kp, 8), -1, np.int64)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kt in range(kp // 32):
                for r in range(2):
                    for byte in range(4):
                        col = 32 * kt + 16 * r + 4 * t + byte
                        b[col, g] = smem[g, col]
        assert (b >= 0).all()
        out.append(torch.as_tensor(b))
    return out


@pytest.mark.parametrize("k", [18, 131, 260, 454])
def test_fragment_map_reassembles_T(k):
    rb = _bases(k)
    K = _consts(rb)
    mp, kp = -(-(k + 1) // 16) * 16, -(-k // 32) * 32
    for T, lo, hi in ((rb.T1, K.T1_lo, K.T1_hi), (rb.T2, K.T2_lo, K.T2_hi)):
        assert lo.dtype == hi.dtype == torch.uint8
        assert lo.shape == hi.shape == (mp * kp,)
        a = _a_operand(lo.numpy(), k) + 256 * _a_operand(hi.numpy(), k)
        want = np.zeros((mp, kp), np.int64)
        want[: k + 1, :k] = np.asarray(T, np.int64).T
        np.testing.assert_array_equal(a, want)


# ---------------------------------------------------------------------------
# one product the kernel's way


def _fold(v, u):
    return (v >> 16) * u + (v & 0xFFFF)


def _fold_n(v, u, n):
    for _ in range(n):
        v = _fold(v, u)
        assert int(v.max()) < U32
    return v


def _csub(v, m):
    return torch.where(v >= m, v - m, v)


def _fmul(a, b, m, u, f_mul):
    v = a * b
    assert int(v.max()) < U32
    out = _csub(_fold_n(v, u, f_mul), m)
    assert bool((out < m).all())
    return out


def _extend(a_lo, a_hi, src, m, u, folds):
    """(R, k) residues -> (R, k+1) sums mod the target primes, via four
    exact s32 u8-plane products and the fold combine."""
    _, f_mid, f_hh, f_ext = folds
    k1 = m.shape[0]
    b_lo, b_hi = _b_operand(src.numpy(), a_lo.shape[1])
    p_ll, p_lh, p_hl, p_hh = (
        (a @ b)[:k1, : src.shape[0]].T
        for a, b in ((a_lo, b_lo), (a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    )
    for p in (p_ll, p_lh, p_hl, p_hh):
        assert int(p.max()) < 1 << 31  # s32 accumulators
    mid = _fold_n(p_lh + p_hl, u, f_mid)
    v = p_ll + (mid << 8)
    assert int(v.max()) < U32
    hh = _fold_n(p_hh, u, f_hh)
    w = _fold(v, u) + u * hh
    assert int(w.max()) < U32
    out = _csub(_fold_n(w, u, f_ext), m)
    assert bool((out < m).all())
    return out


def _model_mont_mul(x, y, c1, nbmr, K):
    """x*y*A^{-1} mod N per row, as kernel 2 computes it (int64 tensors
    standing for its u32 registers)."""
    k = K.k
    f_mul = K.folds[0]
    m, u = K.m_all.long(), K.u_all.long()
    mA, uA, mBr, uBr = m[:k], u[:k], m[k:], u[k:]
    mAr, uAr = torch.cat([mA, m[2 * k :]]), torch.cat([uA, u[2 * k :]])
    a1 = [torch.as_tensor(_a_operand(p.numpy(), k)) for p in (K.T1_lo, K.T1_hi)]
    a2 = [torch.as_tensor(_a_operand(p.numpy(), k)) for p in (K.T2_lo, K.T2_hi)]

    d = _fmul(x, y, m, u, f_mul)
    xi = _fmul(d[:, :k], c1, mA, uA, f_mul)
    q = _extend(*a1, xi, mBr, uBr, K.folds)
    t = _csub(_fmul(q, nbmr, mBr, uBr, f_mul) + d[:, k:], mBr)
    r = _fmul(t, K.Ainv_B.long(), mBr, uBr, f_mul)
    zeta = _fmul(r[:, :k], K.c2_B.long(), mBr[:k], uBr[:k], f_mul)
    s = _extend(*a2, zeta, mAr, uAr, K.folds)
    m_r, u_r = m[2 * k], u[2 * k]
    s_r, r_r = s[:, k], r[:, k]
    diff = torch.where(s_r >= r_r, s_r - r_r, s_r + m_r - r_r)
    # beta < k for values in the working domain; < m_r (the smallest
    # prime) for any residues, so beta * (B mod a_i) is a product of residues
    beta = _fmul(diff, torch.tensor(K.Binv_r), m_r, u_r, f_mul)
    assert int(m_r) == int(m.min())
    corr = _fmul(beta[:, None], K.B_mod_A.long(), mA, uA, f_mul)
    s_a = s[:, :k]
    r_a = torch.where(s_a >= corr, s_a - corr, s_a + mA - corr)
    return torch.cat([r_a, r], dim=1)


def _inputs(rb, worst, rows=8, seed=5):
    k = rb.k
    m = rb.m_all.astype(np.int64)
    if worst:
        x = np.tile(m - 1, (rows, 1))
        return x, x.copy(), np.tile(m[:k] - 1, (rows, 1)), np.tile(m[k:] - 1, (rows, 1))
    nrng = np.random.default_rng(seed + k)
    rng = random.Random(seed + k)
    prod = rb.A * rb.B * rb.m_r
    moduli = []
    while len(moduli) < rows:
        n = rng.getrandbits(rb.value_bits) | (1 << (rb.value_bits - 1)) | 1
        if math.gcd(n, prod) == 1:
            moduli.append(n)
    c1, nb, _, _ = rns._row_consts(rb, moduli)
    x = nrng.integers(0, m, size=(rows, 2 * k + 1))
    y = nrng.integers(0, m, size=(rows, 2 * k + 1))
    return x, y, np.asarray(c1, np.int64), np.asarray(nb, np.int64)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("k", [18, 131, 260])
def test_model_product_matches_plain(k, worst):
    rb = _bases(k)
    K = _consts(rb)
    x, y, c1, nb = (torch.as_tensor(a) for a in _inputs(rb, worst))
    want = rns_kernels._mont_mul_i64(x, y, c1, nb, K)
    got = _model_mont_mul(x, y, c1, nb, K)
    assert torch.equal(got, want)


def _model_mont_mul_kernel(x, y, c1, nbmr, K):
    """Kernel 1 over (rows, 2k+1) int32 residues, tile by tile as its
    blocks run: each block loads its rows into zero-padded (8, 2k+1) u16
    tiles (c1 and N mod B read as 0 past `rows`, as the kernel reads
    them), runs one product and stores only its rows < `rows`."""
    rows, C = x.shape
    k = K.k
    out = torch.full((rows, C), -1, dtype=torch.int32)
    for row0 in range(0, rows, 8):
        n = min(8, rows - row0)
        tiles = []
        for src, width in ((x, C), (y, C), (c1, k), (nbmr, k + 1)):
            tile = np.zeros((8, width), np.uint16)
            tile[:n] = src[row0 : row0 + n].numpy()
            assert (tile[:n].astype(np.int64) == src[row0 : row0 + n].numpy()).all()
            tiles.append(torch.as_tensor(tile.astype(np.int64)))
        prod = _model_mont_mul(*tiles, K)
        out[row0 : row0 + n] = prod[:n].to(torch.int32)
    assert bool((out >= 0).all())  # every row stored exactly once
    return out


@pytest.mark.parametrize("rows", [1, 8, 13])
@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("k", [18, 131, 260, 454])
def test_model_mont_mul_kernel_matches_plain(k, worst, rows):
    rb = _bases(k)
    K = _consts(rb)
    x, y, c1, nb = (torch.as_tensor(a.astype(np.int32))
                    for a in _inputs(rb, worst, rows=rows, seed=7 + rows))
    want = rns_kernels.mont_mul_plain(x, y, c1, nb, K)
    got = _model_mont_mul_kernel(x, y, c1, nb, K)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the fold counts against the bounds


def _bound_after(v, u, n):
    """The bound of any value <= v after n folds. Within a block of 2^16
    values fold(x) grows with x, and from block to block its top grows,
    so the largest fold of any x <= v is at v or at the top of the block
    below v's."""
    for _ in range(n):
        v = max(_fold(v, u), _fold((v >> 16 << 16) - 1, u) if v >> 16 else 0)
    return v


def _run(v, u, n):
    for _ in range(n):
        v = _fold(v, u)
    return v


@pytest.mark.parametrize("bits", CLASS_BITS)
def test_fold_counts_bound_every_site(bits):
    rb = rns.rns_bases_for_bits(bits, bits // 16)
    k = rb.k
    f_mul, f_mid, f_hh, f_ext = rns_kernels.fold_counts(rb.m_all, k)
    p = k * 255 * 255  # the largest u8-plane sum over k terms
    assert 2 * p < 1 << 31
    for m in (int(x) for x in rb.m_all):
        u = (1 << 16) % m
        assert u == (1 << 16) - m
        # a product of two residues
        top = (m - 1) ** 2
        assert _bound_after(top, u, f_mul) < 2 * m
        v = _run(top, u, f_mul)
        assert (v - m if v >= m else v) < m
        # the extension combine
        mid = _bound_after(2 * p, u, f_mid)
        v_max = p + (mid << 8)
        assert v_max < U32
        fv = _bound_after(v_max, u, 1)
        hh = _bound_after(p, u, f_hh)
        assert fv + u * hh < U32
        assert _bound_after(fv + u * hh, u, f_ext) < 2 * m
        # and the largest plane sums themselves, run through the combine
        mid_v = _run(2 * p, u, f_mid)
        w = _fold(p + (mid_v << 8), u) + u * _run(p, u, f_hh)
        assert w < U32
        w = _run(w, u, f_ext)
        assert (w - m if w >= m else w) < m
        assert (w - m if w >= m else w) == (p + (2 * p << 8) + (p << 16)) % m


def test_kernel_limits_admit_every_width_class():
    """Kernel 2's tile fits the H100's shared memory at every width class:
    8 rows per block up to 6144 bits, 4 at 7168 bits (the kernel takes 8
    wherever they fit), and its k limit admits them all. Kernel 1's tile
    (8 rows, two u16 arrays) fits at every class, its k limit comes from
    that layout, and at the 2048- and 4096-bit classes four of its blocks
    fit one SM's shared memory (the 4-warp blocks of a 4096-row launch)."""
    limit = 232448
    modexp, mont = rns_kernels.MODEXP_ARRAYS, rns_kernels.MONT_MUL_ARRAYS
    for bits in (2048, 4096, 6144):
        k = rns.rns_bases_for_bits(bits, bits // 16).k
        assert rns_kernels.tile_smem_bytes(k, 8, modexp) <= limit
        assert k <= rns_kernels._MAX_K_MODEXP
    k = rns.rns_bases_for_bits(7168, 7168 // 16).k
    assert rns_kernels.tile_smem_bytes(k, 8, modexp) > limit
    assert rns_kernels.tile_smem_bytes(k, 4, modexp) <= limit
    assert k <= rns_kernels._MAX_K_MODEXP
    assert rns_kernels.tile_smem_bytes(rns_kernels._MAX_K_MODEXP + 1, 4, modexp) > limit

    for bits in CLASS_BITS:
        k = rns.rns_bases_for_bits(bits, bits // 16).k
        assert rns_kernels.tile_smem_bytes(k, 8, mont) <= limit
        assert k <= rns_kernels._MAX_K_MONT_MUL
    top = rns_kernels._MAX_K_MONT_MUL
    assert rns_kernels.tile_smem_bytes(top, 8, mont) <= limit
    assert rns_kernels.tile_smem_bytes(top + 1, 8, mont) > limit
    # the plane sums of the widest admitted class stay in the s32
    # accumulators
    assert 2 * top * 255 * 255 < 1 << 31
    for bits in (2048, 4096):
        k = rns.rns_bases_for_bits(bits, bits // 16).k
        # 228 KB of shared memory per SM, 1 KB of it reserved per block
        assert 4 * (rns_kernels.tile_smem_bytes(k, 8, mont) + 1024) <= 233472
