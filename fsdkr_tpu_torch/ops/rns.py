"""RNS (residue number system) Montgomery modexp and modmul on the device.

A 2048-bit Montgomery product decomposes over ~130 independent 16-bit
prime channels (CRT), where multiplication is elementwise and the only
cross-channel work is *base extension*: a matrix product with a shared
constant matrix, q_B = xi (R, k) @ T (k, k+1).

Method (Bajard-Plantard-style full-RNS Montgomery with a Shenoy-Kumaresan
exact second extension; the arithmetic itself is in `ops.rns_kernels`
and `csrc/rns_kernels.cu`):

- Two bases A = {a_1..a_k}, B = {b_1..b_k} of distinct 16-bit primes with
  2 channels of slack (A > (k+1)^2 * N), plus one redundant channel m_r.
  Working domain: values < (k+1) * N, chain-stable.
- MontMul(x, y) -> x*y*A^{-1} mod N (up to the domain bound).
- Exponentiation is an MSB-first 4-bit fixed window (kernel 2).
- Host <-> device: big integers cross as 16-bit limb tensors; limbs ->
  residues is one exact matrix product against W[l, c] = 2^(16 l) mod m_c,
  and the CRT exit back to limbs runs on the device as torch code.

The channel primes and every constant matrix are the same numbers, bit
for bit, as the JAX package's `RNSBases` (a test holds them equal).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.lru import global_cache
from . import rns_kernels
from .limbs import (
    LIMB_BITS,
    bucket_exp_bits,
    ints_to_limbs,
    limbs_to_ints,
    to_device,
    wipe_array,
)
from .rns_kernels import RNSConsts

__all__ = ["RNSBases", "rns_bases_for_bits", "rns_modexp", "rns_modmul"]


def _gen_channel_primes(count: int) -> List[int]:
    """`count` distinct 16-bit primes, descending from 2^16 (keeps
    2^16 mod m small)."""
    from ..core.primes import is_probable_prime

    out = []
    cand = (1 << 16) - 1
    while len(out) < count and cand > (1 << 15):
        if is_probable_prime(cand, rounds=16):
            out.append(cand)
        cand -= 2
    if len(out) < count:
        raise ValueError("not enough 16-bit primes for the requested base")
    return out


class RNSBases:
    """Shared per-width-class constants: the channel primes, extension
    matrices, and the limb->residue conversion matrix. Independent of the
    batch's moduli (those enter per launch as residue tensors)."""

    def __init__(self, value_bits: int, num_limbs: int):
        # Domain invariant: every chained value stays < (k+1)*N. With the
        # fast (uncorrected) first extension this needs A > (k+1)^2 * N
        # and B likewise; k grows until the bound holds with 2^16 margin.
        self.value_bits = value_bits
        self.num_limbs = num_limbs
        k = -(-value_bits // 16) + 2
        while True:
            primes = _gen_channel_primes(2 * k + 1)
            a_primes = primes[0::2][:k]
            b_primes = primes[1::2][:k]
            A = 1
            for p in a_primes:
                A *= p
            B = 1
            for p in b_primes:
                B *= p
            bound = (k + 1) * (k + 1) << (value_bits + 16)
            if A > bound and B > bound:
                break
            k += 1
        self.k = k
        self.A_primes = a_primes
        self.B_primes = b_primes
        self.m_r = primes[2 * k]
        self.A = A
        self.B = B

        m_r = self.m_r
        aps, bps = self.A_primes, self.B_primes
        Ai = [A // p for p in aps]
        Bj = [B // p for p in bps]
        # c-constant halves (the -N^{-1} factor joins per launch)
        self.Ai_inv = np.array(
            [pow(Ai[i] % aps[i], -1, aps[i]) for i in range(k)], np.uint32
        )
        self.c2_B = np.array(
            [pow(Bj[j] % bps[j], -1, bps[j]) for j in range(k)], np.uint32
        )
        # extension matrices, target channels B+mr / A+mr
        self.T1 = np.array(
            [[Ai[i] % m for m in bps + [m_r]] for i in range(k)], np.uint32
        )  # (k, k+1)
        self.T2 = np.array(
            [[Bj[j] % m for m in aps + [m_r]] for j in range(k)], np.uint32
        )  # (k, k+1)
        self.Ainv_B = np.array(
            [pow(A % m, -1, m) for m in bps + [m_r]], np.uint32
        )  # (k+1,) inverse of A in B channels and m_r
        self.B_mod_A = np.array([B % m for m in aps], np.uint32)
        self.Binv_r = np.uint32(pow(B % m_r, -1, m_r))

        self.mA = np.array(aps, np.uint32)
        self.mB = np.array(bps, np.uint32)
        self.m_all = np.array(aps + bps + [m_r], np.uint32)  # (2k+1,)
        # limb -> residue conversion matrix W[l, c] = 2^(16 l) mod m_c
        self.Wconv = np.array(
            [[pow(1 << (16 * l), 1, int(m)) for m in self.m_all]
             for l in range(num_limbs)],
            np.uint32,
        )  # (num_limbs, 2k+1)

    def exit_arrays(self):
        """Host arrays of the CRT exit: (Ai_inv, Ai mod m_r, A^{-1} mod
        m_r, Ai limbs (k, lv), A limbs (lv,), lv)."""
        Ai = [self.A // p for p in self.A_primes]
        # v = sum xi_i*Ai < k*A -> A bits + ~log2(k) extra bits; lv rounds
        # up with 24 bits of headroom so the top limbs are provably zero
        lv = -(-(self.A.bit_length() + 24) // 16)
        return (
            self.Ai_inv,
            np.array([a % self.m_r for a in Ai], np.uint32),
            int(self.Ainv_B[self.k]),  # A^{-1} mod m_r
            ints_to_limbs(Ai, lv),
            ints_to_limbs([self.A], lv)[0],
            lv,
        )


_BASES_CACHE: Dict[Tuple[int, int], RNSBases] = {}


def rns_bases_for_bits(value_bits: int, num_limbs: int) -> RNSBases:
    key = (value_bits, num_limbs)
    if key not in _BASES_CACHE:
        _BASES_CACHE[key] = RNSBases(value_bits, num_limbs)
    return _BASES_CACHE[key]


class _DeviceConsts:
    """One width class's constants on one device: the kernels' RNSConsts,
    the conversion matrix W, and the CRT-exit tensors."""

    def __init__(self, rb: RNSBases, device: torch.device):
        def t(a, dtype=np.int64):
            return torch.as_tensor(np.asarray(a, dtype)).to(device)

        k = rb.k
        self.k = k
        self.kernel = _prep_consts(rb, device)
        # the matrix operands are float64: CUDA's matmul takes no integer
        # types, and every dot product here stays below 2^53 (exact)
        self.W = t(rb.Wconv, np.float64)
        self.m_all = t(rb.m_all)
        ai_inv, ai_mr, ainv_mr, ai_limbs, a_limbs, lv = rb.exit_arrays()
        self.Ai_inv = t(ai_inv)
        self.Ai_mr = t(ai_mr, np.float64)[:, None]  # (k, 1)
        self.Ainv_mr = ainv_mr
        self.Ai_limbs = t(ai_limbs, np.float64)  # (k, lv)
        self.A_limbs = t(a_limbs)  # (lv,)
        self.mA = t(rb.mA)
        self.m_r = int(rb.m_r)
        self.lv = lv


_DEVICE_CACHE: Dict[Tuple[int, int, str], _DeviceConsts] = {}


def _prep_consts(bases: RNSBases, device) -> RNSConsts:
    """Device-ready shared constants for the kernels and their plain
    versions. The kernels, like the JAX package's MXU kernels
    (T1l/T1h/T2l/T2h), take T1/T2 split into u8 low and high planes, here
    laid out in the tensor-core fragment order
    (`rns_kernels.fragment_planes`), with the per-channel fold constant
    u = 2^16 mod m and the class's fold counts; the plain versions take
    the full 16-bit values (int32)."""

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(device).contiguous()

    def planes(T):
        return [torch.from_numpy(p).to(device) for p in rns_kernels.fragment_planes(T)]

    t1_lo, t1_hi = planes(bases.T1)
    t2_lo, t2_hi = planes(bases.T2)
    m_all = np.asarray(bases.m_all, np.int64)
    return RNSConsts(
        k=bases.k,
        m_all=t(bases.m_all),
        T1=t(bases.T1),
        T2=t(bases.T2),
        Ainv_B=t(bases.Ainv_B),
        c2_B=t(bases.c2_B),
        B_mod_A=t(bases.B_mod_A),
        Binv_r=int(bases.Binv_r),
        u_all=t((1 << 16) % m_all),
        T1_lo=t1_lo,
        T1_hi=t1_hi,
        T2_lo=t2_lo,
        T2_hi=t2_hi,
        folds=rns_kernels.fold_counts(m_all, bases.k),
    )


def _device_consts(rb: RNSBases, device: torch.device) -> _DeviceConsts:
    key = (rb.value_bits, rb.num_limbs, str(device))
    if key not in _DEVICE_CACHE:
        _DEVICE_CACHE[key] = _DeviceConsts(rb, device)
    return _DEVICE_CACHE[key]


def _limbs_to_residues(limbs: torch.Tensor, dc: _DeviceConsts) -> torch.Tensor:
    """(R, L) int32 16-bit limb rows -> (R, 2k+1) int32 residues via one
    exact float64 matrix product (sums < 2^16 * 2^16 * L < 2^41). The
    limbs may be secret: the float64 and int64 temporaries are zeroed
    before they go back to the allocator."""
    a = limbs.to(torch.float64)
    prod = a @ dc.W
    r = prod.to(torch.int64).remainder_(dc.m_all)
    out = r.to(torch.int32)
    wipe_array(a, prod, r)
    return out


def _normalize_carries(t: torch.Tensor) -> torch.Tensor:
    """Fully propagate pending carries and borrows (signed int64 limbs)
    to canonical base-2^16, in place. Runs until fixpoint: a
    data-dependent trip count, each pass one fixed-shape vector step (3-4
    in practice). The top limb's carry out is dropped (callers size the
    layout so it is provably zero). Each pass's carry tensor is zeroed
    before it is freed."""
    hi = t >> LIMB_BITS  # arithmetic shift: a borrow is -1
    while bool(hi.any()):
        t &= 0xFFFF
        t[:, 1:] += hi[:, :-1]
        hi.zero_()
        hi = t >> LIMB_BITS
    return t


def _sub_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb-wise a - b (a >= b) over canonical base-2^16, in place in
    `a`: the difference per limb, then borrow propagation to canonical
    form."""
    return _normalize_carries(a.sub_(b))


def _crt_exit_kernel(res: torch.Tensor, dc: _DeviceConsts) -> torch.Tensor:
    """Device-side CRT exit: (R, 2k+1) result residues -> (R, lv+1)
    canonical base-2^16 limbs (int64) of the exact value v < (k+1)*N.

    v = sum_i xi_i * (A/a_i) - alpha*A with xi_i = |res_i * (A/a_i)^{-1}|
    mod a_i; the wrap count alpha <= k is recovered exactly from the
    redundant channel: alpha = (S - v) * A^{-1} mod m_r. The big
    sum-of-products is one exact matrix product into delayed-carry limbs
    (each < 2^41), then a carry normalization and a borrow subtraction.
    The result may be secret (an encryption mask r^N), so every
    temporary is zeroed before it goes back to the allocator."""
    k, m_r = dc.k, dc.m_r
    r = res.to(torch.int64)
    xi = (r[:, :k] * dc.Ai_inv).remainder_(dc.mA)
    xf = xi.to(torch.float64)
    s = xf @ dc.Ai_mr  # (R, 1), S < 2^41
    alpha = s[:, 0].to(torch.int64)
    alpha.sub_(r[:, 2 * k]).remainder_(m_r).mul_(dc.Ainv_mr).remainder_(m_r)
    vf = xf @ dc.Ai_limbs  # (R, lv) delayed-carry limbs
    v = torch.zeros((r.shape[0], dc.lv + 1), dtype=torch.int64, device=r.device)
    v[:, :-1] = vf
    aA = torch.zeros_like(v)
    aA[:, :-1] = dc.A_limbs
    aA.mul_(alpha[:, None])  # alpha <= k
    _normalize_carries(v)
    _normalize_carries(aA)
    _sub_limbs(v, aA)
    wipe_array(r, xi, xf, s, alpha, vf, aA)
    return v


def _modulus_consts(rb: RNSBases, n: int):
    """One modulus's RNS constants: (c1 (k,), N mod (B, m_r) (k+1,),
    A^2 mod N), or None when n shares a factor with an A channel prime."""
    try:
        return (
            np.array(
                [(-pow(n, -1, a)) % a * int(rb.Ai_inv[i]) % a
                 for i, a in enumerate(rb.A_primes)],
                np.uint32,
            ),
            np.array([n % b for b in rb.B_primes] + [n % rb.m_r], np.uint32),
            pow(rb.A, 2, n),
        )
    except ValueError:  # gcd(n, a_i) > 1
        return None


def _row_consts(rb: RNSBases, moduli: List[int]):
    """Per-row host precomputes: c1 (R, k), N mod (B, m_r) (R, k+1) and
    A^2 mod N. Each distinct modulus is looked up in the process-wide
    precompute cache (`utils.lru`, keyed by the width class and the
    modulus itself, which is public) and computed only on a miss, so a
    stable committee pays the host `pow`s once, not on every collect. A
    modulus sharing a factor with an A channel prime (only a crafted one
    can) cannot ride the RNS route: its rows are returned in `bad` for
    the caller to evaluate on the host — the reference's semantics, not
    a device fallback — and run through the launch neutralized as
    modulus 3."""
    if not moduli:
        return (np.zeros((0, rb.k), np.uint32), np.zeros((0, rb.k + 1), np.uint32),
                [], [])
    cache = global_cache()
    use_cache = cache.budget > 0
    slot: Dict[int, int] = {}
    rows_at = np.empty(len(moduli), np.int64)
    for r, n in enumerate(moduli):
        rows_at[r] = slot.setdefault(n, len(slot))
    ents = []
    for n in slot:
        key = ("rns-row", rb.value_bits, rb.num_limbs, n)
        ent = cache.get(key) if use_cache else None
        if ent is None:
            # a bad modulus is cached as False: get() returns None on a miss
            ent = _modulus_consts(rb, n) or False
            if use_cache:
                cache.put(key, ent, 4 * (2 * rb.k + 1) + 2 * rb.value_bits // 8 + 256)
        ents.append(ent)
    bad_slots = {j for j, ent in enumerate(ents) if ent is False}
    if bad_slots:
        safe = _modulus_consts(rb, 3)
        ents = [safe if ent is False else ent for ent in ents]
    c1 = np.stack([ent[0] for ent in ents])[rows_at]
    n_bmr = np.stack([ent[1] for ent in ents])[rows_at]
    a2n = [ents[j][2] for j in rows_at]
    bad = [r for r, j in enumerate(rows_at) if j in bad_slots]
    return c1, n_bmr, a2n, bad


def rns_modexp(
    bases_int: Sequence[int],
    exps: Sequence[int],
    moduli: Sequence[int],
    value_bits: int,
    device="cuda",
) -> List[int]:
    """bases^exps mod moduli row-wise through kernel 2 (one launch) on
    `device`: "cuda" (the default) launches the kernel, "cpu" runs its
    plain version. Every device tensor that held a base, an exponent or
    the result is zeroed before it is freed."""
    if not bases_int:
        return []
    device = torch.device(device)
    num_limbs = -(-value_bits // LIMB_BITS)
    rb = rns_bases_for_bits(value_bits, num_limbs)
    dc = _device_consts(rb, device)

    exp_bits = bucket_exp_bits(exps)
    el = -(-exp_bits // LIMB_BITS)
    moduli = list(moduli)
    bases_int = list(bases_int)
    exps = list(exps)
    c1, n_bmr, a2n, bad = _row_consts(rb, moduli)
    host = {r: pow(bases_int[r] % moduli[r], exps[r], moduli[r]) for r in bad}
    for r in bad:
        moduli[r], bases_int[r], exps[r] = 3, 1, 0

    base_limbs = ints_to_limbs(
        [b % n for b, n in zip(bases_int, moduli)], num_limbs
    )
    exp_limbs = ints_to_limbs(exps, el)
    base_t = to_device(base_limbs, device)
    exp_t = to_device(exp_limbs, device)
    wipe_array(base_limbs, exp_limbs)  # secret bases/exponents
    base_res = _limbs_to_residues(base_t, dc)
    a2n_res = _limbs_to_residues(
        to_device(ints_to_limbs(a2n, num_limbs), device), dc
    )
    out_res = rns_kernels.modexp(
        base_res, exp_t, a2n_res, to_device(c1, device),
        to_device(n_bmr, device), dc.kernel, exp_bits,
    )
    v_limbs = _crt_exit_kernel(out_res, dc)
    v_host = v_limbs.cpu().numpy()
    vs = limbs_to_ints(v_host)
    wipe_array(base_t, exp_t, base_res, out_res, v_limbs, v_host)
    return [
        host[r] if r in host else vs[r] % moduli[r] for r in range(len(vs))
    ]


def rns_modmul(
    a: Sequence[int],
    b: Sequence[int],
    moduli: Sequence[int],
    value_bits: int,
    device="cuda",
) -> List[int]:
    """a*b mod moduli row-wise as two launches of kernel 1:
    MontMul(MontMul(a, b), A^2 mod N) = a*b (up to the domain bound),
    then the CRT exit and one reduction mod N per row on the host."""
    if not a:
        return []
    device = torch.device(device)
    num_limbs = -(-value_bits // LIMB_BITS)
    rb = rns_bases_for_bits(value_bits, num_limbs)
    dc = _device_consts(rb, device)
    moduli = list(moduli)
    a = list(a)
    b = list(b)
    c1, n_bmr, a2n, bad = _row_consts(rb, moduli)
    host = {r: a[r] * b[r] % moduli[r] for r in bad}
    for r in bad:
        moduli[r], a[r], b[r] = 3, 1, 1

    def res(xs):
        limbs = ints_to_limbs([x % n for x, n in zip(xs, moduli)], num_limbs)
        return _limbs_to_residues(to_device(limbs, device), dc)

    c1_t = to_device(c1, device)
    nb_t = to_device(n_bmr, device)
    t = rns_kernels.mont_mul(res(a), res(b), c1_t, nb_t, dc.kernel)
    u = rns_kernels.mont_mul(t, res(a2n), c1_t, nb_t, dc.kernel)
    vs = limbs_to_ints(_crt_exit_kernel(u, dc).cpu().numpy())
    return [
        host[r] if r in host else vs[r] % moduli[r] for r in range(len(vs))
    ]
