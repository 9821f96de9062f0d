"""Batched modular exponentiation and multiplication columns.

`distribute`'s per-receiver fan-out and every verifier family are
expressed against a `batch_powm(bases, exps, moduli) -> list[int]`
callable:

- host_powm: CPython pow loop (oracle).
- device_powm_grouped: the device's batch powm (`get_batch_powm`, the
  verifier's `_modexp`): rows that share a (base, modulus) pair in
  groups of at least `_SHARED_MIN_ROWS` take the fixed-base comb
  (device_powm_shared, ops.montgomery.shared_base_modexp), the rest the
  generic engine. device_powm_batches runs it over several batches at
  once, the generic rows of all of them in one segmented launch: what
  powm_columns does with its width batches on the device.
- device_powm: bases^exps mod N per row on the device, through the CIOS
  engine (ops.montgomery, `fsdkr_cios_modexp`) at every width. An H100
  sweep put the CIOS engine ahead of the RNS route at every launch size,
  so the RNS route (ops.rns, kernel 2) takes a launch only inside
  `forced_rns_route()`, within the RNS width classes.
- device_modmul: a*b mod N per row, the same way (`fsdkr_cios_modmul`,
  or kernel 1 in two launches when forced).

Batches are padded to powers of two (>= 8 rows, >= 2 comb groups;
padding rows and groups use modulus 3) so launch shapes repeat across
calls. The CIOS engine's
Montgomery contexts persist in the precompute cache (utils.lru), keyed
by the modulus vector.
"""

from __future__ import annotations

import contextlib
import os as _os
from functools import partial
from typing import Callable, List, Optional, Sequence

from ..config import ProtocolConfig
from ..ops.limbs import WINDOW_BITS, bucket_exp_bits, limbs_for_bits
from ..telemetry.spans import get_tracer
from ..utils.roofline import (
    generic_modexp_macs,
    modmul_macs,
    montmul_macs,
    shared_modexp_macs,
    stamp_generic_host,
)

BatchPowm = Callable[[Sequence[int], Sequence[int], Sequence[int]], List[int]]

# rows per launch: bounds the device staging of one launch
_MAX_ROWS = 16384

# modulus width classes with prepared RNS bases (caps distinct launch
# shapes; moduli bucket up to the nearest class). Wider moduli take a
# multiple of 1024 bits, up to the widest class the RNS kernels are held
# at on the card (7168 bits: kernel 2 holds 4 rows per block there);
# anything wider takes the CIOS engine.
_RNS_WIDTH_CLASSES = (256, 512, 1024, 1536, 2048, 3072, 4096)
_MAX_CLASS_BITS = 7168

# RNS/CIOS routing: a launch of at least _RNS_MIN_ROWS rows within the
# RNS width classes takes the RNS route, a smaller one the CIOS engine.
# On the H100 the CIOS engine was ahead of the RNS route in every cell of
# the sweep (PERF.md section 6, scripts/cuda_route_sweep.py: whole modexp
# and modmul calls at 8-16384 rows, 2048- and 4096-bit moduli, 256- and
# 2048-bit exponents), so the threshold sits above the largest launch and
# only `forced_rns_route()` sends a launch to the RNS route.
_RNS_MIN_ROWS = _MAX_ROWS + 1


@contextlib.contextmanager
def forced_rns_route():
    """Within the block, every device_powm / device_modmul launch within
    the RNS width classes takes the RNS route: for the checks and
    measurements that drive the RNS kernels (chip_smoke.py's RNS path,
    the route sweep, the tests of both routes)."""
    global _RNS_MIN_ROWS
    saved = _RNS_MIN_ROWS
    _RNS_MIN_ROWS = 0
    try:
        yield
    finally:
        _RNS_MIN_ROWS = saved


def _rns_forced() -> bool:
    """Inside `forced_rns_route()`."""
    return _RNS_MIN_ROWS == 0


# A launch's (base, modulus) groups of at least _SHARED_MIN_ROWS rows take
# the fixed-base comb, however few they are; every other row takes the
# generic engine. The JAX package's 4 rows were picked for the TPU. In the
# H100 comb sweep (PERF.md section 6, "The comb sweep";
# scripts/cuda_route_sweep.py --cells comb, the cache cold in every call)
# the comb has the shorter wall in every cell of 256 rows a group from 1
# group up, since the ladder runs one block a group on a full-width-digit
# product (with one warp a group it lost 3 of the 4 cells of 1 group of
# 256 rows), so there is no floor on the group count. Under 256
# rows a group it pays in most cells too, but that floor also decides the
# pair columns' per-receiver groups (16 rows at n=16): PERF.md section 7.
_SHARED_MIN_ROWS = 256


def _width_class(width: int) -> Optional[int]:
    """The RNS width class of a `width`-bit modulus, or None past the
    widest class (those widths take the CIOS engine)."""
    for cls in _RNS_WIDTH_CLASSES:
        if width <= cls:
            return cls
    cls = -(-width // 1024) * 1024
    return cls if cls <= _MAX_CLASS_BITS else None


def _pad_pow2(rows: int) -> int:
    return max(8, 1 << (rows - 1).bit_length())


def _padded(bases, exps, moduli):
    """A launch's rows padded to `_pad_pow2` rows with base 1, exponent 0,
    modulus 3."""
    pad = _pad_pow2(len(bases)) - len(bases)
    return list(bases) + [1] * pad, list(exps) + [0] * pad, list(moduli) + [3] * pad


def _cached_ctx(moduli, num_limbs, device):
    """The CIOS engine's context for a modulus vector on `device`, from
    the precompute cache. A refresh reuses the same modulus vectors across
    many launches and across collect() / distribute_batch() calls of a
    stable committee, so the per-row host precompute (n^{-1} mod R, R^2
    mod N, R mod N) and its upload are paid once per vector. Keyed by a
    hash of the vector with a full equality check on a hit, so a
    collision can only cost a rebuild. The moduli are public, and so is
    everything the context holds."""
    from ..ops.montgomery import BatchModExp
    from ..utils.lru import global_cache

    cache = global_cache()
    key = ("mont-ctx", hash(tuple(moduli)), num_limbs, str(device))
    ctx = cache.get(key) if cache.budget > 0 else None
    if ctx is None or ctx.ctx.moduli != list(moduli):
        ctx = BatchModExp(moduli, num_limbs, device)
        if cache.budget > 0:
            cache.put(key, ctx, ctx.nbytes())
    return ctx


def powm_cache_stats():
    """Counters of the persistent precompute cache (CIOS contexts and the
    RNS route's per-modulus constants): {entries, bytes, budget, hits,
    misses, evictions}."""
    from ..utils.lru import cache_stats

    return cache_stats()


def host_powm(bases, exps, moduli) -> List[int]:
    """Host batched modexp: the system GMP (`native.gmp.powm_batch`,
    rows over the host's cores). Its roofline stamp prices the exponents
    at the modulus width: exponent widths are secret-derived on the
    prover paths and must not shape an exported MAC count."""
    from ..native import gmp

    if bases and get_tracer().enabled:
        mod_bits = max(m.bit_length() for m in moduli)
        stamp_generic_host(len(bases), mod_bits, mod_bits)
    return gmp.powm_batch(list(bases), list(exps), list(moduli))


def _tiled(fn, cols, device) -> List[int]:
    out: List[int] = []
    for lo in range(0, len(cols[0]), _MAX_ROWS):
        out += fn(*(c[lo : lo + _MAX_ROWS] for c in cols), device)
    return out


def device_powm(bases, exps, moduli, device="cuda") -> List[int]:
    """bases^exps mod moduli row-wise on `device` (counterpart of the JAX
    package's tpu_powm)."""
    if not bases:
        return []
    if len(bases) > _MAX_ROWS:
        return _tiled(device_powm, (bases, exps, moduli), device)
    b = len(bases)
    bases, exps, moduli = _padded(bases, exps, moduli)
    width = max(m.bit_length() for m in moduli)
    cls = _width_class(width)
    rns = b >= _RNS_MIN_ROWS and cls is not None
    k = limbs_for_bits(width)
    tracer = get_tracer()
    if tracer.enabled:
        tracer.add_macs(generic_modexp_macs(len(bases), bucket_exp_bits(exps),
                                            cls // 16 if rns else k))
    if rns:
        from ..ops.rns import rns_modexp

        return rns_modexp(bases, exps, moduli, cls, device)[:b]
    return _cached_ctx(moduli, k, device).modexp(bases, exps)[:b]


def device_powm_shared(bases, exps_per_group, moduli, device="cuda") -> List[List[int]]:
    """bases[g]^exps_per_group[g][m] mod moduli[g] through the CIOS comb on
    `device` (counterpart of the JAX package's tpu_powm_shared; the RNS
    comb is not ported). Group count and rows per group are padded to
    powers of two (at least 2 groups and 8 rows: the 4 warps of a comb
    block then share one group; dummy groups use modulus 3, dummy rows
    exponent 0). Launches tile so that the 16 * W * G-row window table
    stays within _MAX_ROWS table rows, run one after another."""
    if not bases:
        return []
    w_cnt = max(1, bucket_exp_bits(e for grp in exps_per_group for e in grp) // WINDOW_BITS)
    m_max = max((len(e) for e in exps_per_group), default=1) or 1
    m_pad = _pad_pow2(m_max)
    budget = _MAX_ROWS
    # power-of-two chunks: a full chunk's padded size is the chunk itself
    row_chunk = max(8, 1 << (budget.bit_length() - 1))
    if m_pad > row_chunk:  # huge groups: tile the row axis
        parts = [
            device_powm_shared(bases, [e[lo : lo + row_chunk] for e in exps_per_group],
                               moduli, device)
            for lo in range(0, m_max, row_chunk)
        ]
        return [[v for part in parts for v in part[i]] for i in range(len(bases))]
    g_cap = max(1, 1 << max(0, min(budget // w_cnt, budget // m_pad).bit_length() - 1))
    if len(bases) > g_cap:  # tile the group axis
        return [
            grp
            for lo in range(0, len(bases), g_cap)
            for grp in device_powm_shared(bases[lo : lo + g_cap],
                                          exps_per_group[lo : lo + g_cap],
                                          moduli[lo : lo + g_cap], device)
        ]
    from ..ops.montgomery import shared_base_modexp

    g = len(bases)
    g_pad = max(2, 1 << (g - 1).bit_length())
    bases = list(bases) + [1] * (g_pad - g)
    moduli = list(moduli) + [3] * (g_pad - g)
    exps = [list(e) + [0] * (m_pad - len(e)) for e in exps_per_group]
    exps += [[0] * m_pad] * (g_pad - g)
    k = limbs_for_bits(max(m.bit_length() for m in moduli))
    get_tracer().add_macs(shared_modexp_macs(g_pad, m_pad, w_cnt, k))
    out = shared_base_modexp(bases, exps, moduli, k, ctx=_cached_ctx(moduli, k, device))
    return [out[i][: len(exps_per_group[i])] for i in range(g)]


def device_powm_grouped(bases, exps, moduli, device="cuda") -> List[int]:
    """Like device_powm, but rows sharing a (base, modulus) pair in groups
    of at least _SHARED_MIN_ROWS take the fixed-base comb, and the rest the
    generic engine as device_powm runs them (counterpart of the JAX package's
    tpu_powm_grouped).
    That is the shape of the collect columns: ring-Pedersen rows share
    (T, N) per message, PDL and range rows (h1 | h2, N~) per receiver.
    Inside `forced_rns_route()` every row takes device_powm (the RNS
    comb is not ported). One batch of `device_powm_batches`."""
    return device_powm_batches([(bases, exps, moduli)], device)[0]


def _comb_rows(bases, exps, moduli, out, device) -> List[int]:
    """The batch's comb groups through device_powm_shared, their results
    into `out`; returns the indices of the other rows."""
    groups: dict = {}
    for i, (b, m) in enumerate(zip(bases, moduli)):
        groups.setdefault((b, m), []).append(i)
    shared = [(key, rows) for key, rows in groups.items() if len(rows) >= _SHARED_MIN_ROWS]
    if shared:
        res = device_powm_shared(
            [key[0] for key, _ in shared],
            [[exps[i] for i in rows] for _, rows in shared],
            [key[1] for key, _ in shared],
            device,
        )
        for (_, rows), vals in zip(shared, res):
            for i, v in zip(rows, vals):
                out[i] = v
    in_comb = {i for _, rows in shared for i in rows}
    return [i for i in range(len(bases)) if i not in in_comb]


def device_powm_batches(batches, device="cuda") -> List[List[int]]:
    """device_powm_grouped over several (bases, exps, moduli) batches at
    once. Each batch's comb groups launch as device_powm_grouped launches
    them; the other rows of every batch share one segmented `cios_modexp`
    launch (`ops.montgomery.modexp_batches`), downloaded once: a segment
    per batch, tiled and padded as device_powm tiles and pads it, on the
    same cached context, so results and cache keys are device_powm's. A
    launch holds at most _MAX_ROWS rows and MAX_SEGMENTS segments; more
    take more launches. Inside `forced_rns_route()` every batch takes
    device_powm."""
    if _rns_forced():
        return [device_powm(*batch, device) for batch in batches]
    from ..ops.montgomery import modexp_batches
    from ..ops.montgomery_kernels import MAX_SEGMENTS

    outs, jobs = [], []  # jobs: (ctx, bases, exps, out, row indices)
    for bases, exps, moduli in batches:
        out: List = [None] * len(bases)
        outs.append(out)
        rest = _comb_rows(bases, exps, moduli, out, device)
        for lo in range(0, len(rest), _MAX_ROWS):
            idx = rest[lo : lo + _MAX_ROWS]
            b, e, m = _padded(*([col[i] for i in idx] for col in (bases, exps, moduli)))
            ctx = _cached_ctx(m, limbs_for_bits(max(x.bit_length() for x in m)), device)
            jobs.append((ctx, b, e, out, idx))

    def launch(group):
        tracer = get_tracer()
        if tracer.enabled:
            tracer.add_macs(sum(generic_modexp_macs(len(b), bucket_exp_bits(e), ctx.ctx.num_limbs)
                                for ctx, b, e, *_ in group))
        for (*_, out, idx), res in zip(group, modexp_batches([j[:3] for j in group])):
            for i, v in zip(idx, res):
                out[i] = v

    group, rows = [], 0
    for job in jobs:
        if group and (rows + len(job[1]) > _MAX_ROWS or len(group) == MAX_SEGMENTS):
            launch(group)
            group, rows = [], 0
        group.append(job)
        rows += len(job[1])
    if group:
        launch(group)
    return outs


def device_modmul(a, b, moduli, device="cuda") -> List[int]:
    """Row-wise a*b mod moduli on `device` (counterpart of the JAX
    package's tpu_modmul)."""
    if not a:
        return []
    if len(a) > _MAX_ROWS:
        return _tiled(device_modmul, (a, b, moduli), device)
    rows = len(a)
    pad = _pad_pow2(rows) - rows
    a = list(a) + [1] * pad
    b = list(b) + [1] * pad
    moduli = list(moduli) + [3] * pad
    width = max(m.bit_length() for m in moduli)
    cls = _width_class(width)
    if rows >= _RNS_MIN_ROWS and cls is not None:
        from ..ops.rns import rns_modmul

        get_tracer().add_macs(modmul_macs(len(a), cls // 16))
        return rns_modmul(a, b, moduli, cls, device)[:rows]
    k = limbs_for_bits(width)
    get_tracer().add_macs(modmul_macs(len(a), k))
    return _cached_ctx(moduli, k, device).modmul(a, b)[:rows]


def _knob_on(name: str) -> bool:
    return _os.environ.get(name, "1").lower() not in ("0", "off", "false", "no")


def multiexp_enabled() -> bool:
    """FSDKRC_MULTIEXP (default on; 0, off, false or no turn it off), read
    at call time: the joint multi-exponentiation layout of the provers'
    commitments and of the verifier's mod-n^2 equations (the JAX package's
    FSDKR_MULTIEXP). Off, every caller takes the per-term column layout."""
    return _knob_on("FSDKRC_MULTIEXP")


def rangeopt_enabled() -> bool:
    """FSDKRC_RANGEOPT (default on, parsed as FSDKRC_MULTIEXP), read at
    call time: the range family's verifier engines (the JAX package's
    FSDKR_RANGEOPT): the u-power s^n * c^{-e} mod n^2 on the
    shared-exponent kernel, one segment a receiver; h1^s1 * h2^s2 mod N~
    by `joint_comb2`; z^{-e} one generic column. Off, the range family
    takes the joint or column layout. Verdicts are the same either way."""
    return _knob_on("FSDKRC_RANGEOPT")


def batch_base_inv(values, moduli) -> List[Optional[int]]:
    """Montgomery-trick batched modular inversion on the host: rows group
    by modulus, one `pow(prod, -1, m)` per group plus about three bigint
    mulmods a row. Returns one entry per row; a non-invertible value
    poisons only its own group, which falls back to per-row inversion and
    reports None for the bad rows: the caller decides what that means (the
    verifier fails the row as the host verifier does). The host sibling of
    the device product tree (ops.montgomery.batch_mod_inv_grouped), with
    the same group-by-modulus and poison-only-its-group policy."""
    groups: dict = {}
    for i, m in enumerate(moduli):
        groups.setdefault(m, []).append(i)
    out: List[Optional[int]] = [None] * len(values)
    for m, idxs in groups.items():
        if m <= 1:
            continue
        # prefix products: pref[j] = v_0 * ... * v_{j-1} mod m
        pref = [1] * (len(idxs) + 1)
        for j, i in enumerate(idxs):
            pref[j + 1] = pref[j] * (values[i] % m) % m
        try:
            inv = pow(pref[-1], -1, m)
        except ValueError:  # some row not invertible: per-row fallback
            for i in idxs:
                try:
                    out[i] = pow(values[i] % m, -1, m)
                except ValueError:
                    out[i] = None
            continue
        for j in range(len(idxs) - 1, -1, -1):
            out[idxs[j]] = pref[j] * inv % m
            inv = inv * (values[idxs[j]] % m) % m
    return out


# Terms a device Straus row: a longer row (the RLC aggregated groups reach
# 2n+1 terms) is split into sub-rows of at most this many terms, which
# share their launches, and the parts are multiplied back on the host.
# Wider moduli take fewer (`montgomery_kernels.multi_modexp_max_terms`:
# one warp's tables must fit a block's shared memory).
_DEVICE_MAX_TERMS = 16


def _term_cap(modulus: int) -> int:
    from ..ops.montgomery_kernels import multi_modexp_max_terms

    k = limbs_for_bits(modulus.bit_length())
    return min(_DEVICE_MAX_TERMS, multi_modexp_max_terms(k + (k & 1)))


def _prod_mod(factors, m) -> int:
    acc = factors[0] % m
    for f in factors[1:]:
        acc = acc * f % m
    return acc


def _host_joint(bases_rows, exps_rows, moduli) -> List[int]:
    """The host's joint rows: every term one row of a GMP batch
    (`native.gmp.powm_batch`), multiplied back; stamped as one shared
    squaring chain a row at the modulus width."""
    from ..native import gmp

    if moduli and get_tracer().enabled:
        mod_bits = max(m.bit_length() for m in moduli)
        stamp_generic_host(len(moduli), mod_bits, mod_bits)
    flat = [(b, e, m) for bs, es, m in zip(bases_rows, exps_rows, moduli)
            for b, e in zip(bs, es)]
    vals = iter(gmp.powm_batch([f[0] for f in flat], [f[1] for f in flat],
                               [f[2] for f in flat]))
    return [_prod_mod([next(vals) for _ in zip(bs, es)], m)
            for bs, es, m in zip(bases_rows, exps_rows, moduli)]


def _joint_rows(bases_rows, exps_rows, moduli, device) -> List[int]:
    """Straus rows of at least 2 terms with non-negative exponents (the
    JAX package's backend.powm._joint_rows), launched in buckets of (term
    count, modulus limbs, each term's bucketed width); device None is the
    host. On the device a row of more terms than its modulus' cap
    (`_term_cap`) is split into sub-rows of at most that many, evaluated
    in one recursion, and its parts multiplied back on the host."""
    if device is None:
        return _host_joint(bases_rows, exps_rows, moduli)
    caps = [_term_cap(m) for m in moduli]
    if any(len(bs) > cap for bs, cap in zip(bases_rows, caps)):
        sub_b: List = []
        sub_e: List = []
        sub_m: List = []
        owners: List[List[int]] = []
        for bs, es, m, cap in zip(bases_rows, exps_rows, moduli, caps):
            slots = []
            for lo in range(0, len(bs), cap):
                slots.append(len(sub_m))
                sub_b.append(tuple(bs[lo : lo + cap]))
                sub_e.append(tuple(es[lo : lo + cap]))
                sub_m.append(m)
            owners.append(slots)
        res = _joint_rows(sub_b, sub_e, sub_m, device)
        return [_prod_mod([res[s] for s in slots], m) for slots, m in zip(owners, moduli)]
    out: List = [None] * len(moduli)
    # a launch's chain is as deep as its widest term, and each term
    # position's windows follow the launch's widest row there: rows of
    # different width shapes take different launches
    buckets: dict = {}
    for i, (bs, es, m) in enumerate(zip(bases_rows, exps_rows, moduli)):
        key = (len(bs), limbs_for_bits(m.bit_length()),
               tuple(bucket_exp_bits([e_t]) for e_t in es))
        buckets.setdefault(key, []).append(i)
    for (t_cnt, _, _), idxs in buckets.items():
        res = _device_joint_launch([tuple(bases_rows[i]) for i in idxs],
                                   [tuple(exps_rows[i]) for i in idxs],
                                   [moduli[i] for i in idxs], t_cnt, device)
        for i, v in zip(idxs, res):
            out[i] = v
    return out


def _device_joint_launch(bases_rows, exps_rows, moduli, t_cnt, device) -> List[int]:
    """One `cios_multi_modexp` launch of t_cnt-term rows, padded as the JAX
    package pads it (base 1, exponent 0, modulus 3 rows to a power of two,
    at least 8); at most _MAX_ROWS rows a launch. No RNS form of the
    Straus kernel is ported, so inside `forced_rns_route()` too these rows
    take the CIOS engine."""
    rows = len(moduli)
    if rows > _MAX_ROWS:
        return [v for lo in range(0, rows, _MAX_ROWS)
                for v in _device_joint_launch(bases_rows[lo : lo + _MAX_ROWS],
                                              exps_rows[lo : lo + _MAX_ROWS],
                                              moduli[lo : lo + _MAX_ROWS], t_cnt, device)]
    from ..ops.montgomery import multi_modexp

    pad = _pad_pow2(rows) - rows
    bases_rows = list(bases_rows) + [(1,) * t_cnt] * pad
    exps_rows = list(exps_rows) + [(0,) * t_cnt] * pad
    moduli = list(moduli) + [3] * pad
    exp_bits = tuple(bucket_exp_bits([e[t] for e in exps_rows]) for t in range(t_cnt))
    k = limbs_for_bits(max(m.bit_length() for m in moduli))
    # the shared chain is as deep as the widest term; every further term
    # adds only its own window lookups and table on top
    extra = sorted(exp_bits, reverse=True)[1:]
    get_tracer().add_macs(
        generic_modexp_macs(len(moduli), max(exp_bits), k)
        + sum(eb // 4 + 15 for eb in extra) * len(moduli) * montmul_macs(k)
    )
    return multi_modexp(bases_rows, exps_rows, moduli, k, exp_bits,
                        ctx=_cached_ctx(moduli, k, device))[:rows]


def multi_powm(bases_rows, exps_rows, moduli, device="cuda") -> List[int]:
    """Joint multi-exponentiation rows: prod_t bases_rows[r][t] ^
    exps_rows[r][t] mod moduli[r] (the JAX package's multi_powm), each term
    routed to the engine that prices it best:

    - negative exponents fold in by inverting the base once
      (batch_base_inv; a non-invertible base raises ValueError: callers
      that need a per-row verdict fold and gate first);
    - terms whose (base, modulus, width class) repeats in at least
      _SHARED_MIN_ROWS instances take the fixed-base comb
      (device_powm_shared);
    - rows left with 2 or more terms take the Straus kernel (_joint_rows);
    - rows left with one term take the generic engine, one segment per
      (width, limbs) bucket of one launch (device_powm_batches);
    - the parts of a row are multiplied here (one device_modmul a part),
      so callers never submit recombination columns.

    Exact: no random linear combination, no assumption on the
    (adversarial) moduli. device None computes on the host (CPython)."""
    rows = len(moduli)
    if rows == 0:
        return []
    neg_idx = [(i, t) for i, es in enumerate(exps_rows) for t, e_t in enumerate(es) if e_t < 0]
    if neg_idx:
        bases_rows = [list(bs) for bs in bases_rows]
        exps_rows = [list(es) for es in exps_rows]
        invs = batch_base_inv([bases_rows[i][t] for i, t in neg_idx],
                              [moduli[i] for i, _ in neg_idx])
        for (i, t), inv in zip(neg_idx, invs):
            if inv is None:
                raise ValueError("multi_powm: negative exponent with non-invertible base")
            bases_rows[i][t] = inv
            exps_rows[i][t] = -exps_rows[i][t]

    # shared bases across all (row, term) instances, split by width class:
    # a comb group's lookups follow its widest exponent
    counts: dict = {}
    for i, (bs, es, m) in enumerate(zip(bases_rows, exps_rows, moduli)):
        for t, (b, e_t) in enumerate(zip(bs, es)):
            counts.setdefault((b, m, bucket_exp_bits([e_t])), []).append((i, t))
    comb_groups = [(key, inst) for key, inst in counts.items()
                   if len(inst) >= _SHARED_MIN_ROWS]
    parts: List[List[int]] = [[] for _ in range(rows)]  # factors a row
    comb_instances = set()
    if comb_groups:
        g_bases = [key[0] for key, _ in comb_groups]
        g_exps = [[exps_rows[i][t] for i, t in inst] for _, inst in comb_groups]
        g_mods = [key[1] for key, _ in comb_groups]
        if device is None:  # the host: each group's rows in one GMP batch
            from ..native import gmp

            res = [gmp.powm_batch([b] * len(es), es, [m] * len(es))
                   for b, es, m in zip(g_bases, g_exps, g_mods)]
        else:
            res = device_powm_shared(g_bases, g_exps, g_mods, device)
        for (_, inst), vals in zip(comb_groups, res):
            for (i, _), v in zip(inst, vals):
                parts[i].append(v)
        comb_instances = {it for _, inst in comb_groups for it in inst}

    loners = [[t for t in range(len(bs)) if (i, t) not in comb_instances]
              for i, bs in enumerate(bases_rows)]
    joint_idx = [i for i in range(rows) if len(loners[i]) >= 2]
    single_idx = [i for i in range(rows) if len(loners[i]) == 1]
    if joint_idx:
        res = _joint_rows([[bases_rows[i][t] for t in loners[i]] for i in joint_idx],
                          [[exps_rows[i][t] for t in loners[i]] for i in joint_idx],
                          [moduli[i] for i in joint_idx], device)
        for i, v in zip(joint_idx, res):
            parts[i].append(v)
    if single_idx:
        buckets: dict = {}
        for i in single_idx:
            (t,) = loners[i]
            w = (bucket_exp_bits([exps_rows[i][t]]), limbs_for_bits(moduli[i].bit_length()))
            buckets.setdefault(w, []).append((i, t))
        batches = [([bases_rows[i][t] for i, t in pairs], [exps_rows[i][t] for i, t in pairs],
                    [moduli[i] for i, _ in pairs]) for pairs in buckets.values()]
        if device is None:
            results = [host_powm(*batch) for batch in batches]
        else:
            # a batch has one width class, so multi_powm's comb groups
            # already hold every (base, modulus) of _SHARED_MIN_ROWS rows
            results = device_powm_batches(batches, device)
        for pairs, res in zip(buckets.values(), results):
            for (i, _), v in zip(pairs, res):
                parts[i].append(v)

    max_parts = max(len(p) for p in parts)
    if max_parts == 1:
        return [p[0] for p in parts]
    if device is None:
        return [_prod_mod(p, m) for p, m in zip(parts, moduli)]
    acc = [p[0] for p in parts]
    for step in range(1, max_parts):
        acc = device_modmul(acc, [p[step] if len(p) > step else 1 for p in parts], moduli,
                            device)
    return acc


def device_powm_shared_exp(bases, exp, modulus, aux_bases=None, aux_exps=None,
                           device="cuda") -> List[int]:
    """bases[r]^exp (* aux_bases[r]^aux_exps[r]) mod modulus: ONE public
    exponent and modulus for every row (the range u-power: each row of a
    receiver's s^n column raises its own base to the receiver's Paillier
    n), the counterpart of the JAX package's tpu_powm_shared_exp. One group
    of `device_powm_shared_exp_groups`."""
    return device_powm_shared_exp_groups([(bases, exp, modulus, aux_bases, aux_exps)],
                                         device)[0]


def device_powm_shared_exp_groups(groups, device="cuda") -> List[List[int]]:
    """device_powm_shared_exp over several groups (bases, exp, modulus,
    aux_bases, aux_exps) at once: every group's main term is a segment of
    one `cios_shared_exp` launch (its modulus and window digits the
    segment's own; rows padded with base 1 to a power of two, groups past
    _MAX_ROWS split; more launches past _MAX_ROWS rows or MAX_SEGMENTS
    segments); every group's aux term rides one generic launch
    (device_powm_batches), and the two meet in one device_modmul. Inside
    `forced_rns_route()` the main terms still take the CIOS kernel (no
    RNS form is ported) and the aux term the RNS route."""
    from ..ops.montgomery import shared_exp_batches
    from ..ops.montgomery_kernels import MAX_SEGMENTS

    outs: List[List] = [[None] * len(g[0]) for g in groups]
    jobs = []  # (ctx, bases, exp, group, first row)
    for gi, (bases, exp, modulus, *_rest) in enumerate(groups):
        if exp < 0:
            raise ValueError("device_powm_shared_exp: exponent must be non-negative")
        ctx = _cached_ctx([modulus], limbs_for_bits(modulus.bit_length()), device)
        for lo in range(0, len(bases), _MAX_ROWS):
            chunk = list(bases[lo : lo + _MAX_ROWS])
            jobs.append((ctx, chunk + [1] * (_pad_pow2(len(chunk)) - len(chunk)), exp, gi, lo))
    group, rows = [], 0
    for job in jobs + [None]:
        if group and (job is None or rows + len(job[1]) > _MAX_ROWS
                      or len(group) == MAX_SEGMENTS):
            get_tracer().add_macs(sum(
                generic_modexp_macs(len(bases), bucket_exp_bits([exp]), ctx.ctx.num_limbs)
                for ctx, bases, exp, *_ in group))
            for (_, bases, _, gi, lo), res in zip(group, shared_exp_batches(
                    [j[:3] for j in group])):
                n_real = min(len(bases), len(outs[gi]) - lo)
                outs[gi][lo : lo + n_real] = res[:n_real]
            group, rows = [], 0
        if job is not None:
            group.append(job)
            rows += len(job[1])

    aux = [gi for gi, g in enumerate(groups) if g[3] is not None and g[0]]
    if aux:
        ab = [b for gi in aux for b in groups[gi][3]]
        ae = [e for gi in aux for e in groups[gi][4]]
        am = [groups[gi][2] for gi in aux for _ in groups[gi][3]]
        main = [v for gi in aux for v in outs[gi]]
        (ap,) = device_powm_batches([(ab, ae, am)], device)
        prod = device_modmul(main, ap, am, device)
        lo = 0
        for gi in aux:
            outs[gi] = prod[lo : lo + len(outs[gi])]
            lo += len(outs[gi])
    return outs


def joint_comb2(base1, exps1, base2, exps2, modulus, device="cuda") -> List[int]:
    """base1^exps1[r] * base2^exps2[r] mod modulus: the 2-term fixed-base
    shape of the mod-N~ equations (h1^s1 * h2^s2 per receiver environment;
    the JAX package's joint_comb2, its device branch). One group of
    `joint_comb2_groups`."""
    return joint_comb2_groups([(base1, exps1, base2, exps2, modulus)], device)[0]


def joint_comb2_groups(groups, device="cuda") -> List[List[int]]:
    """joint_comb2 over several (base1, exps1, base2, exps2, modulus)
    groups: every group's first base in one device_powm_shared call (the
    comb), every second base in another (each at its own exponent width:
    s1 is a third of s2's), then one device_modmul over all rows."""
    for _, e1, _, e2, _ in groups:
        if len(e1) != len(e2):
            raise ValueError("joint_comb2 column length mismatch")
    live = [g for g in groups if g[1]]
    if not live:
        return [[] for _ in groups]
    mods = [g[4] for g in live]
    r1, r2 = (
        [v for grp in device_powm_shared([g[j] for g in live], [list(g[j + 1]) for g in live],
                                         mods, device) for v in grp]
        for j in (0, 2)
    )
    prod = device_modmul(r1, r2, [m for _, e1, _, _, m in live for _ in e1], device)
    outs, lo = [], 0
    for g in groups:
        outs.append(prod[lo : lo + len(g[1])])
        lo += len(g[1])
    return outs


def fold_ladder2(rows, device="cuda") -> List[int]:
    """Merged 2-term shared-base fold rows [((b1, b2), (e1, e2), mod), ...]:
    the h1^S1 * h2^S3 mod N~ row of each PDL RLC group (the JAX package's
    fold_ladder2). Every device route of the JAX package takes plain
    multi_powm here, as this does; its persistent comb-table cache is for
    its host route only."""
    if not rows:
        return []
    return multi_powm([r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows], device)


def crt_powm(bases, exps, moduli, factors, powm=None) -> List[int]:
    """Route for prover-owned moduli (backend.crt). On the host engine
    (`powm` omitted or host_powm), rows whose factorization is supplied
    as factors[i] = (p, q) ride the secret-CRT engine — two fault-checked
    half-width legs on the native host core, exponents reduced mod the
    leg group orders, Garner-recombined — and rows with factors[i] = None
    take host_powm. Any other engine (the card's, on the cuda backend)
    takes the whole column at full width: its kernels beat the host's
    legs there, and with no CRT no leg can fault. The values are the
    same either way: the decomposition is an arithmetic identity."""
    if powm is None:
        powm = host_powm
    from . import crt

    if powm is not host_powm or not any(f is not None for f in factors):
        return powm(bases, exps, moduli)
    contexts = [
        crt.get_context(m, *f) if f is not None else None
        for m, f in zip(moduli, factors)
    ]
    return crt.crt_modexp_batch(
        bases, exps, contexts, fallback=powm, moduli=moduli
    )


def get_batch_powm(config: ProtocolConfig) -> BatchPowm:
    if config.backend == "host":
        return host_powm
    return partial(device_powm_grouped, device=config.torch_device())


def powm_columns(powm: BatchPowm, *columns):
    """Fuse several (bases, exps, moduli) columns into per-width batched
    launches and split the results back.

    Columns are fused ONLY within the same bucketed exponent width AND
    the same modulus limb width: a batch costs sequential depth
    proportional to its widest exponent and is sized by its widest
    modulus, so a narrow column riding a wide batch would pay for the
    width. Identical columns (the PDL and Alice provers both commit
    h1^x mod N~ over the same share column) share one computation.

    Where `powm` is device_powm_grouped bound to a device by `partial`
    (`get_batch_powm`, the verifier's `_modexp`), the batches go to
    device_powm_batches together: each batch is a segment of one
    `cios_modexp` launch, so the batches' chains run side by side.

    A column whose bases and exps entries are TUPLES is a joint column
    (one product of powers a row): all such columns pool into one
    multi_powm pass, on the device route's device, or on the host for any
    other `powm`.
    """
    by_prefix: dict = {}  # cheap prefix -> [column indices]
    alias: dict = {}  # later column index -> first column index
    flat: dict = {}  # width class -> (bases, exps, moduli, [(col, lo, hi)])
    multi: list = []  # (col, lo, hi) spans into the pooled joint rows
    mb, me, mm = [], [], []  # pooled joint multi-exponentiation rows
    for col, (bases, exps, moduli) in enumerate(columns):
        prefix = (
            len(bases),
            bases[0] if bases else 0,
            exps[0] if exps else 0,
            moduli[0] if moduli else 0,
        )
        dup = None
        for prev in by_prefix.get(prefix, ()):
            pb, pe, pm = columns[prev]
            if list(pb) == list(bases) and list(pe) == list(exps) and list(pm) == list(moduli):
                dup = prev
                break
        if dup is not None:
            alias[col] = dup
            continue
        by_prefix.setdefault(prefix, []).append(col)
        if bases and isinstance(bases[0], (tuple, list)):
            multi.append((col, len(mb), len(mb) + len(bases)))
            mb += list(bases)
            me += list(exps)
            mm += list(moduli)
            continue
        w = (
            bucket_exp_bits(exps),
            limbs_for_bits(max(m.bit_length() for m in moduli)) if moduli else 0,
        )
        b, e, m, spans = flat.setdefault(w, ([], [], [], []))
        spans.append((col, len(b), len(b) + len(bases)))
        b += list(bases)
        e += list(exps)
        m += list(moduli)

    batches = list(flat.values())
    device_route = isinstance(powm, partial) and powm.func is device_powm_grouped
    if device_route:
        # the device route: every width batch's generic rows in one launch
        results = device_powm_batches([(b, e, m) for b, e, m, _ in batches],
                                      *powm.args, **powm.keywords)
    else:
        results = [powm(b, e, m) for b, e, m, _ in batches]
    out: list = [None] * len(columns)
    for (_, _, _, spans), res in zip(batches, results):
        for col, lo, hi in spans:
            out[col] = res[lo:hi]
    if multi:
        # the joint columns: one multi_powm pass on the device route's
        # device, else on the host
        device = powm.keywords.get("device", "cuda") if device_route else None
        res = multi_powm(mb, me, mm, device)
        for col, lo, hi in multi:
            out[col] = res[lo:hi]
    for col, dup in alias.items():
        out[col] = list(out[dup])  # fresh list: no aliasing across columns
    return out
