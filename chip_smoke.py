#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fsdkr_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --phases env,kernels   # a short build-and-check

Phases:
  env      nvidia-smi name and power limit, torch/CUDA versions, the
           kernels' build from csrc/ (with nvcc's register report).
  kernels  each hand-written kernel against its plain PyTorch version on
           the card, at k=131 (2048-bit class), k=260 (4096-bit class), the
           6144-bit class (k=389) and the 7168-bit class (k=454, where
           kernel 2 holds 4 rows per block), with row counts that do and do
           not fill the row tiles (kernel 1 also at 1 and 13 rows at every
           class and at the main path's 4096 rows), random and worst-case
           rows: residues must be bit-identical.
  rns      rns_modexp / rns_modmul (through device_powm / device_modmul)
           against CPython pow at 2048- and 4096-bit moduli.
  main     the refresh round at paillier_bits=2048, M=256, 11 correct-key
           rounds, n=16, t=8: simulate_keygen -> distribute_batch (all 16
           senders) -> collect by all 16; t+1 new shares must interpolate
           to the group key; a collect with one tampered PDL proof must
           raise the PDL error naming the sender; both kernels' launch
           counters must be > 0 over distribute + collect.
  time     each kernel against its plain version at every shape the main
           path launched it with (random and worst-case rows, bit-identical
           residues); each kernel timed beside its bound on the H100 at
           every one of those shapes, and at the main path's costliest
           shape beside its plain version too. Two times per launch: `ms`,
           CUDA events around back-to-back wrapper calls (the wrapper's
           host work included where it is the slower side), and
           `device_ms`, the kernel's own device time (torch.profiler).

Prints the kernels line `{"kernels": [...]}` and, last, `{"ok": true,
"device": {...}}`. Any failure exits non-zero with no result line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import random
import subprocess
import sys
import time

PHASES = ("env", "kernels", "rns", "main", "time")

# H100 SXM published peaks (dense): device memory rate and int8 tensor-core
# rate. A 16x16-bit multiply-add counts as four 8-bit multiply-adds of two
# operations each: the least work an exact tensor-core route could do.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs


def rand_moduli(rng, rb, rows, bits):
    """Odd moduli of `bits` bits coprime to every channel prime."""
    import math

    prod = rb.A * rb.B * rb.m_r
    out = []
    while len(out) < rows:
        n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if math.gcd(n, prod) == 1:
            out.append(n)
    return out


def kernel_inputs(rng, rb, dev, rows, exp_bits, worst):
    """Residue tensors for both kernels: random rows, or worst-case rows
    (every residue m-1, every exponent bit set)."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops import rns

    k = rb.k
    m = np.asarray(rb.m_all, np.int64)
    if worst:
        x = np.tile(m - 1, (rows, 1))
        y = x.copy()
        c1 = np.tile(m[:k] - 1, (rows, 1))
        nb = np.tile(m[k:] - 1, (rows, 1))
        exp = np.full((rows, exp_bits // 16), 0xFFFF, np.int64)
    else:
        nrng = np.random.default_rng(rng.getrandbits(32))
        x = nrng.integers(0, m, size=(rows, 2 * k + 1))
        y = nrng.integers(0, m, size=(rows, 2 * k + 1))
        moduli = rand_moduli(rng, rb, rows, rb.value_bits)
        c1, nb, _a2n, _bad = rns._row_consts(rb, moduli)
        exp = nrng.integers(0, 1 << 16, size=(rows, exp_bits // 16))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return t(x), t(y), t(c1), t(nb), t(exp)


# ---------------------------------------------------------------------------
# phases


def phase_env(dev):
    import torch

    from fsdkr_tpu_torch.ops import rns_kernels

    log(smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    rns_kernels.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({rns_kernels.build_info.get('so')})")
    for line in rns_kernels.build_info.get("ptxas", "").splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "smem", "spill",
                                   "stack frame")):
            log(f"  ptxas: {line.strip()}")


def phase_kernels(dev, rng):
    import torch

    from fsdkr_tpu_torch.ops import rns, rns_kernels

    # (bits, rows, kernels): 6144 bits is kernel 2's tightest shared-memory
    # budget at 8 rows per block, 7168 bits holds 4; 13 rows leave a
    # partial last tile, 1 row a tile of one; kernel 1 also at the main
    # path's 4096-row launch
    both, mont = ("mont_mul", "modexp"), ("mont_mul",)
    cases = [(2048, 64, both), (2048, 13, both), (4096, 64, both),
             (6144, 8, both), (7168, 13, both), (2048, 4096, mont),
             (2048, 1, mont), (4096, 1, mont), (4096, 13, mont),
             (6144, 1, mont), (6144, 13, mont), (7168, 1, mont)]
    for bits, rows, names in cases:
        rb = rns.rns_bases_for_bits(bits, bits // 16)
        K = rns._device_consts(rb, dev).kernel
        for worst in (False, True):
            exp_bits = 256
            x, y, c1, nb, exp = kernel_inputs(rng, rb, dev, rows, exp_bits, worst)
            got = rns_kernels.mont_mul(x, y, c1, nb, K)
            want = rns_kernels.mont_mul_plain(x, y, c1, nb, K)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                fail(f"mont_mul k={rb.k} rows={rows} worst={worst}: {bad} residues differ")
            if "modexp" in names:
                got = rns_kernels.modexp(x, exp, y, c1, nb, K, exp_bits)
                want = rns_kernels.modexp_plain(x, exp, y, c1, nb, K, exp_bits)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    fail(f"modexp k={rb.k} rows={rows} worst={worst}: {bad} residues differ")
            log(f"kernels == plain, bit-identical: {'+'.join(names)} k={rb.k} "
                f"rows={rows} exp_bits={exp_bits} worst_case={worst}")


def phase_rns(dev, rng):
    from fsdkr_tpu_torch.backend.powm import device_modmul, device_powm

    for bits, rows in ((2048, 256), (4096, 128)):
        moduli = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(rows)]
        bases = [rng.randrange(n) for n in moduli]
        exps = [rng.getrandbits(2048) for _ in range(rows)]
        exps[0] = 0
        exps[1] = (1 << 2048) - 1
        t0 = time.perf_counter()
        got = device_powm(bases, exps, moduli, dev)
        t1 = time.perf_counter()
        want = [pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]
        if got != want:
            fail(f"device_powm at {bits} bits disagrees with pow")
        got = device_modmul(bases, exps, moduli, dev)
        if got != [b * e % n for b, e, n in zip(bases, exps, moduli)]:
            fail(f"device_modmul at {bits} bits disagrees with a*b % n")
        log(f"rns_modexp == pow, rns_modmul == a*b % n: {rows} rows of "
            f"{bits}-bit moduli, 2048-bit exponents ({t1 - t0:.3f} s on the card)")


def phase_main(dev, n=16, t=8, bits=2048, m_security=256, rounds=11):
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.errors import PDLwSlackProofError
    from fsdkr_tpu_torch.ops import rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage, simulate_keygen

    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    times = {}
    t0 = time.perf_counter()
    keys = simulate_keygen(t, n, config)
    times["keygen"] = time.perf_counter() - t0
    log(f"main: simulate_keygen t={t} n={n}: {times['keygen']:.3f} s")

    rns_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], n, config)
    times["distribute"] = time.perf_counter() - t0
    log(f"main: distribute_batch, {n} senders: {times['distribute']:.3f} s")
    msgs = [m for m, _ in out]
    spare = (copy.deepcopy(keys[0]), copy.deepcopy(out[0][1]))
    spare2 = (copy.deepcopy(keys[1]), copy.deepcopy(out[1][1]))

    per_collect = []
    t0 = time.perf_counter()
    for key, (_, dk) in zip(keys, out):
        c0 = time.perf_counter()
        RefreshMessage.collect(msgs, key, dk, config)
        per_collect.append(time.perf_counter() - c0)
    times["collect_total"] = time.perf_counter() - t0
    counts = rns_kernels.launch_counts()
    # the shapes of this window's launches, before the checks below add
    # their own
    shapes = (dict(rns_kernels.mont_mul.shapes), dict(rns_kernels.modexp.shapes))
    log(f"main: {n} collects: {times['collect_total']:.3f} s "
        f"(each {min(per_collect):.3f}..{max(per_collect):.3f} s)")
    log(f"main: launches over distribute + collect: {counts}")
    if not all(v > 0 for v in counts.values()):
        fail(f"a kernel of the main path never launched: {counts}")

    # t+1 new shares interpolate to the unchanged group key
    idx = list(range(t + 1))
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(t, n)).reconstruct(
        idx, [keys[i].keys_linear.x_i for i in idx]
    )
    if GENERATOR * secret != keys[0].y_sum_s:
        fail("new shares do not reconstruct the group key")
    if any(k.pk_vec != keys[0].pk_vec for k in keys):
        fail("parties disagree on the new pk_vec")
    log("main: t+1 new shares reconstruct the group key; pk_vec agreed")

    # one tampered PDL proof must be blamed on its sender
    bad = copy.deepcopy(msgs)
    sender = n // 3
    p = bad[sender].pdl_proof_vec[n // 5]
    bad[sender].pdl_proof_vec[n // 5] = type(p)(
        z=p.z, u1=p.u1, u2=p.u2, u3=p.u3, s1=p.s1 + 1, s2=p.s2, s3=p.s3
    )
    t0 = time.perf_counter()
    try:
        RefreshMessage.collect(bad, spare[0], spare[1], config)
    except PDLwSlackProofError as e:
        if e.party_index != bad[sender].party_index:
            fail(f"PDL error blames party {e.party_index}, "
                 f"expected {bad[sender].party_index}")
        log(f"main: tampered collect raised {e!r}")
    else:
        fail("a tampered PDL proof passed collect")
    times["tampered_collect"] = time.perf_counter() - t0
    # the tampered collect failed before adoption, so the spare key is
    # still pre-collect: profile one honest collect on it
    if dev.type == "cuda":
        profile_collect(msgs, spare, config, sorted(per_collect)[n // 2])
    span_collect(msgs, spare2, config)
    return counts, shapes, times, per_collect


# the layers of one collect, timed from here by wrapping the callables the
# protocol and verifier look up by name: (module path, attribute, class)
_SPANS = (
    ("fsdkr_tpu_torch.protocol.refresh", "check_structure", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "validate_feldman", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_pairs", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_pdl_u1_host", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "batch_inv", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_ring_pedersen", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.protocol.refresh", "share_recovery_check", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_correct_key", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.protocol.refresh", "adopt_session", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "device_powm", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "device_modmul", None),
)
# the steps inside device_powm / device_modmul (ops/rns.py's globals); each
# of these spans ends in torch.cuda.synchronize(), so it holds its own
# device work. The kernel wrappers are wrapped in the `rns_kernels` name
# that ops/rns.py looks up, never in rns_kernels itself: the raw wrapper
# bumps its counter through its own global name.
_RNS_SPANS = ("_row_consts", "ints_to_limbs", "_to_device", "_limbs_to_residues",
              "_crt_exit_kernel", "limbs_to_ints")


def span_collect(msgs, spare, config):
    """Wall time of each layer inside one collect (inclusive and self
    seconds, by parent span). device_powm / device_modmul end in a host
    copy of their result, so their spans include the device time. Inside
    them, every step's span ends in a synchronize, so the device work
    falls in the step that queued it; what the columns keep as self time
    is the download of the result limbs (between `_crt_exit_kernel` and
    `limbs_to_ints`) and the Python between the steps. Which steps wait
    on the device without that synchronize: `_to_device` (a copy from
    pageable host memory synchronises its stream) and `_crt_exit_kernel`
    (its carry loop reads `bool(hi.any())`)."""
    import importlib
    import types

    import torch

    from fsdkr_tpu_torch.ops import rns, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage

    stack, totals, patched = [], {}, []

    def wrap(name, fn, sync=False):
        def timed(*args, **kwargs):
            parent = stack[-1][0] if stack else "collect"
            stack.append([name, 0.0])
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                dt = time.perf_counter() - t0
                _, child = stack.pop()
                if stack:
                    stack[-1][1] += dt
                tot = totals.setdefault((parent, name), [0, 0.0, 0.0])
                tot[0] += 1
                tot[1] += dt
                tot[2] += dt - child
        return timed

    for mod_name, attr, cls_name in _SPANS:
        owner = importlib.import_module(mod_name)
        if cls_name:
            owner = getattr(owner, cls_name)
        raw = owner.__dict__[attr]
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw
        new = wrap(attr, fn)
        patched.append((owner, attr, raw))
        setattr(owner, attr, staticmethod(new) if isinstance(raw, staticmethod) else new)
    for attr in _RNS_SPANS:
        patched.append((rns, attr, getattr(rns, attr)))
        setattr(rns, attr, wrap(attr, getattr(rns, attr), sync=True))
    proxy = types.SimpleNamespace(**vars(rns_kernels))
    proxy.mont_mul = wrap("kernel 1 mont_mul", rns_kernels.mont_mul, sync=True)
    proxy.modexp = wrap("kernel 2 modexp", rns_kernels.modexp, sync=True)
    patched.append((rns, "rns_kernels", rns_kernels))
    rns.rns_kernels = proxy
    try:
        t0 = time.perf_counter()
        RefreshMessage.collect(msgs, spare[0], spare[1], config)
        wall = time.perf_counter() - t0
    finally:
        for owner, attr, raw in patched:
            setattr(owner, attr, raw)
    top = sum(tot[1] for (parent, _), tot in totals.items() if parent == "collect")
    log(f"spans: one collect {wall:.3f} s; outside the spans {wall - top:.3f} s")
    for (parent, name), (calls, incl, own) in totals.items():
        log(f"spans:   {parent:>22} > {name:<22} calls {calls:3d}  "
            f"incl {incl:8.3f} s  self {own:8.3f} s")


def profile_collect(msgs, spare, config, median_s):
    """Device time by kernel over one collect (torch.profiler), beside
    the collect's wall time: the device's busy and idle share. The
    profiler slows the host side, so the share is given against the
    median collect without it as well."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fsdkr_tpu_torch.protocol import RefreshMessage

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        RefreshMessage.collect(msgs, spare[0], spare[1], config)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device events only (kernels, memcpy, memset): a CPU op's row repeats
    # the device time of the kernels it launched
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        log("profile: torch.profiler saw no device time (not measured)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile: one collect, wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of it; "
        f"{100 * busy_ms / (median_s * 1e3):.1f}% of the median unprofiled "
        f"collect, {median_s * 1e3:.1f} ms)")
    for name, ms in top:
        log(f"profile:   {ms:10.3f} ms  {name[:90]}")
    for name, symbol in _SYMBOL.items():
        ms = sum(v for key, v in by_name.items() if symbol in key)
        log(f"profile: {name} device time in this collect: {ms:.3f} ms")


def _events_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# each kernel's symbol: a substring of its device events' (mangled) names
_SYMBOL = {"rns_mont_mul": "rns_mont_mul_kernel", "rns_modexp": "rns_modexp_kernel"}


def _device_ms(fn, reps, name):
    """The kernel's own time per launch: the same `reps` calls as
    `_events_ms`, under torch.profiler, summing the self device time of
    the device events whose name holds the kernel's symbol, over the
    launches the profiler recorded (it may miss the first few of a
    window). The events time above also holds the wrapper's host work
    wherever that is slower than the kernel; this does not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # one warm-up step with the profiler armed, then the recorded step
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule,
                 on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    us, launches = 0.0, 0
    for ev in (recorded[0] if recorded else ()):
        if ev.device_type == DeviceType.CUDA and _SYMBOL[name] in ev.key:
            us += getattr(ev, "self_device_time_total", 0) or 0
            launches += ev.count
    if not 0 < launches <= reps or us <= 0:
        fail(f"the profiler saw {launches} launches of {_SYMBOL[name]} "
             f"({us} us) over {reps} calls")
    return us / 1e3 / launches


def _bits_of_k(k):
    from fsdkr_tpu_torch.ops import rns

    return next(b for b in (256, 512, 1024, 1536, 2048, 3072, 4096, 5120,
                            6144, 7168)
                if rns.rns_bases_for_bits(b, b // 16).k == k)


def _max_err(got, want):
    import torch

    torch.cuda.synchronize()
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_main_shapes(dev, rng, mm_shapes, me_shapes):
    """Each kernel against its plain version at every shape the main path
    launched it with, random and worst-case rows; returns the largest
    absolute residue difference of each kernel (0 when bit-identical)."""
    from fsdkr_tpu_torch.ops import rns, rns_kernels

    errs = {"rns_mont_mul": 0, "rns_modexp": 0}
    t0 = time.perf_counter()
    shapes = [("rns_mont_mul", k, rows, 256) for k, rows in sorted(mm_shapes)]
    shapes += [("rns_modexp", *s) for s in sorted(me_shapes)]
    for name, k, rows, exp_bits in shapes:
        bits = _bits_of_k(k)
        rb = rns.rns_bases_for_bits(bits, bits // 16)
        K = rns._device_consts(rb, dev).kernel
        for worst in (False, True):
            x, y, c1, nb, exp = kernel_inputs(rng, rb, dev, rows, exp_bits, worst)
            if name == "rns_mont_mul":
                err = _max_err(rns_kernels.mont_mul(x, y, c1, nb, K),
                               rns_kernels.mont_mul_plain(x, y, c1, nb, K))
            else:
                err = _max_err(
                    rns_kernels.modexp(x, exp, y, c1, nb, K, exp_bits),
                    rns_kernels.modexp_plain(x, exp, y, c1, nb, K, exp_bits))
            if err:
                fail(f"{name} disagrees with its plain version at k={k} "
                     f"rows={rows} exp_bits={exp_bits} worst_case={worst}")
            errs[name] = max(errs[name], err)
    log(f"time: both kernels == plain, bit-identical, at all {len(shapes)} "
        f"main-path shapes, random and worst-case rows "
        f"({time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"{n} k={k} rows={r}" + (f" exp_bits={e}" if n == "rns_modexp" else "")
                    for n, k, r, e in shapes))
    return errs


def bound_ms(name, k, rows, exp_bits):
    """The least time the H100 could take for one launch: (ms, "bytes" or
    "operations"). Bytes: each input read once, each output written once,
    the shared constants once. Operations: the base extensions' 2k(k+1)
    multiply-adds per product per row, each four 8-bit ones."""
    C = 2 * k + 1
    macs_per_product = 2 * k * (k + 1)
    const_bytes = 4 * (2 * k * (k + 1) + C + (k + 1) + 2 * k)
    if name == "rns_mont_mul":
        products = rows
        in_out_bytes = 4 * rows * (3 * C + 2 * k + 1)
    else:
        products = rows * (17 + 5 * exp_bits // 4)
        in_out_bytes = 4 * rows * (3 * C + exp_bits // 16 + 2 * k + 1)
    ops_ms = products * macs_per_product * 4 * 2 / INT8_OPS_PER_S * 1e3
    bytes_ms = (in_out_bytes + const_bytes) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


# launches per timing: kernel 2's take milliseconds each, kernel 1's
# microseconds
_REPS = {"rns_mont_mul": 200, "rns_modexp": 10}


def _time_launch(name, K, args, exp_bits):
    """(events ms, device ms) per launch of the kernel's wrapper."""
    from fsdkr_tpu_torch.ops import rns_kernels

    x, y, c1, nb, exp = args
    if name == "rns_mont_mul":
        def fn():
            return rns_kernels.mont_mul(x, y, c1, nb, K)
    else:
        def fn():
            return rns_kernels.modexp(x, exp, y, c1, nb, K, exp_bits)
    return _events_ms(fn, _REPS[name]), _device_ms(fn, _REPS[name], name)


def time_main_shapes(dev, rng, mm_shapes, me_shapes):
    """Each kernel's time (CUDA events and device time) and bound at
    every shape the main path launched it with; returns rows of the
    per-shape table."""
    from fsdkr_tpu_torch.ops import rns

    table = []
    shapes = [("rns_mont_mul", k, rows, 256, n) for (k, rows), n in sorted(mm_shapes.items())]
    shapes += [("rns_modexp", *s, n) for s, n in sorted(me_shapes.items())]
    for name, k, rows, exp_bits, launches in shapes:
        bits = _bits_of_k(k)
        rb = rns.rns_bases_for_bits(bits, bits // 16)
        K = rns._device_consts(rb, dev).kernel
        args = kernel_inputs(rng, rb, dev, rows, exp_bits, False)
        ms, dms = _time_launch(name, K, args, exp_bits)
        bound, by = bound_ms(name, k, rows, exp_bits)
        log(f"time: per shape {name} k={k} rows={rows}"
            + (f" exp_bits={exp_bits}" if name == "rns_modexp" else "")
            + f": events {ms:.4f} ms, device {dms:.4f} ms, bound {bound:.6f} ms "
            f"({by}), device {dms / bound:.1f}x bound, {launches} launches")
        table.append({"name": name, "k": k, "rows": rows, "exp_bits": exp_bits,
                      "launches": launches, "ms": ms, "device_ms": dms,
                      "bound_ms": bound})
    return table


def phase_time(dev, rng, counts, shapes):
    """`counts` and `shapes` are the main path's launch counts, in total
    and by shape ((k, rows) and (k, rows, exp_bits) -> launches)."""
    from fsdkr_tpu_torch.ops import rns, rns_kernels

    mm_shapes, me_shapes = shapes
    if not mm_shapes or not me_shapes:
        fail("no main-path launch shapes recorded")
    errs = check_main_shapes(dev, rng, mm_shapes, me_shapes)
    per_shape = time_main_shapes(dev, rng, mm_shapes, me_shapes)
    # the kernels line: each kernel at its costliest shape on the main path
    k1, r1 = max(mm_shapes, key=lambda s: s[0] * s[0] * s[1] * mm_shapes[s])
    k2, r2, e2 = max(
        me_shapes, key=lambda s: s[0] * s[0] * s[1] * s[2] * me_shapes[s]
    )
    out = []
    for name, (k, rows, exp_bits) in (
        ("rns_mont_mul", (k1, r1, 256)), ("rns_modexp", (k2, r2, e2)),
    ):
        bits = _bits_of_k(k)
        rb = rns.rns_bases_for_bits(bits, bits // 16)
        K = rns._device_consts(rb, dev).kernel
        x, y, c1, nb, exp = args = kernel_inputs(rng, rb, dev, rows, exp_bits, False)
        if name == "rns_mont_mul":
            ms, dms = _time_launch(name, K, args, exp_bits)
            plain_ms = _events_ms(
                lambda: rns_kernels.mont_mul_plain(x, y, c1, nb, K), 20)
            shape = f"k={k} rows={rows}"
        else:
            ms, dms = _time_launch(name, K, args, exp_bits)
            plain_ms = _events_ms(
                lambda: rns_kernels.modexp_plain(x, exp, y, c1, nb, K, exp_bits), 1)
            shape = f"k={k} rows={rows} exp_bits={exp_bits}"
        bound, by = bound_ms(name, k, rows, exp_bits)
        log(f"time: {name} at {shape}: events {ms:.4f} ms, device {dms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")
        out.append({
            "name": name,
            "route": "cuda",
            "source": "fsdkr_tpu_torch/csrc/rns_kernels.cu",
            "replaces": ("fsdkr_tpu/ops/pallas_rns.py:184" if name == "rns_mont_mul"
                         else "fsdkr_tpu/ops/pallas_rns.py:317"),
            "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "device_ms": dms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
            "shape": shape,
            "per_shape": [{key: row[key] for key in ("k", "rows", "exp_bits", "launches",
                                                     "ms", "device_ms", "bound_ms")}
                          for row in per_shape if row["name"] == name],
        })
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        fail(f"unknown phase in {phases}")

    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "fsdkr_tpu_torch")):
        fail("fsdkr_tpu_torch is not beside this script: run it from a checkout")
    sys.path.insert(0, here)
    import fsdkr_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False  # no float32 on this path
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = random.Random(args.seed)
    t_start = time.perf_counter()

    counts, shapes, kernels = None, None, []
    if "env" in phases:
        phase_env(dev)
    if "kernels" in phases:
        phase_kernels(dev, rng)
    if "rns" in phases:
        phase_rns(dev, rng)
    if "main" in phases:
        counts, shapes, times, per_collect = phase_main(dev)
        log("main: phase seconds " + json.dumps(
            {**times, "collect_each": per_collect}))
    if "time" in phases:
        if counts is None:
            fail("the time phase needs the main phase's launch counts")
        kernels = phase_time(dev, rng, counts, shapes)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
