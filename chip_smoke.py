#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fsdkr_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --phases env,kernels   # a short build-and-check

Phases:
  env      nvidia-smi name and power limit, torch/CUDA versions, the
           kernels' builds from csrc/ (the sources compiled at once, with
           nvcc's register report; `ec_scalar_mul_kernel`'s registers and
           spill bytes on a line of their own, and each instantiation's of
           the joint kernels, `cios_multi_modexp_kernel` and
           `cios_shared_exp_kernel`); the host cores' g++ builds beside
           them; libgmp's path and `__gmp_version`, and the native core's
           Montgomery engine, which must read "mpn".
  kernels  each hand-written kernel against its plain PyTorch version on
           the card. The RNS kernels at k=131 (2048-bit class), k=260
           (4096-bit class), the 6144-bit class (k=389) and the 7168-bit
           class (k=454, where kernel 2 holds 4 rows per block), with row
           counts that do and do not fill the row tiles (kernel 1 also at
           1 and 13 rows at every class and at the main path's 4096 rows);
           the three CIOS kernels at K=16, 128, 130, 256, 512, 1022 and
           1024 limbs on 1 and 13 rows, and at K=16 and 512 on 256 rows
           (130 and 1022: an odd word count; the main path's shapes cover
           K=128 and 256 at 256 rows and more, in the `time` phase). Random
           rows (with a modulus-3 row and a zero exponent) and worst-case
           rows (every limb of x and y at n-1, every exponent bit set):
           results must be bit-identical. The segmented `cios_modexp`
           launch over mixed segments (K=128 and 256, 256- to 3072-bit
           exponents, 8-512 rows, each half random and half worst-case)
           against the plain version per segment. `cios_mont_mul` on both
           sides of the rows from which its launch rule takes the sub-warp
           kernel (R*, `rows_rule`), at K=128 and 256. `cios_comb` (the
           sub-warp kernel at the rule's lanes a row: 8, 16 and 32 all
           occur) at K=16, 128, 130, 256, 512 and 1024 on groups x rows
           per group 1 x 8, 3 x 13, 2 x 257 (ragged row tiles) and 16 x
           256 (the main path's), and `cios_comb_ladder` (one block a
           group) at K=16, 128, 130, 256, 512, 1022 and 1024 on 1, 3 and
           16 groups, at the launch rule's threads a block and at each of
           128, 256 and 512; random and worst-case groups (every limb of
           the table and the base at n-1, every exponent bit set).
           `cios_modmul` as `cios_mont_mul`, on both sides of R*.
           Device EC: `ec_scalar_mul` at 1, 13, 256, 1024 and 4096 rows
           (13: a partly filled block of 4 rows on 8 lanes each), 128-
           and 256-bit scalars (the edge scalars 0, 1, 7, N - 1 and
           2^128 - 1, G and the identity among the points, a quarter of
           the rows worst-case: every digit of N - 1 or 2^128 - 1);
           `ec_tree_sum` at (groups, rows) (1, 1),
           (1, 2), (3, 8), (16, 32) and (1, 1024) on points of random Z,
           with cancelling pairs, doublings and identity pads.
           The joint path's kernels, each case at the launch rule's
           layout and one warp a row, one block a row at 256 and 512
           threads: `cios_multi_modexp` at the
           collect's joint launch (K=256, 512 rows, widths (2048, 256)),
           the default collect's shape at 265 rows (a partial last
           wave), the distribute's two (K=128, 512 rows, (2560, 256) and
           (3072, 768)), 16 terms of 128-384 bits at K=128, and at K=16,
           130, 512 and 1024 on 1 and 13 rows with the most terms a
           block's shared memory holds (16, 16, 12, 5), half the rows
           worst-case; `multi_powm` rows of 14 terms at 8192 bits and 7
           at 16384 bits (past those caps: two launches each) against
           pow; `cios_shared_exp` over 16 segments of 16 rows at K=256
           with 2048-bit exponents (the u-power's launch), one such
           segment, and three mixed segments at K=16, 130 and 1024, the
           first modulo 3, the last worst-case.
  routes   device_powm / device_modmul (every launch through the CIOS
           engine, as routed) and the RNS route itself against CPython pow
           at 2048- and 4096-bit moduli; both entry points at 8192-bit
           moduli (past the RNS classes); device_powm_grouped (comb
           groups and loners) at 2048, 4096 and 8192 bits.
  host     the host bignum layer, bit for bit: `gmp.powm_batch`, plain
           and secret, against CPython pow on 64 rows at (2048-bit
           exponent, 4096-bit n^2), (1088-bit legs: a 1024-bit prime
           times the 64-bit check prime) and (256-bit exponent, 4096-bit),
           with an exponent 0, a base 0 and a base above the modulus;
           `gmp.gcd` against math.gcd on the generation sieve's primorial
           (its cached operand and the plain integer); the native core on
           libgmp's mpn functions against its portable loop
           (`native.set_mpn(0)`) on Miller-Rabin verdicts (Mersenne and
           generated primes, Carmichael numbers, products),
           `crt_modexp_batch` at the first two shapes and `modexp_shared`;
           native EC against the Python points: Horner at t=8 and t=128
           over 16 indices, `lincomb2` with identity, negation and a+b=0
           rows. Prints ms per op of CPython, GMP, the portable loop and
           mpn at the first shape (one thread, and GMP and mpn at
           `native.thread_count()`), with the host's CPU model.
  main     on the column path (FSDKRC_RLC=0, FSDKRC_MULTIEXP=0,
           FSDKRC_RANGEOPT=0, so that its gates and PERF.md's history stay
           comparable; the RNS path below too):
           the refresh round at paillier_bits=2048, M=256, 11 correct-key
           rounds, n=16, t=8: simulate_keygen -> distribute_batch (all 16
           senders) -> collect by all 16; t+1 new shares must interpolate
           to the group key; a collect with one tampered PDL proof must
           raise the PDL error naming the sender; the routing's kernels
           (every launch takes the CIOS engine; the ring-Pedersen
           column's 16 groups of 256 rows sharing (T, N) take the comb)
           must each launch over
           distribute + collect; launches per collect are
           printed for every kernel, and `cios_modexp` must launch twice a
           collect (once per `powm_columns` call or column: the pair
           families' columns, then correct-key's), `cios_comb` and
           `cios_comb_ladder` once each (the ring-Pedersen column); after
           the first collect, the precompute
           cache must see no miss (every modulus's constants computed
           once). Device EC: `ec_scalar_mul` launches 3 times in
           distribute (the Feldman commitments, the commit points, the
           PDL prover's u1) and 3 times a collect, `ec_tree_sum` 0 and
           3 (the Feldman, PDL u1 and pk_vec MSMs); an honest collect
           calls the per-row host u1 check no time. Then the RNS
           route's path, the earlier slices' main path cut to one
           collect (it takes device EC too): inside forced_rns_route(), both RNS
           kernels' counters zeroed just before it and read just after,
           distribute_batch by the same 16 senders (from their keys as
           they stood before the routed distribute) and one collect of
           its messages, timed layer by layer (kernel 2 must launch 15
           times, kernel 1 14); that party's collect of the same messages
           through the CIOS engine must adopt the same key.
  joint    the joint path (FSDKRC_MULTIEXP and FSDKRC_RANGEOPT on, at
           FSDKRC_RLC=0), from main's keys before its distribute:
           every counter zeroed, distribute_batch by all 16 senders and
           16 collects, the counters read; the launches per distribute
           and per collect of every kernel must be JOINT_DISTRIBUTE and
           JOINT_COLLECT (PERF.md section 2), the Straus and
           shared-exponent kernels among them; t+1 new shares give the
           group key; a party's collect of the same messages on the
           column path adopts the same LocalKey; a tampered PDL row and a
           tampered range row raise what the column path raises (class,
           party, the PDL verdict tuple). Profiles one collect and times
           another layer by layer.
  rlc      the RLC path, the defaults (FSDKRC_RLC, FSDKRC_MULTIEXP and
           FSDKRC_RANGEOPT on), verifier only, on the joint phase's
           messages and its keys and dks before any collect: every
           counter and the fold counters zeroed, 16 collects, the counters
           read; launches a collect must be RLC_COLLECT, with no RNS
           launch, and the fold counters RLC_STATS (64 groups, one
           full-width ladder each, no bisection); t+1 new shares give the
           group key; a party's collect of the same messages at
           FSDKRC_RLC=0 adopts the same LocalKey; tampered PDL s1, PDL
           s2, range s, ring-Pedersen Z[0] and correct-key sigma[0] raise
           what FSDKRC_RLC=0 raises (class, party, PDL verdict tuple);
           verify_pairs with one bad PDL s2 row (sender 7 to receiver 3)
           gives FSDKRC_RLC=0's whole verdict vector, (True, False, True)
           at that row, through a bisection on the host. Profiles one
           collect and times another layer by layer.
  trace    the span tracer (telemetry.spans) on the rlc phase's inputs:
           one default collect at n=16 with the tracer enabled, its
           Chrome trace written to chiprun_out/collect_trace.json; gates:
           the protocol and family spans with their items are
           `collect_spans(n, M, rounds)` (the list tests/test_torch_trace.py
           holds against the JAX package's at n=3), each span inside its
           parent's interval, every phase that launched a kernel
           (`ops.tally.by_phase`) carrying MACs, and the adopted key the
           rlc phase's untraced collect's, and `collect.share_recovery`'s
           Paillier rows (encrypt(0) and t+1 homomorphic muls) in GMP
           (its seconds printed); a second traced collect at
           FSDKRC_MEM_BUDGET_MB=2 (memory-plan tiles): the tiles' staging
           spans on the prefetch worker parent to `pairs.stream_tiles`,
           and the same key. Prints each phase's seconds and MFU on
           `utils.roofline.H100_PEAK_MACS`, and the collect's median wall
           over 5 runs with the tracer off and 5 with it on, each after
           a `gc.collect()` (not gated).
  join     join, replace and removal under the defaults, from main's keys
           before its distribute, as the reference's add-party scenario:
           parties 2 and 16 leave, the 14 survivors are remapped onto
           their own indices reversed, two JoinMessage.distribute take
           indices 2 and 16, then 14 replaces, 14 collects with both
           joins and 2 JoinMessage.collect, each call's launches gated
           (JOIN_DISTRIBUTE, JOIN_REPLACE, JOIN_COLLECT, JOIN_JOINER);
           the keys' indices are 1..16, t+1 new shares holding both
           joiners reconstruct the old secret and the group key, one
           pk_vec with pk_vec[i-1] == G x_i, a quorum of t+1 holding both
           joiners signs (simulate_offline_stage, simulate_signing), and a
           joiner's tampered composite-dlog y and correct-key sigma raise
           DLogProofValidation and PaillierVerificationError naming it.
  sessions the barrier collect in full under the defaults (FSDKRC_RLC
           on, the memory plan's budget from the card), on the rlc
           phase's messages, keys and dks before any collect, beside the
           keys its 16 collects adopted, and on the join phase's round:
           (a) the 16 receivers in one `collect_sessions` call, each
           adopting its own collect's key, 3,840 pair rows deduped, the
           pair launches one collect's, the call's launches
           SESSIONS_FUSED; (b) the round fused with the join round (its
           RLC groups merge with the survivors'), both adopting their own
           collects' keys (launches SESSIONS_TWO), then the join round's
           PDL s2 row of its fifth sender to receiver 4 tampered: that
           session gets the error its own collect raises, the other
           adopts, and the merged group bisects session-first; (c) a
           collect at FSDKRC_MEM_BUDGET_MB=2, its pair rows in 4 tiles
           (81, 81, 81, 13), the monolithic key and full-width ladders,
           launches SESSIONS_TILED, a tampered PDL s2 row raising what
           the monolithic collect raises. Every counter
           zeroed before the gated calls and read after them; each case's
           wall time and device busy time beside the unfused or monolithic
           call's; the device memory verify_pairs allocates
           (torch.cuda.max_memory_allocated) at 256 rows and in 81-row
           tiles, beside the plan's estimate, and a gate that the default
           budget cuts none of 256, 16,384 and 65,536 rows and holds
           their projected peaks.
  stream   the streaming collect and the JSON wire under the defaults, on
           the rlc phase's messages, keys and dks before any collect,
           beside the keys its collects adopted: (a) a receiver's
           `collect_stream` with every message through
           `refresh_message_from_json`, offered in a seeded shuffle with a
           duplicate, an unexpected sender and a late message: the
           statuses, `local_key_to_json` of the adopted key byte for byte
           the barrier collect's, each accepted offer's launches
           STREAM_OFFER and the finalize's STREAM_FINALIZE; five such
           streams timed: each offer's wall, the post-quorum latency (the
           last offer's return to finalize's return) beside barrier
           collects' in the same call (five back to back, then one after
           each stream), once with a gc.collect() before each timed call
           and once with the collector left to run as it falls; a
           tampered ring-Pedersen proof and a tampered PDL row raise what
           barrier collect raises, with the same blame. (b)
           `finalize_streams` over four receivers' sessions against
           `collect_sessions` of the same four: the keys, `rlc.stats()`
           (offers and finalize) equal to the fused call's, the
           finalize's launches STREAM_FUSED. Device busy time of one
           stream's offers, of its finalize and of one barrier collect
           (torch.profiler).
  prover   the prover path under the defaults, on a committee of its own
           (simulate_keygen at n=16, its primes through GMP: every sieved
           candidate a `gmp.gcd`, every Miller-Rabin round a `gmp.powm`):
           (a) the inline distribute (no committee prefilled) timed by
           `span_distribute` under the JAX package's phase names: its
           primes through GMP as keygen's, S = T^lambda on the
           fault-checked CRT legs (n rows, 2n `mpz_powm_sec` rows), no
           pool touched, the launches JOINT_DISTRIBUTE; (b)
           `precompute.prefill` for the committee, then a distribute: its
           online wall and the takes by kind, no pool dry; (c) the pooled
           messages collected by all 16: the group key unchanged, a
           tampered pooled PDL proof blamed on its sender.
           `scripts/distribute_spans.py --tree DIR` times a distribute the
           same way for another tree (a parent commit).
  serve    the serving layer's in-process core at full width: two
           committees (main's keys and the prover phase's, or fresh
           ones), a journaled RefreshService(workers=2, deadline_s=300)
           on the card, both admitted with the default SLO; `start()`
           and the producer's fill of the planner's targets (timed; its
           launches counted apart, none in the gated counters); (d) one
           session alone, its launches by stage gated exactly
           (SERVE_DISTRIBUTE: a pooled distribute, worked out on the
           CPU by `scripts/serve_launch_drive.py`; n^2 STREAM_OFFER;
           SERVE_FINALIZE: one pair launch set and n pk_vec MSMs) and
           its device busy (torch.profiler), the session under the span
           tracer: its wall by stage from the spans (distribute, the
           offers, the finalize, the share recovery and adoption, the
           producer thread's precompute spans); (a) the session done, A
           one epoch on and B none, each group key unchanged and t+1
           new shares reconstructing it, the pools taken from,
           `fsdkr_producer_errors` unchanged (the extra sessions side by
           side that measured throughput here are cut to keep the whole
           run inside its time limit); (b) an epoch under
           `faults.configure("seed=7,msg_tamper=1.0,msg_tamper_max=1")`
           aborted with blame on the tampered sender; (c) a fresh
           service on the same journal and keystore: `recover()` replays
           every session as a terminal with its verdict. Prints the
           fill time, the session's latency and its device busy.
  ingress  the TCP ingress at full width: a journaled RefreshService
           (workers=2, deadline_s=300) on the card over one committee
           (main's keys, or fresh ones), an IngressServer on 127.0.0.1
           and an IngressClient as the broadcast channel (the set
           fetched per sender when it is too big to inline): (a) an
           honest epoch (done, no blame, t+1 new shares reconstruct the
           group key) with a bad-CRC frame and an oversize length prefix
           on two other connections, each closing only its own; the
           session's launches by stage gated exactly against serve's
           tables (SERVE_DISTRIBUTE, n^2 STREAM_OFFER counted on the
           ingress's handler threads, the finalize set), its device busy;
           (b) an epoch with one sender's PDL proof flipped in its wire
           (the tampered copy first, the honest one a duplicate):
           aborted, PDLwSlackProofError blaming that sender. Prints the
           wire sizes (a message's JSON, its broadcast frame, the set)
           against max_frame and the per-connection budget, submit to
           terminal, frames and bytes both ways, and
           `telemetry.export.snapshot()`'s fsdkr_ingress_* metrics.
  fleet    ShardSupervisor(shards=2, device="cuda"): two shard processes
           on the card (each its own CUDA context, the kernels built by
           the parent), one committee each (main's and prover's keys,
           or fresh ones); both must report the card; epoch 0 on both;
           then epoch 1 queued on the victim's committee (the storm
           phase's bystanders are the control); once the victim's
           session is collecting, the `shard_kill` site
           (`faults.configure("seed=11,shard_kill=1.0,shard_kill_max=1")`,
           `chaos_kill`) SIGKILLs it: the peer replays the dead journal,
           the pending epoch ends done with no blame as epoch 0 did,
           flight.json sits beside the dead journal,
           the journal accounts for every session, the failover's cause
           is the process's exit (SIGKILL) and no shard reported a fault
           or a failed command. Prints each
           shard's start-up split, the detection time, MTTR and the
           fleet's sessions/s.
  storm    the load generator's network storm composed with SIGKILLs
           (`serving.loadgen.run_net_storm`, kills=3) on 4 shards on the
           card: 2048-bit Paillier, M=256, 11 correct-key rounds, n=3,
           t=1, 3 base committees cloned to 12, a 60 s window at 0.3
           session/s (`STORM_RATE`) from 2 client processes over TCP,
           the JAX package's default network fault spec with --seed in
           every shard, the deadline 4 times the seed epoch's p99.
           Gates: the report's own
           (zero lost accepted broadcasts across every journal, zero
           wrong verdicts, zero wedged, the fleet quiesced, the
           bystander p99 within its bound, at least 3 kills), every
           shard on the card, and every failover caused by its shard's
           exit. Prints MTTR per failover, recover_s, the bystander p99,
           sessions/s and the ingress counters; the report goes to
           chiprun_out/chip_storm.json.
  time     each kernel against its plain version at every shape its path
           (the routed path for the CIOS kernels, the RNS path for the
           RNS kernels, the joint and RLC paths for the Straus and
           shared-exponent kernels: the RLC folds' 1- to 16-term rows
           among them; the join round's own shapes for every kernel)
           launched it with (one call, rows half random, half worst-case;
           bit-identical results); each kernel timed beside its bound on
           the H100 at every one of those shapes, and at its costliest
           shape beside its plain version too. Two times per launch: `ms`,
           CUDA events around back-to-back wrapper calls (the wrapper's
           host work included where it is the slower side), and
           `device_ms`, the kernel's own device time (torch.profiler).
           A `cios_modexp` shape is its launch's segments; the launch of
           the most segments (the pair families' columns) is timed beside
           each of its segments alone, and every `cios_modexp` time is
           also given in ns per CIOS step of the launch's longest chain;
           every `cios_comb` time also in ns per row-step (a CIOS step of
           one row); every ladder time also in us per product of its
           chain, beside the chain at one SM's integer multiply rate;
           every EC time also in us per complete addition of its chain;
           every joint kernel's time also in us per product of a row's
           chain.

Prints the kernels line `{"kernels": [...]}` and, last, `{"ok": true,
"device": {...}}`. Any failure exits non-zero with no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import random
import subprocess
import sys
import time

PHASES = ("env", "kernels", "routes", "host", "main", "joint", "rlc", "trace", "join",
          "sessions", "stream", "prover", "serve", "ingress", "fleet", "storm", "time")

# H100 SXM published peaks (dense) and the 16x16-bit MAC model: one model
# for bound_ms here and the tracer's MFU (fsdkr_tpu_torch/utils/roofline.py).
# A 16x16-bit multiply-add counts as four 8-bit multiply-adds of two
# operations each: the least work an exact tensor-core route could do.
try:
    from fsdkr_tpu_torch.utils.roofline import (  # noqa: E402
        HBM_BYTES_PER_S,
        H100_PEAK_MACS,
        INT8_OPS_PER_S,
        ec_scalar_mul_macs,
        ec_tree_sum_macs,
    )
except ImportError:  # this script without the package beside it: main() refuses
    pass


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


def _worst_rows(rows, worst):
    """How many of `rows` rows are worst-case: all (True), none (False),
    or the given count, taken from the end."""
    return rows if worst is True else int(worst)


def kernel_inputs(rng, rb, dev, rows, exp_bits, worst):
    """Residue tensors for both RNS kernels: random rows, or worst-case
    rows (every residue m-1, every exponent bit set), or the last `worst`
    rows worst-case."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops import rns

    k = rb.k
    m = np.asarray(rb.m_all, np.int64)
    nrng = np.random.default_rng(rng.getrandbits(32))
    x = nrng.integers(0, m, size=(rows, 2 * k + 1))
    y = nrng.integers(0, m, size=(rows, 2 * k + 1))
    moduli = rand_moduli(rng, rb, rows, rb.value_bits)
    c1, nb, _a2n, _bad = rns._row_consts(rb, moduli)
    exp = nrng.integers(0, 1 << 16, size=(rows, exp_bits // 16))
    w = _worst_rows(rows, worst)
    if w:
        x[-w:] = m - 1
        y[-w:] = m - 1
        c1[-w:] = m[:k] - 1
        nb[-w:] = m[k:] - 1
        exp[-w:] = 0xFFFF

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return t(x), t(y), t(c1), t(nb), t(exp)


def cios_inputs(rng, dev, k, rows, exp_bits, worst):
    """(x, y, n, n_inv, r2, one_mont, exp) int32 tensors for the CIOS
    kernels at K=k limbs: random rows (row 0 modulo 3, row 1 with
    exponent 0; rows take their moduli in turn from 64 random ones, as a
    column's rows repeat a party's modulus, so the host precompute stays
    small at tens of thousands of rows), or worst-case
    rows (n = 2^(16k) - 1, every limb of x and y at n - 1, every exponent
    bit set), or the last `worst` rows worst-case."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext

    w = _worst_rows(rows, worst)
    pool = [3] + [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
                  for _ in range(min(64, rows) - 1)] + [(1 << (16 * k)) - 1]
    pick = np.arange(rows) % (len(pool) - 1)
    pick[rows - w:] = len(pool) - 1
    ctx = MontgomeryContext(pool, k)
    n = ctx.n.astype(np.int64)[pick]
    nrng = np.random.default_rng(rng.getrandbits(32))
    # x, y below n: random limbs under a top limb below n's (and below 3
    # in the modulus-3 rows)
    xy = nrng.integers(0, 1 << 16, size=(2, rows, k))
    xy[:, :, k - 1] %= np.maximum(n[:, k - 1], 1)
    small = pick == 0
    xy[:, small] = 0
    xy[:, small, 0] = nrng.integers(0, 3, size=(2, int(small.sum())))
    xy[:, rows - w:] = n[rows - w:] - (np.arange(k) == 0)
    exp = nrng.integers(0, 1 << 16, size=(rows, exp_bits // 16))
    exp[min(1, rows - 1)] = 0
    exp[rows - w:] = 0xFFFF

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return (t(xy[0]), t(xy[1]), t(n), t(ctx.n_inv[pick]), t(ctx.r2[pick]),
            t(ctx.one_mont[pick]), t(exp))


def cios_calls(name, args, exp_bits):
    """(kernel call, plain call) of one CIOS entry point on `args`."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    x, y, n, ni, r2, one, exp = args
    if name == "cios_mont_mul":
        return (lambda: mk.mont_mul(x, y, n, ni),
                lambda: montgomery.mont_mul_limbs(x, y, n, ni))
    if name == "cios_modmul":
        return (lambda: mk.modmul(x, y, n, ni, r2),
                lambda: montgomery._modmul_kernel(x, y, n, ni, r2))
    return (lambda: mk.modexp(x, exp, n, ni, r2, one, exp_bits),
            lambda: montgomery._modexp_kernel(x, exp, n, ni, r2, one, exp_bits=exp_bits))


CIOS = ("cios_mont_mul", "cios_modmul", "cios_modexp")


def modexp_segment_inputs(dev, rng, segments):
    """One `cios_modexp` segment tuple per (K, rows, exp_bits) of
    `segments`, on fresh inputs whose rows are half random, half
    worst-case."""
    segs = []
    for k, rows, exp_bits in segments:
        x, _, n, ni, r2, one, exp = cios_inputs(rng, dev, k, rows, exp_bits, rows // 2)
        segs.append((x, exp, n, ni, r2, one, exp_bits))
    return segs


def modexp_segment_calls(dev, rng, segments):
    """(kernel call, plain call) of one segmented `cios_modexp` launch over
    `segments` (`modexp_segment_inputs`): the kernel's results as a list,
    and the plain version's per segment."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    segs = modexp_segment_inputs(dev, rng, segments)
    return (lambda: mk.modexp_segments(segs),
            lambda: [montgomery._modexp_kernel(*seg[:6], exp_bits=seg[6]) for seg in segs])


def comb_inputs(rng, dev, k, groups, per_group, exp_bits, worst):
    """(table, exp, base, n, n_inv, r2, one_mont) int32 tensors for the
    comb's kernels at K=k limbs: random groups (group 0 modulo 3, its
    second row with exponent 0; table entries and bases below their
    modulus), or worst-case groups (n = 2^(16k) - 1, every table entry
    and the base n - 1, every exponent bit set), or the last `worst`
    groups worst-case."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs

    w_cnt, el = exp_bits // 4, exp_bits // 16
    nrng = np.random.default_rng(rng.getrandbits(32))
    moduli = [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1)) for _ in range(groups)]
    moduli[0] = 3
    w = _worst_rows(groups, worst)
    for g in range(groups - w, groups):
        moduli[g] = (1 << (16 * k)) - 1
    n_top = ints_to_limbs(moduli, k)[:, k - 1].astype(np.int64)
    # entries below n: random limbs under a top limb below n's
    table = nrng.integers(0, 1 << 16, size=(16, w_cnt, groups, k))
    table[..., k - 1] = nrng.integers(0, 1 << 16, size=(16, w_cnt, groups)) % np.maximum(n_top, 1)
    if groups - w > 0:  # group 0, modulo 3
        table[:, :, 0, :] = 0
        table[:, :, 0, 0] = nrng.integers(0, 3, size=(16, w_cnt))
    base = [rng.randrange(m) for m in moduli]
    exp = nrng.integers(0, 1 << 16, size=(groups, per_group, el))
    exp[0, min(1, per_group - 1)] = 0
    for g in range(groups - w, groups):
        table[:, :, g, :] = 0xFFFF
        table[:, :, g, 0] = 0xFFFE
        base[g] = moduli[g] - 1
        exp[g] = 0xFFFF
    ctx = MontgomeryContext(moduli, k)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return (t(table), t(exp), t(ints_to_limbs(base, k)), t(ctx.n), t(ctx.n_inv), t(ctx.r2),
            t(ctx.one_mont))


def comb_calls(name, args, exp_bits):
    """(kernel call, plain call) of one comb kernel on `args`."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    table, exp, base, n, ni, r2, one = args
    if name == "cios_comb":
        return (lambda: mk.comb(table, exp, n, ni, one, exp_bits),
                lambda: montgomery._comb_accumulate(table, exp, n, ni, one,
                                                    exp_bits=exp_bits))
    w_cnt = exp_bits // 4
    return (lambda: mk.comb_ladder(base, n, ni, r2, w_cnt),
            lambda: montgomery._comb_ladder(base, n, ni, r2, w_cnt))


COMB = ("cios_comb", "cios_comb_ladder")

# the kernels of the joint path only (FSDKRC_MULTIEXP / FSDKRC_RANGEOPT on)
JOINT = ("cios_multi_modexp", "cios_shared_exp")
JOINT_SYMBOLS = ("cios_multi_modexp_kernel", "cios_shared_exp_kernel")


def multi_inputs(rng, dev, k, rows, widths, worst):
    """(bases (T, rows, K), exps (T, rows, EL), n, n_inv, r2, one_mont)
    int32 tensors for `cios_multi_modexp` at K=k limbs, T = len(widths)
    terms of those exponent widths (descending): random rows (row 0
    modulo 3, row 1 with every exponent 0, moduli taken in turn from 64
    random ones), the last `worst` rows worst-case (n = 2^(16k) - 1, every
    base n - 1, every exponent bit of its width set)."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs

    w = _worst_rows(rows, worst)
    pool = [3] + [rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
                  for _ in range(min(64, rows) - 1)]
    moduli = [pool[i % len(pool)] for i in range(rows - w)] + [(1 << (16 * k)) - 1] * w
    bases = [[rng.randrange(m) if i < rows - w else m - 1 for i, m in enumerate(moduli)]
             for _ in widths]
    exps = [[rng.getrandbits(wb) if i < rows - w else (1 << wb) - 1 for i in range(rows)]
            for wb in widths]
    if rows - w > 1:
        for e in exps:
            e[1] = 0
    ctx = MontgomeryContext(moduli, k)
    el = widths[0] // 16

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    return (t(np.stack([ints_to_limbs(b, k) for b in bases])),
            t(np.stack([ints_to_limbs(e, el) for e in exps])),
            t(ctx.n), t(ctx.n_inv), t(ctx.r2), t(ctx.one_mont))


def multi_calls(dev, rng, k, rows, widths, worst):
    """(kernel call, plain call) of one `cios_multi_modexp` launch."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    bases, exps, n, ni, r2, one = multi_inputs(rng, dev, k, rows, widths, worst)
    return (lambda: mk.multi_modexp(bases, exps, n, ni, r2, one, widths),
            lambda: montgomery._multi_modexp_kernel(bases, exps, n, ni, r2, one,
                                                    exp_bits_seq=widths))


def shared_exp_inputs(dev, rng, segments, worst_last=True):
    """One `cios_shared_exp` segment tuple (base, digits, n, n_inv, r2,
    one_mont) per (K, rows, exp_bits) of `segments`: a random modulus,
    bases and exponent (the first segment modulo 3), the last segment
    worst-case (n = 2^(16k) - 1, every base n - 1, every digit 15)."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.ops.limbs import MontgomeryContext, ints_to_limbs
    from fsdkr_tpu_torch.ops.montgomery import exp_digits

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()

    segs = []
    for i, (k, rows, exp_bits) in enumerate(segments):
        worst = worst_last and i == len(segments) - 1
        if worst:
            m, e = (1 << (16 * k)) - 1, (1 << exp_bits) - 1
        else:
            m = 3 if i == 0 else rng.getrandbits(16 * k) | 1 | (1 << (16 * k - 1))
            e = rng.getrandbits(exp_bits)
        bases = [m - 1 if worst else rng.randrange(m) for _ in range(rows)]
        ctx = MontgomeryContext([m], k)
        segs.append((t(ints_to_limbs(bases, k)), t(exp_digits(e, exp_bits)), t(ctx.n),
                     t(ctx.n_inv), t(ctx.r2), t(ctx.one_mont)))
    return segs


def shared_exp_calls(dev, rng, segments):
    """(kernel call, plain call) of one `cios_shared_exp` launch over
    `segments`."""
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    segs = shared_exp_inputs(dev, rng, segments)
    return (lambda: mk.shared_exp_segments(segs),
            lambda: [montgomery._shared_exp_kernel(*seg) for seg in segs])

EC = ("ec_scalar_mul", "ec_tree_sum")
_EC_POOL = []  # host points the EC inputs take in turn (built once)


def ec_pool(rng):
    """62 random points, G and the identity."""
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, N, Point, Scalar

    if not _EC_POOL:
        _EC_POOL.extend([GENERATOR * Scalar(1 + rng.randrange(N - 1)) for _ in range(62)]
                        + [GENERATOR, Point.identity()])
    return _EC_POOL


def ec_inputs(rng, dev, rows, scalar_bits, worst):
    """(points, scalars) int32 tensors for `ec_scalar_mul`: points taken in
    turn from `ec_pool` (row 1 G, row 2 the identity), scalars random
    below the group order (below 2^128 at 128 bits), rows 3-7 the edge
    scalars 0, 1, 7, the largest and 2^128 - 1; the last `worst` rows
    worst-case (the largest scalar: N - 1, or 2^128 - 1, every digit but
    the top ones 15)."""
    import numpy as np
    import torch

    from fsdkr_tpu_torch.core.secp256k1 import N
    from fsdkr_tpu_torch.ops import ec_batch

    pool = ec_pool(rng)
    pts = [pool[rng.randrange(len(pool) - 2)] for _ in range(rows)]
    pts[1:3] = pool[-2:][: max(rows - 1, 0)]
    top = N if scalar_bits == 256 else 1 << 128
    scs = [rng.randrange(top) for _ in range(rows)]
    scs[3:8] = [0, 1, 7, top - 1, (1 << 128) - 1][: max(rows - 3, 0)]
    for i in range(rows - _worst_rows(rows, worst), rows):
        scs[i] = top - 1
    limbs = ec_batch._scalars_to_limbs(scs, scalar_bits)
    return (ec_batch.points_to_device(pts, dev),
            torch.as_tensor(limbs.astype(np.int32)).to(dev).contiguous())


def tree_inputs(rng, dev, groups, m):
    """(G, M, 3, 16) int32 projective limbs for `ec_tree_sum`: `ec_pool`
    points, each scaled by a random Z (the same projective point), with
    in every group a cancelling pair (P and -P, rows 0 and M/2), a
    doubling (rows 1 and 1 + M/2) and the last eighth identity pads."""
    import torch

    from fsdkr_tpu_torch.core.secp256k1 import P, Point
    from fsdkr_tpu_torch.ops import ec_batch

    pool = ec_pool(rng)
    pts = []
    for _ in range(groups):
        grp = [pool[rng.randrange(len(pool))] for _ in range(m)]
        h = m // 2
        if m >= 2:
            grp[h] = -grp[0]
        if m >= 4:
            grp[1 + h] = grp[1]
        if m >= 8:
            grp[m - m // 8:] = [Point.identity()] * (m // 8)
        pts += grp
    proj = ec_batch.points_to_device(pts, dev).to(torch.int64)
    lam = torch.as_tensor(ec_batch.ints_to_limbs(
        [1 + rng.randrange(P - 1) for _ in pts], 16).astype("int64")).to(dev)
    scaled = torch.stack([ec_batch._fmul(proj[:, c], lam) for c in range(3)], dim=1)
    return scaled.to(torch.int32).view(groups, m, 3, 16).contiguous()


def ec_calls(name, args, scalar_bits=None):
    """(kernel call, plain call) of one EC kernel on `args`."""
    from fsdkr_tpu_torch.ops import ec_batch, ec_kernels

    if name == "ec_scalar_mul":
        points, scalars = args
        return (lambda: ec_kernels.scalar_mul(points, scalars, scalar_bits),
                lambda: ec_batch._scalar_mul_kernel(points, scalars, scalar_bits=scalar_bits))
    (points,) = args
    return (lambda: ec_kernels.tree_sum(points), lambda: ec_batch._tree_sum_kernel(points))


# ---------------------------------------------------------------------------
# phases


def phase_env(dev):
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from fsdkr_tpu_torch import native
    from fsdkr_tpu_torch.native import ec as native_ec
    from fsdkr_tpu_torch.native import gmp
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels

    log(smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    mods = (rns_kernels, montgomery_kernels, ec_kernels)
    # one nvcc per source and one g++ per host core, all started together
    with ThreadPoolExecutor(len(mods) + 2) as pool:
        futs = [pool.submit(m.load_library) for m in mods]
        futs += [pool.submit(native.available), pool.submit(native_ec.available)]
        for fut in futs:
            fut.result()
    log(f"kernels and host cores built and loaded in {time.perf_counter() - t0:.2f} s")
    try:
        gmp_line = f"libgmp {gmp.library_path()} version {gmp.version()}"
    except (OSError, native.NativeBuildError) as e:
        fail(f"env: libgmp: {e}")
    kind = native.engine_kind()
    log(f"{gmp_line}; native core {native.LIB.so_path().name}, engine {kind}, "
        f"{native.thread_count()} threads; native EC {native_ec.LIB.so_path().name}")
    if kind != "mpn":
        fail(f"env: the native core's engine is {kind!r}, not 'mpn'")
    for m in mods:
        log(f"  {m.build_info.get('so')}: {m.build_info.get('seconds', 0):.2f} s")
        for line in m.build_info.get("ptxas", "").splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "smem", "spill",
                                       "stack frame")):
                log(f"  ptxas: {line.strip()}")
    usage = ptxas_usage(ec_kernels.build_info.get("ptxas", ""), "ec_scalar_mul_kernel")
    log("ptxas: ec_scalar_mul_kernel " + (", ".join(f"{k} {v}" for k, v in usage.items())
                                           or "not reported (library already built)"))
    log_joint_ptxas(montgomery_kernels.build_info.get("ptxas", ""))


def log_joint_ptxas(report, label=""):
    """The joint kernels' registers and spill bytes, one line an
    instantiation (the template argument: threads a block)."""
    for kernel in JOINT_SYMBOLS:
        entries = ptxas_entries(report, kernel)
        if not entries:
            log(f"{label}ptxas: {kernel} not reported (library already built)")
        for name, usage in entries.items():
            log(f"{label}ptxas: {kernel} {name}: "
                + ", ".join(f"{k} {v}" for k, v in usage.items()))


def ptxas_entries(report, symbol):
    """{mangled name: {registers, spill_stores, spill_loads, stack_frame}}
    of every instantiation of one kernel in nvcc's -Xptxas -v report
    (empty when the library was not built here)."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m[1] if symbol in m[1] else None
            if name:
                out.setdefault(name, {})
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m[1])
    return out


def ptxas_usage(report, symbol):
    """The usage of one kernel (its last instantiation) from `ptxas_entries`."""
    entries = ptxas_entries(report, symbol)
    return entries[list(entries)[-1]] if entries else {}


LADDER_THREADS = (256, 512)  # the ladder's layouts (csrc: launch_comb_ladder)


def phase_kernels(dev, rng):
    import torch

    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk, rns, rns_kernels

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
    # the CIOS kernels: K=16 leaves lanes idle, 128 / 256 / 512 / 1024 fill
    # 2 / 4 / 8 / 16 words a lane (512: the 8192-bit route); 130 and 1022
    # leave an odd word count; the main path's shapes hold K=128 and 256
    # at 256 rows and more (`time` phase)
    exp_bits = 64
    for k in (16, 128, 130, 256, 512, 1022, 1024):
        for rows in (1, 13, 256) if k in (16, 512) else (1, 13):
            for worst in (False, True):
                args = cios_inputs(rng, dev, k, rows, exp_bits, worst)
                for name in CIOS:
                    kernel, plain = cios_calls(name, args, exp_bits)
                    if _max_err(kernel(), plain()):
                        fail(f"{name} K={k} rows={rows} worst={worst}: differs from plain")
            log(f"kernels == plain, bit-identical: {'+'.join(CIOS)} K={k} rows={rows} "
                f"exp_bits={exp_bits}, random and worst-case rows")
    # the segmented modexp: mixed K, exponent widths and row counts in one
    # launch (blocks of the longest chain first, narrow and wide bodies
    # side by side), each segment half random and half worst-case
    segments = ((128, 8, 256), (256, 13, 768), (128, 512, 3072), (256, 64, 2048),
                (128, 100, 768), (256, 512, 256))
    kernel, plain = modexp_segment_calls(dev, rng, segments)
    if _max_err(kernel(), plain()):
        fail(f"cios_modexp over segments {segments}: differs from plain")
    log(f"kernels == plain, bit-identical: cios_modexp, one launch of segments (K, rows, "
        f"exp_bits) {segments}, each half random and half worst-case")
    # cios_mont_mul and cios_modmul on both sides of R*: one warp a row
    # below (cios_modmul: 32 lanes a row), the rule's lanes a row from R*
    # (a ragged last warp just above it)
    for k in (128, 256):
        _, lanes, r_star = mk.rows_rule(k)
        for rows in (r_star - 1, r_star, r_star + 13):
            for worst in (False, 13):
                args = cios_inputs(rng, dev, k, rows, exp_bits, worst)
                for name in ("cios_mont_mul", "cios_modmul"):
                    kernel, plain = cios_calls(name, args, exp_bits)
                    if _max_err(kernel(), plain()):
                        fail(f"{name} K={k} rows={rows} worst={worst}: differs from plain")
        log(f"kernels == plain, bit-identical: cios_mont_mul+cios_modmul K={k} at "
            f"{r_star - 1}, {r_star} and {r_star + 13} rows (R*={r_star}: one warp a row "
            f"below, cios_modmul 32 lanes a row, both {lanes} lanes a row from it), random "
            f"rows and 13 worst-case")
    # cios_comb: one group (the block's rows share it), 13 and 257 rows a
    # group (ragged row tiles), and the ring-Pedersen column's 16 groups x
    # 256 rows; K=130 and 256 take 16 lanes a row, 512 and 1024 32
    for k in (16, 128, 130, 256, 512, 1024):
        for groups, per_group in ((1, 8), (3, 13), (2, 257), (16, 256)):
            for worst in (False, True):
                args = comb_inputs(rng, dev, k, groups, per_group, exp_bits, worst)
                kernel, plain = comb_calls("cios_comb", args, exp_bits)
                if _max_err(kernel(), plain()):
                    fail(f"cios_comb K={k} groups={groups} rows={per_group} "
                         f"worst={worst}: differs from plain")
            log(f"kernels == plain, bit-identical: cios_comb K={k} groups={groups} "
                f"rows per group={per_group} exp_bits={exp_bits} (at "
                f"{mk.rows_rule(k)[0]} lanes a row), random and worst-case groups")
    # the ladder, one block a group: K=16 leaves most threads idle, 130 and
    # 1022 an odd word count, 1024 several words a thread; at the rule's
    # threads a block and at every one the library builds
    for k in (16, 128, 130, 256, 512, 1022, 1024):
        for groups in (1, 3, 16):
            for worst in (False, True):
                _, _, base, n, ni, r2, _ = comb_inputs(rng, dev, k, groups, 1, exp_bits, worst)
                w_cnt = exp_bits // 4
                want = montgomery._comb_ladder(base, n, ni, r2, w_cnt)
                calls = [lambda: mk.comb_ladder(base, n, ni, r2, w_cnt)] + [
                    (lambda t: lambda: mk.comb_ladder_at_threads(t, base, n, ni, r2, w_cnt))(t)
                    for t in LADDER_THREADS]
                for call in calls:
                    if _max_err(call(), want):
                        fail(f"cios_comb_ladder K={k} groups={groups} worst={worst}: "
                             f"differs from plain")
        log(f"kernels == plain, bit-identical: cios_comb_ladder K={k} on 1, 3 and 16 groups, "
            f"exp_bits={exp_bits} (the rule's {mk.ladder_rule(k)} threads a block, and "
            f"{', '.join(map(str, LADDER_THREADS))}), random and worst-case groups")
    ec_kernels_check(dev, rng)
    joint_kernels_check(dev, rng)


# the joint kernels' layouts: one warp a row (0), one block a row at 256
# or 512 threads (csrc: fsdkr_cios_multi_modexp_threads)
JOINT_THREADS = (0, 256, 512)


def joint_kernels_check(dev, rng):
    """Both kernels of the joint path against their plain versions, bit
    for bit, at the launch rule's layout and at each of JOINT_THREADS
    (one warp a row, one block a row at 256 and 512 threads).
    `cios_multi_modexp`: the collect's joint launch under
    FSDKRC_MULTIEXP alone (K=256, 512 rows, widths (2048, 256)), the
    default collect's shape at 265 rows (more than two blocks a SM, a
    partial last wave), the distribute's two (K=128, 512 rows, (2560,
    256) and (3072, 768)), 16 terms at K=128 of 128-384 bits, and at
    K=16, 130, 512 and 1024 on 1 and 13 rows the most terms a block's
    shared memory holds there (16, 16, 12, 5); half the rows worst-case.
    Rows past those caps at 8192 and 16384 bits (14 and 7 terms) through
    `multi_powm`, split into two launches each, against pow.
    `cios_shared_exp`: the RANGEOPT u-power's launch (K=256, 16 segments
    of 16 rows, 2048-bit exponents) and one segment of it, and K=16, 130
    and 1024 on 1 and 13 rows; the first segment modulo 3, the last
    worst-case."""
    from fsdkr_tpu_torch.backend import powm
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels as mk

    cases = [(256, 512, (2048, 256)), (256, 265, (2048, 256)), (128, 512, (2560, 256)),
             (128, 512, (3072, 768)),
             (128, 64, (384, 384, 320, 320, 256, 256, 256, 192, 192, 192, 128, 128, 128, 128,
                        128, 128))]
    for k in (16, 130, 512, 1024):
        t_max = mk.multi_modexp_max_terms(k)
        for rows in (1, 13):
            cases.append((k, rows, tuple(256 - 64 * (t * 3 // t_max) for t in range(t_max))))
    for k, rows, widths in cases:
        bases, exps, n, ni, r2, one = multi_inputs(rng, dev, k, rows, widths, rows // 2)
        want = montgomery._multi_modexp_kernel(bases, exps, n, ni, r2, one, exp_bits_seq=widths)
        calls = [lambda: mk.multi_modexp(bases, exps, n, ni, r2, one, widths)] + [
            (lambda t: lambda: mk.multi_modexp_at_threads(t, bases, exps, n, ni, r2, one,
                                                          widths))(t) for t in JOINT_THREADS]
        for call in calls:
            if _max_err(call(), want):
                fail(f"cios_multi_modexp K={k} rows={rows} widths={widths}: differs from plain")
        log(f"kernels == plain, bit-identical: cios_multi_modexp K={k} rows={rows} "
            f"T={len(widths)} exp_bits={widths}, {rows // 2} worst-case rows (the rule's "
            f"{mk.joint_rule(k, rows)[0]} threads a block, and "
            f"{', '.join(map(str, JOINT_THREADS))}; 0: one warp a row)")
    rows_b, rows_e, mods = [], [], []
    for bits, terms in ((8192, 14), (16384, 7)):
        m = rng.getrandbits(bits) | 1 | (1 << (bits - 1))
        for _ in range(2):
            rows_b.append(tuple(rng.randrange(m) for _ in range(terms)))
            rows_e.append(tuple(rng.getrandbits(256) for _ in range(terms)))
            mods.append(m)
    shapes_before = dict(mk.multi_modexp.shapes)
    got = powm.multi_powm(rows_b, rows_e, mods, dev)
    want = []
    for bs, es, m in zip(rows_b, rows_e, mods):
        acc = 1
        for b, e in zip(bs, es):
            acc = acc * pow(b, e, m) % m
        want.append(acc)
    if got != want:
        fail("multi_powm past the wide caps differs from pow")
    terms = sorted(len(shape[2]) for shape, count in mk.multi_modexp.shapes.items()
                   for _ in range(count - shapes_before.get(shape, 0)))
    caps = [mk.multi_modexp_max_terms(k) for k in (512, 1024)]
    if terms != sorted([14 - caps[0], caps[0], 7 - caps[1], caps[1]]):
        fail(f"multi_powm past the wide caps: Straus launches of {terms} terms, caps {caps}")
    log(f"routes == pow: multi_powm rows of 14 terms at 8192 bits and 7 at 16384 bits "
        f"(caps {caps[0]} and {caps[1]}), Straus launches of {terms} terms")
    seg_cases = [((256, 16, 2048),) * 16, ((256, 16, 2048),)]
    for k in (16, 130, 1024):
        seg_cases.append(((k, 1, 256), (k, 13, 64), (k, 13, 256)))
    for segments in seg_cases:
        segs = shared_exp_inputs(dev, rng, segments)
        want = [montgomery._shared_exp_kernel(*seg) for seg in segs]
        calls = [lambda: mk.shared_exp_segments(segs)] + [
            (lambda t: lambda: mk.shared_exp_at_threads(t, segs))(t) for t in JOINT_THREADS]
        for call in calls:
            if _max_err(call(), want):
                fail(f"cios_shared_exp over segments {segments}: differs from plain")
        log(f"kernels == plain, bit-identical: cios_shared_exp, one launch of {len(segments)} "
            f"segments (K, rows, exp_bits) {sorted(set(segments))}, the first modulo 3, "
            f"the last worst-case (the rule's threads a block, and "
            f"{', '.join(map(str, JOINT_THREADS))}; 0: one warp a row)")


def ec_kernels_check(dev, rng):
    """Both EC kernels against their plain versions, bit for bit:
    `ec_scalar_mul` at 1, 13, 256, 1024 and 4096 rows (the main path's
    launches have 256-1024; 13 leaves the last block's lane groups partly
    filled, 4096 is several blocks an SM), 128- and 256-bit scalars;
    `ec_tree_sum` from one row to the PDL u1 group's 1024."""
    for bits in (128, 256):
        for rows in (1, 13, 256, 1024, 4096):
            kernel, plain = ec_calls("ec_scalar_mul", ec_inputs(rng, dev, rows, bits, rows // 4),
                                     bits)
            if _max_err(kernel(), plain()):
                fail(f"ec_scalar_mul rows={rows} scalar_bits={bits}: differs from plain")
            log(f"kernels == plain, bit-identical: ec_scalar_mul rows={rows} scalar_bits={bits}, "
                f"edge scalars, G, the identity, {rows // 4} worst-case rows")
    for groups, m in ((1, 1), (1, 2), (3, 8), (16, 32), (1, 1024)):
        kernel, plain = ec_calls("ec_tree_sum", (tree_inputs(rng, dev, groups, m),))
        if _max_err(kernel(), plain()):
            fail(f"ec_tree_sum groups={groups} rows={m}: differs from plain")
        log(f"kernels == plain, bit-identical: ec_tree_sum groups={groups} rows={m}, random Z, "
            f"a cancelling pair, a doubling and identity pads a group")


def phase_routes(dev, rng):
    from fsdkr_tpu_torch.backend.powm import device_modmul, device_powm
    from fsdkr_tpu_torch.ops import montgomery_kernels, rns

    # CPython's pow takes most of this phase (tens of ms a row at 4096
    # bits): the row counts stay small
    for bits, rows in ((2048, 64), (4096, 32)):
        moduli = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(rows)]
        bases = [rng.randrange(n) for n in moduli]
        exps = [rng.getrandbits(2048) for _ in range(rows)]
        exps[0] = 0
        exps[1] = (1 << 2048) - 1
        t = [time.perf_counter()]
        want = [pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]
        t.append(time.perf_counter())
        if device_powm(bases, exps, moduli, dev) != want:
            fail(f"device_powm at {bits} bits disagrees with pow")
        t.append(time.perf_counter())
        if rns.rns_modexp(bases, exps, moduli, bits, dev) != want:
            fail(f"rns_modexp at {bits} bits disagrees with pow")
        t.append(time.perf_counter())
        want = [b * e % n for b, e, n in zip(bases, exps, moduli)]
        if device_modmul(bases, exps, moduli, dev) != want:
            fail(f"device_modmul at {bits} bits disagrees with a*b % n")
        if rns.rns_modmul(bases, exps, moduli, bits, dev) != want:
            fail(f"rns_modmul at {bits} bits disagrees with a*b % n")
        t.append(time.perf_counter())
        log(f"device_powm, rns_modexp == pow; device_modmul, rns_modmul == a*b % n: "
            f"{rows} rows of {bits}-bit moduli, 2048-bit exponents (seconds: pow "
            f"{t[1] - t[0]:.3f}, device_powm {t[2] - t[1]:.3f}, rns_modexp (cold "
            f"constants) {t[3] - t[2]:.3f}, both modmuls {t[4] - t[3]:.3f})")
    # past the RNS classes: the CIOS engine at K=512
    bits, rows = 8192, 16
    moduli = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(rows)]
    moduli[3] = 3
    bases = [rng.randrange(n) for n in moduli]
    exps = [rng.getrandbits(256) for _ in range(rows)]
    exps[0] = 0
    before = montgomery_kernels.launch_counts()
    if device_powm(bases, exps, moduli, dev) != [
            pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]:
        fail("device_powm at 8192 bits disagrees with pow")
    if device_modmul(bases, exps, moduli, dev) != [
            b * e % n for b, e, n in zip(bases, exps, moduli)]:
        fail("device_modmul at 8192 bits disagrees with a*b % n")
    after = montgomery_kernels.launch_counts()
    if after["cios_modexp"] <= before["cios_modexp"]:
        fail("device_powm at 8192 bits did not launch the CIOS modexp kernel")
    log(f"device_powm == pow, device_modmul == a*b % n: {rows} rows of 8192-bit "
        f"moduli, 256-bit exponents, through the CIOS kernels")
    grouped_routes(dev, rng)


def grouped_routes(dev, rng):
    """device_powm_grouped against pow on columns of comb groups (rows
    sharing a base and modulus) and loners: each column must launch the
    comb, its ladder kernel and the generic engine. The groups are small
    (pow checks every row), so the JAX package's rule routes them: groups
    of 4 rows, any count."""
    from fsdkr_tpu_torch.backend import powm
    from fsdkr_tpu_torch.ops import montgomery_kernels

    min_rows = 4

    # (modulus bits, groups, rows per group, exponent bits)
    for bits, groups, per_group, exp_bits in ((2048, 4, 16, 2048), (4096, 2, 12, 2048),
                                              (8192, 2, 8, 256)):
        bases, exps, moduli = [], [], []
        for g in range(groups + 2):  # two loners at the end
            n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
            b = rng.randrange(n)
            size = per_group if g < groups else min_rows - 1
            bases += [b] * size
            moduli += [n] * size
            exps += [rng.getrandbits(exp_bits) for _ in range(size)]
        exps[0] = 0
        exps[1] = (1 << exp_bits) - 1
        want = [pow(b, e, n) for b, e, n in zip(bases, exps, moduli)]
        saved = powm._SHARED_MIN_ROWS
        powm._SHARED_MIN_ROWS = min_rows
        before = montgomery_kernels.launch_counts()
        try:
            got = powm.device_powm_grouped(bases, exps, moduli, dev)
        finally:
            powm._SHARED_MIN_ROWS = saved
        after = montgomery_kernels.launch_counts()
        if got != want:
            fail(f"device_powm_grouped at {bits} bits disagrees with pow")
        launched = {k: after[k] - before[k] for k in after}
        if not all(launched[k] for k in ("cios_comb", "cios_comb_ladder", "cios_modexp")):
            fail(f"device_powm_grouped at {bits} bits launched {launched}")
        log(f"device_powm_grouped == pow: {groups} groups x {per_group} rows and "
            f"{2 * (min_rows - 1)} loners of {bits}-bit moduli, {exp_bits}-bit "
            f"exponents")


def cpu_model() -> str:
    """The host's CPU model from /proc/cpuinfo: its model name, or where
    the machine reports none, its vendor, family, model and stepping."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    return (f"{fields.get('vendor_id', 'unknown vendor')} family {fields.get('cpu family', '?')} "
            f"model {fields.get('model', '?')} stepping {fields.get('stepping', '?')}")


# Carmichael numbers: Fermat liars to every coprime base, caught only by
# Miller-Rabin's square-root step
CARMICHAEL = (561, 41041, 825265, 321197185, 5394826801, 232250619601, 9746347772161)


def phase_host(rng, rows=64):
    """The host bignum layer (the module docstring's `host`). Returns the
    phase's times."""
    import math

    from fsdkr_tpu_torch import native
    from fsdkr_tpu_torch.core import primes
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, N, Point, Scalar
    from fsdkr_tpu_torch.native import ec as native_ec
    from fsdkr_tpu_torch.native import gmp

    times = {}
    nt = native.thread_count()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def portable(fn):
        native.set_mpn(0)
        try:
            return timed(fn)
        finally:
            native.set_mpn(1)

    def serial(fn):
        native.set_threads(1)
        try:
            return timed(fn)
        finally:
            native.set_threads(0)

    # gmp.powm_batch, plain and secret, against pow; the native core's
    # CRT leg batch, mpn against portable, at the first two shapes
    shapes = (("2048-bit exponent, 4096-bit modulus", 4096, 2048),
              ("1088-bit legs", 1088, 1088),
              ("256-bit exponent, 4096-bit modulus", 4096, 256))
    for label, mbits, ebits in shapes:
        mods = [rng.getrandbits(mbits) | (1 << (mbits - 1)) | 1 for _ in range(rows)]
        bases = [rng.getrandbits(mbits + 8) for _ in range(rows)]
        exps = [rng.getrandbits(ebits) | (1 << (ebits - 1)) for _ in range(rows)]
        exps[0], bases[1], bases[2] = 0, 0, mods[2] + rng.getrandbits(mbits)
        want, t_pow = timed(lambda: [pow(b, e, m) for b, e, m in zip(bases, exps, mods)])
        # untimed calls of each engine first: on an 8-core Xeon host a
        # process's first two threaded GMP batches ran 2-6x slower than
        # the third (likely the allocator's per-thread arenas filling)
        for _ in range(2):
            gmp.powm_batch(bases, exps, mods)
        if mbits <= 64 * native._MAX_LIMBS:
            native.crt_modexp_batch(bases, exps, mods)
        gmp.stats_reset()
        got, t_gmp = timed(lambda: gmp.powm_batch(bases, exps, mods))
        sec, t_sec = timed(lambda: gmp.powm_batch(bases, exps, mods, secret=True))
        st = gmp.stats()
        if got != want or sec != want:
            fail(f"host: gmp.powm_batch at {label} disagrees with pow (plain "
                 f"{sum(a != b for a, b in zip(got, want))} rows, secret "
                 f"{sum(a != b for a, b in zip(sec, want))} rows)")
        if st["powm_rows"] != 2 * rows or st["powm_sec_rows"] != rows - 1:
            fail(f"host: gmp.powm_batch at {label} ran {st}, expected {2 * rows} rows, "
                 f"{rows - 1} on mpz_powm_sec")
        _, g1 = serial(lambda: gmp.powm_batch(bases, exps, mods))
        line = {"pow": t_pow, "gmp": t_gmp, "gmp_secret": t_sec, "gmp_one_thread": g1}
        if mbits <= 64 * native._MAX_LIMBS and ebits > 256:
            mpn, t_mpn = timed(lambda: native.crt_modexp_batch(bases, exps, mods))
            port, t_port = portable(lambda: native.crt_modexp_batch(bases, exps, mods))
            if mpn != want or port != want:
                fail(f"host: crt_modexp_batch at {label}: mpn "
                     f"{'==' if mpn == want else '!='} pow, portable "
                     f"{'==' if port == want else '!='} pow")
            line.update(mpn=t_mpn, portable=t_port)
        if label == shapes[0][0]:
            m1, mp1 = serial(lambda: native.crt_modexp_batch(bases, exps, mods))
            p1, pp1 = serial(lambda: portable(
                lambda: native.crt_modexp_batch(bases, exps, mods))[0])
            if m1 != want or p1 != want:
                fail("host: a one-thread crt_modexp_batch disagrees with pow")
            per = {"CPython pow": t_pow, "GMP powm": g1, "portable": pp1, "mpn": mp1}
            times["ms_per_op"] = {k: v * 1e3 / rows for k, v in per.items()}
            times["ms_per_op_threads"] = {"GMP powm": t_gmp * 1e3 / rows,
                                          "mpn": line["mpn"] * 1e3 / rows}
            log(f"host: ms per op at {label}, one thread: "
                + ", ".join(f"{k} {v:.3f}" for k, v in times["ms_per_op"].items())
                + f"; at {nt} threads: GMP powm {t_gmp * 1e3 / rows:.3f}, mpn "
                  f"{line['mpn'] * 1e3 / rows:.3f}; {cpu_model()}, native.thread_count() {nt}")
        times[label] = line
        log(f"host: gmp.powm_batch (plain and secret) == pow at {label}, {rows} rows "
            f"(an exponent 0, a base 0, a base above the modulus); seconds "
            f"{json.dumps({k: round(v, 4) for k, v in line.items()})}")

    # the sieve's gcd against its primorial: the cached operand and the
    # plain integer, against math.gcd
    prim, op = primes._sieve_for_bits(1024)
    cands = [rng.getrandbits(1024) | (3 << 1022) | 1 for _ in range(2000)]
    want, t_math = timed(lambda: [math.gcd(c, prim) for c in cands])
    got, t_op = timed(lambda: [gmp.gcd(c, op) for c in cands])
    plain, t_plain = timed(lambda: [gmp.gcd(c, prim) for c in cands])
    if got != want or plain != want:
        fail("host: gmp.gcd against the sieve's primorial disagrees with math.gcd")
    times["gcd_us"] = {"math.gcd": t_math / len(cands) * 1e6,
                       "gmp.gcd, cached operand": t_op / len(cands) * 1e6,
                       "gmp.gcd": t_plain / len(cands) * 1e6}
    log(f"host: gmp.gcd == math.gcd on {len(cands)} 1024-bit candidates against the "
        f"{prim.bit_length()}-bit primorial; us per gcd "
        f"{json.dumps({k: round(v, 2) for k, v in times['gcd_us'].items()})}")

    # Miller-Rabin, mpn against portable: primes, Carmichael numbers, products
    known = [(1 << 521) - 1, (1 << 607) - 1, (1 << 1279) - 1, (1 << 2203) - 1]
    gen = primes.gen_primes_batch(1024, 4)
    cands = known + gen + list(CARMICHAEL) + [gen[0] * gen[1], gen[2] * gen[2],
                                              known[0] * gen[3], (1 << 1024) + 1]
    truth = [True] * 8 + [False] * (len(cands) - 8)
    mpn = native.is_probable_prime_batch(cands, 30)
    port, _ = portable(lambda: native.is_probable_prime_batch(cands, 30))
    py = primes._mr_batch(cands, 30)
    if not (mpn == port == py == truth):
        fail(f"host: Miller-Rabin verdicts: mpn {mpn}, portable {port}, "
             f"gmp rounds {py}, expected {truth}")
    log(f"host: Miller-Rabin verdicts of {len(cands)} candidates (4 Mersenne and 4 "
        f"generated 1024-bit primes, {len(CARMICHAEL)} Carmichael numbers, 4 products): mpn "
        f"== portable == GMP rounds == the truth")

    # the comb, mpn against portable, at the leg width
    mod = rng.getrandbits(1088) | (1 << 1087) | 1
    base = rng.getrandbits(1080)
    exps = [rng.getrandbits(1088) for _ in range(rows)] + [0]
    want = [pow(base, e, mod) for e in exps]
    mpn, t_mpn = timed(lambda: native.modexp_shared(base, exps, mod))
    port, t_port = portable(lambda: native.modexp_shared(base, exps, mod))
    if mpn != want or port != want:
        fail("host: modexp_shared (mpn or portable) disagrees with pow")
    times["comb"] = {"mpn": t_mpn, "portable": t_port}
    log(f"host: modexp_shared == pow, mpn and portable, {len(exps)} rows at 1088 bits: "
        f"{t_mpn:.4f} s and {t_port:.4f} s")

    # native EC against the Python points
    def xy(p):
        return None if p.infinity else (p.x, p.y)

    def point():
        return GENERATOR * Scalar.from_int(rng.randrange(1, N))

    idxs = list(range(1, 17))
    for t in (8, 128):
        commits = [point() for _ in range(t + 1)]
        got, t_nat = timed(lambda: native_ec.horner_batch([xy(c) for c in commits], idxs))
        want = []
        t0 = time.perf_counter()
        for u in idxs:
            acc = Point.identity()
            for a in reversed(commits):
                acc = acc * u + a
            want.append(xy(acc))
        t_py = time.perf_counter() - t0
        if got != want:
            fail(f"host: native Horner at t={t} disagrees with the Python points")
        times[f"horner_t{t}"] = {"native": t_nat, "python": t_py}
        log(f"host: native Horner == the Python points at t={t}, {len(idxs)} indices: "
            f"{t_nat * 1e3:.3f} ms against {t_py * 1e3:.3f} ms")
    P, R = point(), point()
    lrows = [(P, rng.randrange(N), Point.identity(), rng.randrange(N)),
             (Point.identity(), rng.randrange(N), R, rng.randrange(N)),
             (P, 11, -P, 11), (P, 29, P, N - 29), (P, 0, R, 0)]
    lrows += [(point(), rng.randrange(N), point(), rng.randrange(N)) for _ in range(27)]
    got = native_ec.lincomb2_batch([xy(r[0]) for r in lrows], [r[1] for r in lrows],
                                   [xy(r[2]) for r in lrows], [r[3] for r in lrows])
    want = [xy(p * Scalar.from_int(a) + r * Scalar.from_int(b)) for p, a, r, b in lrows]
    if got != want or got[2:5] != [None] * 3:
        fail("host: native lincomb2 disagrees with the Python points")
    log(f"host: native lincomb2 == the Python points on {len(lrows)} rows (identity P and "
        f"Q, a negation, a+b=0, zero scalars)")
    return times


def phase_main(dev, n=16, t=8, bits=2048, m_security=256, rounds=11):
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.errors import PDLwSlackProofError
    from fsdkr_tpu_torch.backend.powm import powm_cache_stats
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage, simulate_keygen

    def launch_counts():
        counts = {**montgomery_kernels.launch_counts(), **ec_kernels.launch_counts()}
        return {k: v for k, v in counts.items() if k not in JOINT}

    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    times = {}
    t0 = time.perf_counter()
    keys = simulate_keygen(t, n, config)
    times["keygen"] = time.perf_counter() - t0
    log(f"main: simulate_keygen t={t} n={n}: {times['keygen']:.3f} s")

    # the keys as they stand before distribute, for the RNS path and the
    # joint phase
    pre = copy.deepcopy(keys)
    pre_joint = copy.deepcopy(keys)
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], n, config)
    times["distribute"] = time.perf_counter() - t0
    log(f"main: distribute_batch, {n} senders: {times['distribute']:.3f} s")
    msgs = [m for m, _ in out]
    spare = (copy.deepcopy(keys[0]), copy.deepcopy(out[0][1]))
    spare2 = (copy.deepcopy(keys[1]), copy.deepcopy(out[1][1]))
    after_distribute = launch_counts()
    # the Feldman commitments, the commit points and the PDL prover's u1:
    # one scalar-mul launch each, no MSM
    ec_distribute = {k: after_distribute[k] for k in EC}
    if ec_distribute != {"ec_scalar_mul": 3, "ec_tree_sum": 0}:
        fail(f"distribute launched the EC kernels {ec_distribute}, expected 3 and 0")

    per_collect, cache = [], []
    t0 = time.perf_counter()
    for key, (_, dk) in zip(keys, out):
        s0 = powm_cache_stats()
        c0 = time.perf_counter()
        RefreshMessage.collect(msgs, key, dk, config=config)
        per_collect.append(time.perf_counter() - c0)
        s1 = powm_cache_stats()
        cache.append((s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]))
    times["collect_total"] = time.perf_counter() - t0
    counts = launch_counts()
    # the shapes of this window's launches, before the checks below add
    # their own
    shapes = {
        "cios_mont_mul": dict(montgomery_kernels.mont_mul.shapes),
        "cios_modmul": dict(montgomery_kernels.modmul.shapes),
        "cios_modexp": dict(montgomery_kernels.modexp_segments.shapes),
        "cios_comb": dict(montgomery_kernels.comb.shapes),
        "cios_comb_ladder": dict(montgomery_kernels.comb_ladder.shapes),
        "ec_scalar_mul": dict(ec_kernels.scalar_mul.shapes),
        "ec_tree_sum": dict(ec_kernels.tree_sum.shapes),
    }
    log(f"main: {n} collects: {times['collect_total']:.3f} s "
        f"(each {min(per_collect):.3f}..{max(per_collect):.3f} s)")
    log(f"main: launches over distribute + collect: "
        f"{counts} (RNS kernels: {rns_kernels.launch_counts()})")
    per_collect_launches = {k: (counts[k] - after_distribute[k]) / n for k in counts}
    per_collect_launches.update(
        {k: v / n for k, v in rns_kernels.launch_counts().items()})  # 0 when routed
    log("main: launches in distribute: " + json.dumps(after_distribute)
        + "; per collect: " + json.dumps(per_collect_launches))
    for name, by_shape in shapes.items():
        log(f"main: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items())))
    if not all(counts[name] > 0 for name in counts):
        fail(f"a kernel of the main path never launched: {counts}")
    # one segmented launch per powm_columns call: the pair families'
    # columns, then correct-key's column
    if per_collect_launches["cios_modexp"] != 2:
        fail(f"cios_modexp launched {per_collect_launches['cios_modexp']} times a collect, "
             f"expected 2")
    # the ring-Pedersen column's 16 groups in one comb launch, after one
    # ladder launch
    for name in ("cios_comb", "cios_comb_ladder"):
        if per_collect_launches[name] != 1:
            fail(f"{name} launched {per_collect_launches[name]} times a collect, expected 1")
    # the Feldman, PDL u1 and pk_vec MSMs: one scalar-mul and one tree-sum
    # launch each
    for name in EC:
        if per_collect_launches[name] != 3:
            fail(f"{name} launched {per_collect_launches[name]} times a collect, expected 3")
    log(f"main: precompute cache (hits, misses) per collect: {cache}; "
        f"{powm_cache_stats()}")
    if any(miss for _, miss in cache[1:]):
        fail("a warm collect missed the precompute cache")

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
        RefreshMessage.collect(bad, spare[0], spare[1], config=config)
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
    honest_u1_check(span_collect(msgs, spare2, config, "routed"), "routed")

    # the RNS route's path (the earlier slices' main path, where every
    # column took the RNS kernels), cut to one collect
    rns_counts, rns_shapes, times["rns_distribute"] = rns_path(pre, config, n)
    counts.update(rns_counts)
    shapes.update(rns_shapes)
    if any(montgomery_kernels.launch_counts()[name] for name in JOINT):
        fail(f"the column path launched a joint kernel: {montgomery_kernels.launch_counts()}")
    return counts, shapes, times, per_collect, pre_joint


# Launches of the joint path (FSDKRC_MULTIEXP and FSDKRC_RANGEOPT on, as
# by default) at n=16, 2048-bit, M=256 (PERF.md section 2). Distribute:
# `cios_modexp` for the Paillier r^n and beta^n columns, the r^e
# responses and correct-key's prover; the comb, its ladder and its table's
# four products for ring-Pedersen's prover (16 groups of 256 rows); the
# Straus kernel once a width shape of the joint commitment rows, (256,
# 2560) and (768, 3072) bits. A collect: `cios_modexp` for the PDL
# columns, the u-power's c^{-e} terms, the range z^{-e} column and
# correct-key's column; the Straus kernel for the PDL joint rows; the
# shared-exponent kernel for the 16 receiver groups' u-powers; the comb,
# its ladder and table three times (ring-Pedersen, then h1^s1 and h2^s2 of
# joint_comb2); `cios_modmul` for PDL's three products, the u-power's and
# joint_comb2's recombinations, the range's u and w, and ring-Pedersen's.
JOINT_DISTRIBUTE = {"cios_modexp": 3, "cios_multi_modexp": 2, "cios_shared_exp": 0,
                    "cios_comb": 1, "cios_comb_ladder": 1, "cios_mont_mul": 4, "cios_modmul": 0,
                    "ec_scalar_mul": 3, "ec_tree_sum": 0}
JOINT_COLLECT = {"cios_modexp": 4, "cios_multi_modexp": 1, "cios_shared_exp": 1,
                 "cios_comb": 3, "cios_comb_ladder": 3, "cios_mont_mul": 12, "cios_modmul": 8,
                 "ec_scalar_mul": 3, "ec_tree_sum": 3}


@contextlib.contextmanager
def knobs(**values):
    """The FSDKRC_* variables set to `values` inside the block, restored
    after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def column_path():
    """FSDKRC_RLC, FSDKRC_MULTIEXP and FSDKRC_RANGEOPT 0 inside the block:
    every prover and verifier family on the per-term column layout."""
    return knobs(FSDKRC_RLC="0", FSDKRC_MULTIEXP="0", FSDKRC_RANGEOPT="0")


def _tamper(msgs, field):
    """A copy of `msgs` with one proof broken: the PDL proof of sender n/3
    to receiver n/5 (`pdl`: s1 + 1; `pdl_s2`: s2 + 1), the range proof of
    sender n/2 to receiver n/4 (`range`: s + 1), or sender n/3's
    ring-Pedersen proof (`ring_pedersen`: Z[0] + 1) or correct-key proof
    (`correct_key`: sigma[0] + 1). Returns (the copy, the tampered
    sender's position, the row)."""
    import dataclasses

    bad = copy.deepcopy(msgs)
    n = len(msgs)
    sender, row = n // 3, n // 5
    if field in ("pdl", "pdl_s2"):
        p = bad[sender].pdl_proof_vec[row]
        bump = {"s1": p.s1 + 1} if field == "pdl" else {"s2": p.s2 + 1}
        bad[sender].pdl_proof_vec[row] = dataclasses.replace(p, **bump)
    elif field == "range":
        sender, row = n // 2, n // 4
        p = bad[sender].range_proofs[row]
        bad[sender].range_proofs[row] = dataclasses.replace(p, s=p.s + 1)
    elif field == "ring_pedersen":
        p = bad[sender].ring_pedersen_proof
        bad[sender].ring_pedersen_proof = dataclasses.replace(p, Z=[p.Z[0] + 1] + list(p.Z[1:]))
    else:
        p = bad[sender].dk_correctness_proof
        bad[sender].dk_correctness_proof = dataclasses.replace(
            p, sigma_vec=[p.sigma_vec[0] + 1] + list(p.sigma_vec[1:]))
    return bad, sender, row


def _tampered_collect(msgs, spare, config, field):
    """A collect of `msgs` tampered by `_tamper(msgs, field)` on the spare
    (key, dk), which stays pre-collect. Returns (the error, the tampered
    sender, the row) and fails if none is raised."""
    from fsdkr_tpu_torch.protocol import RefreshMessage

    bad, sender, row = _tamper(msgs, field)

    try:
        RefreshMessage.collect(bad, copy.deepcopy(spare[0]), copy.deepcopy(spare[1]),
                               config=config)
    except Exception as e:  # noqa: BLE001 - compared below, class and fields
        return e, bad[sender].party_index, row
    fail(f"a tampered {field} proof passed collect")


def _verdict(err):
    return (type(err).__name__, getattr(err, "party_index", None),
            tuple(getattr(err, f, None) for f in ("is_u1_eq", "is_u2_eq", "is_u3_eq")))


def phase_joint(dev, pre, n=16, t=8, bits=2048, m_security=256, rounds=11):
    """The joint path under the defaults (FSDKRC_MULTIEXP, FSDKRC_RANGEOPT
    on), from the main phase's keys before its distribute: every kernel's
    counter zeroed just before distribute_batch by all n senders and read
    after n collects. Gates: the launches per distribute and per collect
    (JOINT_DISTRIBUTE, JOINT_COLLECT); t+1 new shares give the group key;
    a party's collect of the same messages on the column path adopts the
    same key; a tampered PDL row and a tampered range row raise what the
    column path raises (class, party, the PDL verdict tuple). Profiles
    one collect and times another layer by layer. Runs at FSDKRC_RLC=0.
    Returns (counts, shapes of the joint kernels, times, the messages with
    the keys and dks before any collect)."""
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.carry import to_fields
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage

    def launch_counts():
        return {**montgomery_kernels.launch_counts(), **ec_kernels.launch_counts()}

    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    keys = copy.deepcopy(pre)
    times = {}
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], n, config)
    times["distribute"] = time.perf_counter() - t0
    msgs = [m for m, _ in out]
    after_distribute = launch_counts()
    # the messages, keys and dks before any collect, for the rlc phase
    rlc_inputs = (msgs, copy.deepcopy(keys), copy.deepcopy([dk for _, dk in out]))
    column_key = (copy.deepcopy(keys[0]), copy.deepcopy(out[0][1]))
    # the profiled collect adopts into `spare`; the spans' collect takes
    # keys of its own
    spare = (copy.deepcopy(keys[1]), copy.deepcopy(out[1][1]))
    spare2 = (copy.deepcopy(keys[2]), copy.deepcopy(out[2][1]))
    per_collect = []
    for key, (_, dk) in zip(keys, out):
        c0 = time.perf_counter()
        RefreshMessage.collect(msgs, key, dk, config=config)
        per_collect.append(time.perf_counter() - c0)
    counts = launch_counts()
    shapes = {"cios_multi_modexp": dict(montgomery_kernels.multi_modexp.shapes),
              "cios_shared_exp": dict(montgomery_kernels.shared_exp_segments.shapes)}
    per = {k: (counts[k] - after_distribute[k]) / n for k in counts}
    times["collect_median"] = sorted(per_collect)[n // 2]
    log(f"joint: distribute_batch, {n} senders: {times['distribute']:.3f} s; {n} collects "
        f"{sum(per_collect):.3f} s, median {times['collect_median']:.4f} s "
        f"(each {min(per_collect):.3f}..{max(per_collect):.3f} s)")
    log("joint: launches in distribute: " + json.dumps(after_distribute)
        + "; per collect: " + json.dumps(per))
    for name, by_shape in {**shapes,
                           "cios_modexp": montgomery_kernels.modexp_segments.shapes,
                           "cios_comb": montgomery_kernels.comb.shapes,
                           "cios_comb_ladder": montgomery_kernels.comb_ladder.shapes,
                           "cios_mont_mul": montgomery_kernels.mont_mul.shapes,
                           "cios_modmul": montgomery_kernels.modmul.shapes}.items():
        log(f"joint: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items(), key=str)))
    if rns_kernels.launch_counts() != {"rns_mont_mul": 0, "rns_modexp": 0}:
        fail(f"the joint path launched the RNS kernels {rns_kernels.launch_counts()}")
    if not all(counts[name] > 0 for name in counts):
        fail(f"a kernel of the joint path never launched: {counts}")
    for want, got, where in ((JOINT_DISTRIBUTE, after_distribute, "distribute"),
                             (JOINT_COLLECT, per, "a collect")):
        diff = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if diff:
            fail(f"joint: launches in {where} (got, expected) {diff}")
    log(f"joint: launches match PERF.md section 2: distribute {JOINT_DISTRIBUTE}, "
        f"a collect {JOINT_COLLECT}")

    idx = list(range(t + 1))
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(t, n)).reconstruct(
        idx, [keys[i].keys_linear.x_i for i in idx])
    if GENERATOR * secret != keys[0].y_sum_s or any(k.pk_vec != keys[0].pk_vec for k in keys):
        fail("joint: new shares do not reconstruct the group key, or pk_vec differs")
    with column_path():
        t0 = time.perf_counter()
        RefreshMessage.collect(msgs, column_key[0], column_key[1], config=config)
        times["column_collect"] = time.perf_counter() - t0
    if to_fields(column_key[0]) != to_fields(keys[0]):
        fail("joint: the column path's collect of the same messages adopted another key")
    log("joint: t+1 new shares reconstruct the group key; the column path's collect of the "
        f"same messages adopts the same LocalKey ({times['column_collect']:.3f} s)")
    for field in ("pdl", "range"):
        err, sender, row = _tampered_collect(msgs, spare, config, field)
        with column_path():
            col_err, _, _ = _tampered_collect(msgs, spare, config, field)
        want_cls = "PDLwSlackProofError" if field == "pdl" else "RangeProofError"
        # the PDL error names the sender; the range error, as in the
        # reference, the receiver slot
        want_party = sender if field == "pdl" else row
        if _verdict(err) != _verdict(col_err) or type(err).__name__ != want_cls or \
                err.party_index != want_party:
            fail(f"joint: tampered {field} row raised {_verdict(err)}, the column path "
                 f"{_verdict(col_err)}, expected {want_cls} naming {want_party}")
        log(f"joint: tampered {field} row raised {err!r}, as the column path does")
    if dev.type == "cuda":
        profile_collect(msgs, spare, config, times["collect_median"])
    span_collect(msgs, spare2, config, "joint")
    return counts, shapes, times, rlc_inputs


# Launches a collect of the RLC path (FSDKRC_RLC, FSDKRC_MULTIEXP and
# FSDKRC_RANGEOPT on, the defaults) at n=16, 2048-bit, M=256, 11
# correct-key rounds (PERF.md section 2), worked out from the code before
# the first run on the card: `cios_modexp` for the range's c^{-e} and
# z^{-e} terms, PDL phase 2 (each receiver's s2-aggregate to its n),
# ring-Pedersen's T-ladders and correct-key phase 2; the Straus kernel for
# PDL phase 1 (its aggregated rows of 32 terms cut at 16 into four width
# shapes: mod N~ 128- and 512-bit, mod n^2 128-bit (the s2 and u2 halves)
# and 512-bit), fold_ladder2's merged (h1, h2) rows, ring-Pedersen's
# 257-term rows (16 sub-rows of 16 terms, and the 1-term S row) and
# correct-key's 11-term aggregates; the shared-exponent kernel for the
# range u-powers; the comb, its ladder and table for joint_comb2's two
# bases; `cios_modmul` for the u-power's and joint_comb2's recombinations
# and the range's u and w. The folds leave no PDL or ring-Pedersen product.
RLC_COLLECT = {"cios_modexp": 5, "cios_multi_modexp": 8, "cios_shared_exp": 1,
               "cios_comb": 2, "cios_comb_ladder": 2, "cios_mont_mul": 8, "cios_modmul": 4,
               "ec_scalar_mul": 3, "ec_tree_sum": 3}
# backend.rlc.stats() a collect: 16 mod-N~ and 16 mod-n^2 PDL groups, 16
# ring-Pedersen and 16 correct-key proofs, one full-width ladder each;
# rows folded 256 + 256 + 16 * 256 + 16 * 11
RLC_STATS = {"rlc_groups": 64, "rows_folded": 4784, "fullwidth_ladders": 64,
             "bisect_fallbacks": 0}


def _pair_items(msgs, key):
    """The PDL and range items of `key`'s collect of `msgs`, as collect
    builds them."""
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.proofs.pdl_slack import PDLwSlackStatement

    pdl, rng = [], []
    for msg in msgs:
        for i in range(len(msgs)):
            st = PDLwSlackStatement(
                ciphertext=msg.points_encrypted_vec[i], ek=key.paillier_key_vec[i],
                Q=msg.points_committed_vec[i], G=GENERATOR, h1=key.h1_h2_n_tilde_vec[i].g,
                h2=key.h1_h2_n_tilde_vec[i].ni, N_tilde=key.h1_h2_n_tilde_vec[i].N)
            pdl.append((msg.pdl_proof_vec[i], st))
            rng.append((msg.range_proofs[i], msg.points_encrypted_vec[i],
                        key.paillier_key_vec[i], key.h1_h2_n_tilde_vec[i]))
    return pdl, rng


def phase_rlc(dev, inputs, n=16, t=8, bits=2048, m_security=256, rounds=11):
    """The RLC path under the defaults (FSDKRC_RLC, FSDKRC_MULTIEXP and
    FSDKRC_RANGEOPT on), verifier only, on the joint phase's messages and
    its keys and dks before any collect: every counter and
    backend.rlc.stats() zeroed just before 16 collects and read just
    after. Gates: launches a collect RLC_COLLECT, no RNS launch, the fold
    counters a collect RLC_STATS; t+1 new shares give the group key; a
    party's collect of the same messages at FSDKRC_RLC=0 adopts the same
    LocalKey; five tampered collects (PDL s1, PDL s2, range s,
    ring-Pedersen Z[0], correct-key sigma[0]) raise what FSDKRC_RLC=0
    raises (class, party, PDL verdict tuple); verify_pairs on a PDL s2
    row of sender 7 to receiver 3 gives FSDKRC_RLC=0's whole verdict
    vector, (True, False, True) at that row, through a bisection.
    Profiles one collect and times another layer by layer. Returns
    (counts, shapes of the joint kernels and `cios_modexp`, times, the n
    keys the collects adopted)."""
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.backend import get_backend, rlc
    from fsdkr_tpu_torch.carry import to_fields
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage

    msgs, pre_keys, dks = inputs
    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    if not rlc.rlc_enabled():
        fail("rlc: FSDKRC_RLC is off")
    times = {}
    keys = copy.deepcopy(pre_keys)
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    rlc.stats_reset()
    per_collect = []
    for key, dk in zip(keys, copy.deepcopy(dks)):
        c0 = time.perf_counter()
        RefreshMessage.collect(msgs, key, dk, config=config)
        per_collect.append(time.perf_counter() - c0)
    counts = {**montgomery_kernels.launch_counts(), **ec_kernels.launch_counts()}
    stats = rlc.stats()
    shapes = {"cios_multi_modexp": dict(montgomery_kernels.multi_modexp.shapes),
              "cios_shared_exp": dict(montgomery_kernels.shared_exp_segments.shapes),
              "cios_modexp": dict(montgomery_kernels.modexp_segments.shapes)}
    per = {k: v / n for k, v in counts.items()}
    per_stats = {k: stats[k] / n for k in RLC_STATS}
    times["collect_median"] = sorted(per_collect)[n // 2]
    times["collects_total"] = sum(per_collect)
    log(f"rlc: {n} collects {sum(per_collect):.3f} s, median {times['collect_median']:.4f} s "
        f"(each {min(per_collect):.3f}..{max(per_collect):.3f} s)")
    log("rlc: launches per collect: " + json.dumps(per) + "; fold counters per collect: "
        + json.dumps(per_stats))
    for name, by_shape in {**shapes,
                           "cios_comb": montgomery_kernels.comb.shapes,
                           "cios_comb_ladder": montgomery_kernels.comb_ladder.shapes,
                           "cios_mont_mul": montgomery_kernels.mont_mul.shapes,
                           "cios_modmul": montgomery_kernels.modmul.shapes}.items():
        log(f"rlc: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items(), key=str)))
    if rns_kernels.launch_counts() != {"rns_mont_mul": 0, "rns_modexp": 0}:
        fail(f"the RLC path launched the RNS kernels {rns_kernels.launch_counts()}")
    diff = {k: (per[k], v) for k, v in RLC_COLLECT.items() if per[k] != v}
    if diff:
        fail(f"rlc: launches a collect (got, expected) {diff}")
    if per_stats != RLC_STATS:
        fail(f"rlc: fold counters a collect {per_stats}, expected {RLC_STATS}")
    log(f"rlc: launches match PERF.md section 2: a collect {RLC_COLLECT}; fold counters "
        f"{RLC_STATS}")

    idx = list(range(t + 1))
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(t, n)).reconstruct(
        idx, [keys[i].keys_linear.x_i for i in idx])
    if GENERATOR * secret != keys[0].y_sum_s or any(k.pk_vec != keys[0].pk_vec for k in keys):
        fail("rlc: new shares do not reconstruct the group key, or pk_vec differs")
    off_key = (copy.deepcopy(pre_keys[0]), copy.deepcopy(dks[0]))
    with knobs(FSDKRC_RLC="0"):
        t0 = time.perf_counter()
        RefreshMessage.collect(msgs, off_key[0], off_key[1], config=config)
        times["rlc_off_collect"] = time.perf_counter() - t0
    if to_fields(off_key[0]) != to_fields(keys[0]):
        fail("rlc: the FSDKRC_RLC=0 collect of the same messages adopted another key")
    log("rlc: t+1 new shares reconstruct the group key; the FSDKRC_RLC=0 collect of the "
        f"same messages adopts the same LocalKey ({times['rlc_off_collect']:.3f} s)")

    spare = (pre_keys[1], dks[1])
    want_cls = {"pdl": "PDLwSlackProofError", "pdl_s2": "PDLwSlackProofError",
                "range": "RangeProofError", "ring_pedersen": "RingPedersenProofError",
                "correct_key": "PaillierVerificationError"}
    for field, cls in want_cls.items():
        rlc.stats_reset()
        t0 = time.perf_counter()
        err, sender, row = _tampered_collect(msgs, spare, config, field)
        wall = time.perf_counter() - t0
        bisects = rlc.stats()["bisect_fallbacks"]
        with knobs(FSDKRC_RLC="0"):
            off_err, _, _ = _tampered_collect(msgs, spare, config, field)
        if _verdict(err) != _verdict(off_err) or type(err).__name__ != cls:
            fail(f"rlc: tampered {field} raised {_verdict(err)}, FSDKRC_RLC=0 "
                 f"{_verdict(off_err)}, expected {cls}")
        # the PDL error names the sender, the range error the receiver slot
        if field.startswith("pdl") and err.party_index != sender or \
                field == "range" and err.party_index != row:
            fail(f"rlc: tampered {field} blamed party {err.party_index}")
        if field != "range" and bisects < 1:
            fail(f"rlc: tampered {field} failed no combined check")
        log(f"rlc: tampered {field} raised {err!r}, as FSDKRC_RLC=0 does "
            f"({wall:.3f} s, {bisects} bisections)")

    # one bad PDL s2 row: its mod-n^2 group's combined check fails and
    # bisects down to it; every other verdict as at FSDKRC_RLC=0
    bad = copy.deepcopy(msgs)
    bad_sender, bad_receiver = 7, 3
    p = bad[bad_sender].pdl_proof_vec[bad_receiver]
    bad[bad_sender].pdl_proof_vec[bad_receiver] = type(p)(
        z=p.z, u1=p.u1, u2=p.u2, u3=p.u3, s1=p.s1, s2=p.s2 + 1, s3=p.s3)
    pdl_items, range_items = _pair_items(bad, pre_keys[0])
    verdicts = {}
    for leg in ("1", "0"):
        with knobs(FSDKRC_RLC=leg):
            rlc.stats_reset()
            t0 = time.perf_counter()
            verdicts[leg] = get_backend(config).verify_pairs(pdl_items, range_items)
            times[f"bisect_verify_pairs_rlc{leg}"] = time.perf_counter() - t0
            if leg == "1":
                bisect_stats = rlc.stats()
    pdl_v, range_v = verdicts["1"]
    bad_row = bad_sender * n + bad_receiver
    if verdicts["1"] != verdicts["0"] or not all(range_v) or pdl_v[bad_row] != \
            (True, False, True) or any(v is not None for i, v in enumerate(pdl_v)
                                       if i != bad_row):
        fail(f"rlc: the bisection's verdicts differ from FSDKRC_RLC=0's or miss row "
             f"{bad_row}: {pdl_v[bad_row]}")
    if bisect_stats["bisect_fallbacks"] < 1:
        fail(f"rlc: the bad s2 row ran no bisection: {bisect_stats}")
    log(f"rlc: bisection: verify_pairs' verdicts == FSDKRC_RLC=0's, row {bad_row} "
        f"{pdl_v[bad_row]}, {bisect_stats['bisect_fallbacks']} bisections "
        f"({times['bisect_verify_pairs_rlc1']:.3f} s; FSDKRC_RLC=0 "
        f"{times['bisect_verify_pairs_rlc0']:.3f} s)")

    if dev.type == "cuda":
        profile_collect(msgs, (copy.deepcopy(pre_keys[2]), copy.deepcopy(dks[2])), config,
                        times["collect_median"])
    span_collect(msgs, (copy.deepcopy(pre_keys[3]), copy.deepcopy(dks[3])), config, "rlc")
    return counts, shapes, times, keys


def collect_spans(n, m_security, rounds):
    """The protocol and family spans, with their items, of one default
    collect (FSDKRC_RLC, FSDKRC_MULTIEXP and FSDKRC_RANGEOPT on) of n
    honest senders' messages without joins, one call each: the list
    tests/test_torch_trace.py holds against the JAX package's at n=3."""
    rows = n * n
    return {
        "collect": 1, "collect.validate_feldman": rows, "collect.verify_pairs": 2 * rows,
        "collect.verify_ring_pedersen": n, "collect.verify_correct_key": n,
        "collect.share_recovery": 1, "collect.adopt": 1,
        "pdl.challenge": rows, "pdl.modexp_columns": rows, "pdl.rlc_eq3": rows,
        "pdl.rlc_eq2": rows, "pdl.ec_u1": rows, "pairs.modexp_columns": 2 * rows,
        "range.base_inv": 2 * rows, "range.u_pow": rows, "range.comb2": rows,
        "range.z_e": rows, "range.combine": rows, "range.challenge": rows,
        "ringped.challenge": n, "ringped.modexp": n * (m_security + 2),
        "correct_key.rho_derive": n, "correct_key.modexp": n * (rounds + 1),
    }


def _nesting_faults(spans):
    """Spans that end outside their parent's interval."""
    by_id = {sp.span_id: sp for sp in spans}
    return [(sp.name, by_id[sp.parent_id].name) for sp in spans
            if sp.parent_id in by_id and not (by_id[sp.parent_id].t0 <= sp.t0
                                              and sp.t1 <= by_id[sp.parent_id].t1)]


def phase_trace(dev, inputs, ref_keys, n=16, t=8, bits=2048, m_security=256, rounds=11,
                party=4, tile_budget_mb="2", overhead_runs=5):
    """The span tracer on the rlc phase's inputs (the module docstring's
    `trace`). `ref_keys`: the keys the rlc phase's untraced collects
    adopted. Returns the phase's times."""
    import threading

    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.carry import to_fields
    from fsdkr_tpu_torch.native import gmp
    from fsdkr_tpu_torch.ops import tally
    from fsdkr_tpu_torch.protocol import RefreshMessage
    from fsdkr_tpu_torch.telemetry.spans import get_tracer

    msgs, pre_keys, dks = inputs
    config = ProtocolConfig(paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
                            backend="cuda", device=dev.type)
    tr = get_tracer()
    times = {}

    def collect(traced, **env):
        key, dk = copy.deepcopy(pre_keys[party]), copy.deepcopy(dks[party])
        gc.collect()
        if traced:
            tr.reset()
            tally.reset_phases()
            tr.enable()
        try:
            with knobs(**env):
                t0 = time.perf_counter()
                RefreshMessage.collect(msgs, key, dk, config=config)
                wall = time.perf_counter() - t0
        finally:
            tr.disable()
        if to_fields(key) != to_fields(ref_keys[party]):
            fail(f"trace: party {party + 1}'s {'traced ' if traced else ''}collect adopted "
                 f"another key than the rlc phase's untraced collect")
        return wall

    gmp.stats_reset()
    times["traced_collect"] = collect(True)
    stats, spans, launches = tr.stats(), tr.spans(), tally.by_phase()
    # the share recovery's encrypt(0) and t+1 homomorphic muls mod n^2
    # (the collect's other GMP rows: decrypt's two mpz_powm_sec legs)
    gst = gmp.stats()
    recovery = stats.get("collect.share_recovery")
    if recovery is None or gst["powm_rows"] - gst["powm_sec_rows"] < t + 2:
        fail(f"trace: collect.share_recovery's Paillier rows did not run on GMP: {gst}")
    times["share_recovery"] = recovery.seconds
    log(f"trace: collect.share_recovery {recovery.seconds:.4f} s of the traced collect, its "
        f"{t + 2} Paillier rows on GMP (the collect's GMP rows {json.dumps(gst)})")
    os.makedirs("chiprun_out", exist_ok=True)
    tr.write_chrome_trace(os.path.join("chiprun_out", "collect_trace.json"))
    got = {k: (v.calls, v.items) for k, v in stats.items() if k != "(unphased)"}
    want = {k: (1, items) for k, items in collect_spans(n, m_security, rounds).items()}
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)}
        fail(f"trace: spans (calls, items) differ from collect_spans (got, expected): {diff}")
    bad = _nesting_faults(spans)
    if bad or tr.spans_dropped():
        fail(f"trace: spans outside their parents {bad[:4]}, {tr.spans_dropped()} dropped")
    bare = {k: c for k, c in launches.items() if c and (k not in stats or stats[k].macs <= 0)}
    if bare or dev.type == "cuda" and not launches:  # the plain versions count none
        fail(f"trace: phases that launched kernels without MACs: {bare} (launches by phase "
             f"{launches})")
    mfu = {k: (round(v.seconds, 6), round(100 * v.mfu(H100_PEAK_MACS), 4))
           for k, v in sorted(stats.items(), key=lambda kv: -kv[1].seconds)}
    log(f"trace: one traced collect {times['traced_collect']:.4f} s, {len(spans)} spans "
        f"(calls and items as collect_spans({n}, {m_security}, {rounds})), every span inside "
        f"its parent, chiprun_out/collect_trace.json written; launches by phase "
        f"{json.dumps(launches)}, each with MACs; the same key as the untraced collect")
    log("trace: phase (seconds, MFU % of the H100's 247.4e12 16-bit MAC/s): " + json.dumps(mfu))

    # the memory plan's tiles: the staging of each tile runs on the
    # prefetch worker, its spans parented to the submitting phase
    times["traced_tiled_collect"] = collect(True, FSDKRC_MEM_BUDGET_MB=tile_budget_mb)
    spans = tr.spans()
    main_tid = threading.main_thread().ident
    by_id = {sp.span_id: sp for sp in spans}
    worker = [sp for sp in spans if sp.tid != main_tid]
    parents = {by_id[sp.parent_id].name if sp.parent_id in by_id else None for sp in worker}
    if not worker or parents != {"pairs.stream_tiles"} or _nesting_faults(spans):
        fail(f"trace: the tiled collect's worker spans {[sp.name for sp in worker][:6]} parent "
             f"to {parents}, not pairs.stream_tiles alone, or a span outside its parent")
    log(f"trace: a tiled collect (FSDKRC_MEM_BUDGET_MB={tile_budget_mb}) "
        f"{times['traced_tiled_collect']:.4f} s: "
        f"{len(worker)} spans on the prefetch worker ({sorted({sp.name for sp in worker})}), "
        f"each parented to pairs.stream_tiles; the same key")

    # the tracer's cost: 5 collects each way, interleaved, after gc
    walls = {False: [], True: []}
    for _ in range(overhead_runs):
        for traced in (False, True):
            walls[traced].append(collect(traced))
    off, on = (sorted(walls[k])[overhead_runs // 2] for k in (False, True))
    times.update(collect_off_median=off, collect_on_median=on, overhead=on / off - 1,
                 walls_off=walls[False], walls_on=walls[True])
    log(f"trace: collect median over {overhead_runs}, tracer off {off:.4f} s, on {on:.4f} s: "
        f"overhead "
        f"{100 * (on / off - 1):.2f}% (the JAX package's budget: 2%; not gated); off "
        f"{[round(w, 4) for w in walls[False]]}, on {[round(w, 4) for w in walls[True]]}")
    tr.reset()
    return times


# Launches of the join path (the defaults: FSDKRC_RLC, FSDKRC_MULTIEXP and
# FSDKRC_RANGEOPT on) at n=16, t=8, 2048-bit, M=256, 11 correct-key rounds
# (PERF.md section 2), worked out from the code and a CPU drive at n=16
# (1024-bit, the wrappers counted on the CPU) before the first run on the
# card. A JoinMessage.distribute: the ring-Pedersen prover's 256 rows share
# (T, N), so the comb, its ladder and its table's four products;
# correct-key's 11 rows one `cios_modexp`; the composite-dlog proofs on the
# host. A replace: distribute_batch for one sender, as JOINT_DISTRIBUTE for
# 16. A collect of 14 senders' messages with two joins: RLC_COLLECT's
# launches, plus the joins' composite-dlog rows (g^y and ni^e, one
# `cios_modexp` launch each, and their product, one `cios_modmul`), plus
# one Straus launch (a receiver's 28-term PDL rows split at 16 into two
# width shapes where 32 terms split into one). A JoinMessage.collect:
# Feldman's and pk_vec's MSMs, ring-Pedersen's folds for 16 proofs (the
# 257-term rows and the S row, then the T-ladders' `cios_modexp`).
JOIN_DISTRIBUTE = {"cios_modexp": 1, "cios_comb": 1, "cios_comb_ladder": 1, "cios_mont_mul": 4}
JOIN_REPLACE = {"cios_modexp": 3, "cios_multi_modexp": 2, "cios_comb": 1, "cios_comb_ladder": 1,
                "cios_mont_mul": 4, "ec_scalar_mul": 3}
JOIN_COLLECT = {"cios_modexp": 7, "cios_multi_modexp": 9, "cios_shared_exp": 1,
                "cios_comb": 2, "cios_comb_ladder": 2, "cios_mont_mul": 8, "cios_modmul": 5,
                "ec_scalar_mul": 3, "ec_tree_sum": 3}
JOIN_JOINER = {"cios_modexp": 1, "cios_multi_modexp": 2, "ec_scalar_mul": 2, "ec_tree_sum": 2}


def _launches():
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels

    return {**montgomery_kernels.launch_counts(), **ec_kernels.launch_counts(),
            **rns_kernels.launch_counts()}


def _sub(after, before):
    return {k: after[k] - before[k] for k in after}


def _gate_launches(label, got, want, phase="join"):
    diff = {k: (got.get(k, 0), want.get(k, 0)) for k in set(got) | set(want)
            if got.get(k, 0) != want.get(k, 0)}
    if diff:
        fail(f"{phase}: launches in {label} (got, expected) {diff}")


def phase_join(dev, pre, n=16, t=8, bits=2048, m_security=256, rounds=11):
    """Join, replace and removal under the defaults, from the main phase's
    keys before distribute, mirroring the reference's add-party scenario:
    parties 2 and n leave, the n - 2 survivors are remapped by a fixed
    permutation (the survivors' indices reversed) onto their own index
    set, two JoinMessage.distribute take indices 2 and n, then n - 2
    replaces, n - 2 collects with both joins and 2 JoinMessage.collect.
    Every counter is zeroed just before the round and read just after;
    each call's own launches are gated (JOIN_DISTRIBUTE, JOIN_REPLACE,
    JOIN_COLLECT, JOIN_JOINER). Gates: the keys' indices are 1..n; t + 1
    new shares, both joiners' among them, reconstruct the old secret,
    whose multiple of G is the group key; every key holds one pk_vec with
    pk_vec[i - 1] == G * x_i; a quorum of t + 1 holding both joiners
    signs (simulate_offline_stage, simulate_signing); a joiner's tampered
    composite-dlog y raises DLogProofValidation and its tampered
    correct-key sigma PaillierVerificationError, both naming it. Returns
    (the round's launches by kernel, its launch shapes, times, and for the
    sessions phase the messages, the joins, the first survivor's key and
    dk before its collect and the key that collect adopted)."""
    import dataclasses

    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.backend import rlc
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.errors import DLogProofValidation, PaillierVerificationError
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import (JoinMessage, RefreshMessage, simulate_offline_stage,
                                          simulate_signing)

    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    if not rlc.rlc_enabled():
        fail("join: FSDKRC_RLC is off")
    removed = (2, n)
    old = copy.deepcopy(pre)
    params = vss.VerifiableSS(vss.ShamirSecretSharing(t, n))
    old_secret = params.reconstruct(list(range(t + 1)),
                                    [k.keys_linear.x_i for k in old[: t + 1]])
    survivors = [k for k in old if k.i not in removed]
    old_to_new = dict(zip([k.i for k in survivors], reversed([k.i for k in survivors])))
    times = {"join_distribute": [], "replace": [], "collect": [], "joiner_collect": []}

    def timed(key, fn, *args, **kwargs):
        c0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times[key].append(time.perf_counter() - c0)
        return out

    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    joins, pairs = [], []
    for idx in removed:
        before = _launches()
        jm, pair = timed("join_distribute", JoinMessage.distribute, config)
        _gate_launches("a JoinMessage.distribute", _sub(_launches(), before), JOIN_DISTRIBUTE)
        jm.set_party_index(idx)
        joins.append(jm)
        pairs.append(pair)
    msgs, dks = [], []
    for key in survivors:
        before = _launches()
        msg, dk = timed("replace", RefreshMessage.replace, joins, key, old_to_new, n, config)
        _gate_launches(f"party {msg.old_party_index}'s replace", _sub(_launches(), before),
                       JOIN_REPLACE)
        msgs.append(msg)
        dks.append(dk)
    if sorted(k.i for k in survivors) != [i for i in range(1, n + 1) if i not in removed]:
        fail("join: replace did not remap the survivors onto their index set")
    # the tampered collects run on copies of this pre-collect (key, dk), the
    # profiled collect at the end on it
    spare = (copy.deepcopy(survivors[0]), copy.deepcopy(dks[0]))
    # the same, for the sessions phase, with the key this collect adopts
    session_pre = (copy.deepcopy(survivors[0]), copy.deepcopy(dks[0]))
    for key, dk in zip(survivors, dks):
        before = _launches()
        timed("collect", RefreshMessage.collect, msgs, key, dk, joins, config=config)
        _gate_launches(f"party {key.i}'s collect", _sub(_launches(), before), JOIN_COLLECT)
    new_keys = list(survivors)
    adopted = copy.deepcopy(survivors[0])
    for jm, pair in zip(joins, pairs):
        before = _launches()
        new_keys.append(timed("joiner_collect", jm.collect, msgs, pair, joins, t, n, config))
        _gate_launches(f"joiner {jm.party_index}'s JoinMessage.collect",
                       _sub(_launches(), before), JOIN_JOINER)
    counts = _launches()
    shapes = {
        "cios_mont_mul": dict(montgomery_kernels.mont_mul.shapes),
        "cios_modmul": dict(montgomery_kernels.modmul.shapes),
        "cios_modexp": dict(montgomery_kernels.modexp_segments.shapes),
        "cios_comb": dict(montgomery_kernels.comb.shapes),
        "cios_comb_ladder": dict(montgomery_kernels.comb_ladder.shapes),
        "cios_multi_modexp": dict(montgomery_kernels.multi_modexp.shapes),
        "cios_shared_exp": dict(montgomery_kernels.shared_exp_segments.shapes),
        "ec_scalar_mul": dict(ec_kernels.scalar_mul.shapes),
        "ec_tree_sum": dict(ec_kernels.tree_sum.shapes),
    }
    log(f"join: the round's launches: {json.dumps(counts)}")
    for name, by_shape in shapes.items():
        log(f"join: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items(), key=str)))
    log(f"join: launches match PERF.md section 2: a JoinMessage.distribute {JOIN_DISTRIBUTE}, "
        f"a replace {JOIN_REPLACE}, a collect {JOIN_COLLECT}, a JoinMessage.collect "
        f"{JOIN_JOINER}")

    keys = sorted(new_keys, key=lambda k: k.i)
    if [k.i for k in keys] != list(range(1, n + 1)) or any(k.n != n for k in keys):
        fail(f"join: the new committee's indices are {[k.i for k in keys]}")
    # t + 1 parties holding both joiners
    quorum = sorted([*removed, *[i for i in range(1, n + 1) if i not in removed][: t - 1]])
    idx = [i - 1 for i in quorum]
    secret = params.reconstruct(idx, [keys[i].keys_linear.x_i for i in idx])
    if secret != old_secret or GENERATOR * secret != keys[0].y_sum_s:
        fail("join: the new shares do not reconstruct the old secret and group key")
    if any(k.pk_vec != keys[0].pk_vec for k in keys) or any(
            k.pk_vec[k.i - 1] != GENERATOR * k.keys_linear.x_i for k in keys):
        fail("join: the keys disagree on pk_vec, or pk_vec[i - 1] != G * x_i")
    log(f"join: indices 1..{n}; shares {quorum} (joiners {list(removed)} among them) "
        f"reconstruct the old secret and the group key; one pk_vec, pk_vec[i - 1] == G * x_i")
    c0 = time.perf_counter()
    simulate_signing(simulate_offline_stage(keys, quorum), b"fs-dkr join")
    times["signing"] = time.perf_counter() - c0
    log(f"join: quorum {quorum} signed; the signature verifies ({times['signing']:.3f} s)")

    def bump_y(j):
        p = j.composite_dlog_proof_base_h1
        j.composite_dlog_proof_base_h1 = dataclasses.replace(p, y=p.y + 1)

    def bump_sigma(j):
        p = j.dk_correctness_proof
        j.dk_correctness_proof = dataclasses.replace(
            p, sigma_vec=[p.sigma_vec[0] + 1] + list(p.sigma_vec[1:]))

    for field, mutate, cls in (("composite_dlog_y", bump_y, DLogProofValidation),
                               ("correct_key_sigma", bump_sigma, PaillierVerificationError)):
        bad = copy.deepcopy(joins)
        mutate(bad[0])
        c0 = time.perf_counter()
        try:
            RefreshMessage.collect(msgs, copy.deepcopy(spare[0]), copy.deepcopy(spare[1]), bad,
                                   config=config)
        except cls as e:
            if e.party_index != removed[0]:
                fail(f"join: tampered {field} blamed party {e.party_index}, "
                     f"expected {removed[0]}")
            times[f"tampered_{field}"] = time.perf_counter() - c0
            log(f"join: tampered {field} raised {e!r}")
        else:
            fail(f"join: a tampered {field} passed collect")
    for key in ("join_distribute", "replace", "collect", "joiner_collect"):
        each = times[key]
        log(f"join: {key}: {len(each)} calls, {sum(each):.3f} s, median "
            f"{sorted(each)[len(each) // 2]:.4f} s (each {min(each):.3f}..{max(each):.3f} s)")
    if dev.type == "cuda":
        profile_collect(msgs, spare, config, sorted(times["collect"])[len(survivors) // 2],
                        joins)
    return counts, shapes, times, (msgs, joins, session_pre, adopted)


# Launches of the sessions phase (the defaults: FSDKRC_RLC,
# FSDKRC_MULTIEXP and FSDKRC_RANGEOPT on) at n=16, t=8, 2048-bit, M=256,
# 11 correct-key rounds (PERF.md section 2), worked out from the code and
# a CPU drive at n=16 (1024-bit, the wrappers counted on the CPU) before
# the first run on the card; all three met by
# `scripts/sessions_launch_drive.py` at 1536 bits, where the comb's group
# cap is the 2048-bit one. SESSIONS_FUSED: one collect_sessions call of the 16 receivers of
# one round. Feldman's 4,096 rows are one MSM; the pair rows dedup to one
# session's 256, one collect's pair launches; ring-Pedersen and correct-key
# fold 256 proofs each in the launches of one collect's 16; each session's
# pk_vec is its own MSM (16).
SESSIONS_FUSED = {"cios_modexp": 5, "cios_multi_modexp": 8, "cios_shared_exp": 1,
                  "cios_comb": 2, "cios_comb_ladder": 2, "cios_mont_mul": 8, "cios_modmul": 4,
                  "ec_scalar_mul": 18, "ec_tree_sum": 18}
# backend.rlc.stats() of that call: 32 PDL groups (one session's, after the
# dedup), 256 ring-Pedersen and 256 correct-key proofs; rows folded
# 512 + 256 * 256 + 256 * 11
SESSIONS_FUSED_STATS = {"rlc_groups": 544, "rows_folded": 68864, "fullwidth_ladders": 544,
                        "bisect_fallbacks": 0, "xsession_rows_deduped": 3840}
# SESSIONS_TWO: the round's receiver 1 and the join round's first
# survivor in one call (honest): Feldman's MSM, the 480 pair rows' launch
# set (merged groups of 30 rows give the PDL Straus rows more width shapes
# than a collect's 16), 32 ring-Pedersen and correct-key proofs, the
# joins' composite-dlog rows (two `cios_modexp`, one `cios_modmul`), two
# pk_vec MSMs. joint_comb2's h2 comb holds 18 receiver environments (16
# parties' and the 2 joiners'), past the comb's 16-group cap at 2048-bit
# s2 (`device_powm_shared`: 16384 // 768 windows, rounded down to a power
# of two), so it takes two launches with their ladders and tables: the CPU
# drive at 1024-bit (a cap of 32) gave one, the card two.
SESSIONS_TWO = {"cios_modexp": 7, "cios_multi_modexp": 13, "cios_shared_exp": 1,
                "cios_comb": 3, "cios_comb_ladder": 3, "cios_mont_mul": 12, "cios_modmul": 5,
                "ec_scalar_mul": 4, "ec_tree_sum": 4}
# SESSIONS_TILED: one collect at FSDKRC_MEM_BUDGET_MB=2, its 256 pair rows
# in 4 tiles (81, 81, 81, 13). A tile repeats the range engines (`cios_shared_exp`, two
# `cios_modexp`, joint_comb2's two combs, ladders and eight table
# products, four `cios_modmul`), its PDL aggregated rows (Straus; the last
# tile's 13 rows leave 1-term s2 rows, one `cios_modexp` more) and its u1
# MSM; then fold_ladder2 and PDL phase 2 once, ring-Pedersen, correct-key,
# Feldman and pk_vec as in a collect.
SESSIONS_TILED = {"cios_modexp": 12, "cios_multi_modexp": 24, "cios_shared_exp": 4,
                  "cios_comb": 8, "cios_comb_ladder": 8, "cios_mont_mul": 32, "cios_modmul": 16,
                  "ec_scalar_mul": 6, "ec_tree_sum": 6}


@contextlib.contextmanager
def pair_launches(out):
    """Adds into `out` the launches made inside CudaBatchVerifier.verify_pairs
    (its outermost calls: the dedup's call on the distinct rows is inside
    one) while the block runs."""
    from fsdkr_tpu_torch.backend.cuda_verifier import CudaBatchVerifier

    raw = CudaBatchVerifier.verify_pairs
    depth = [0]

    def counted(self, *args, **kwargs):
        depth[0] += 1
        before = _launches() if depth[0] == 1 else None
        try:
            return raw(self, *args, **kwargs)
        finally:
            if depth[0] == 1:
                for k, v in _sub(_launches(), before).items():
                    out[k] = out.get(k, 0) + v
            depth[0] -= 1

    CudaBatchVerifier.verify_pairs = counted
    try:
        yield out
    finally:
        CudaBatchVerifier.verify_pairs = raw


def phase_sessions(dev, inputs, own_keys, join_inputs, n=16, t=8, bits=2048, m_security=256,
                   rounds=11, tile_budget_mb="2"):
    """The barrier collect in full under the defaults: fused multi-session
    collect_sessions with cross-session dedup and session-first blame, and
    the memory plan's tiled pair verify. `inputs` are the joint phase's
    messages with every receiver's key and dk before any collect (the rlc
    phase's inputs), `own_keys` the keys the rlc phase's own collects of
    them adopted, `join_inputs` the join phase's messages, joins, first
    survivor's key and dk before its collect and the key that collect
    adopted. Every counter is zeroed just before the phase's gated calls
    and read just after them.

    (a) All n receivers in one collect_sessions call: every session adopts
    its own collect's key; the fold counters SESSIONS_FUSED_STATS (n=16:
    3,840 pair rows deduped); the pair families' launches are one
    collect's; the call's launches SESSIONS_FUSED. (b) The round fused with the join round (a committee
    sharing the survivors' moduli, so the RLC groups merge): both adopt
    their own collects' keys, nothing dedups; with a PDL s2 row of the join
    round tampered, that session gets the error its own collect raises,
    the other adopts, and the merged group bisects session-first. (c) At
    FSDKRC_MEM_BUDGET_MB=2 a collect cuts its pair rows into 4 tiles of
    (81, 81, 81, 13) and adopts the monolithic key with RLC_STATS' ladders;
    its launches SESSIONS_TILED; a tampered PDL s2 row raises what the
    monolithic collect raises (`tile_budget_mb`: 81-row tiles at 2048
    bits). Each case's wall time, and on the card its device busy time
    beside the unfused or monolithic call's. Returns (the phase's launches
    by kernel, its launch shapes, times)."""
    import dataclasses

    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.backend import memplan, rlc
    from fsdkr_tpu_torch.carry import to_fields
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage

    msgs, pre_keys, dks = inputs
    jmsgs, joins, jpre, jown = join_inputs
    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    if not rlc.rlc_enabled():
        fail("sessions: FSDKRC_RLC is off")
    times = {}

    def session(r):
        return (msgs, copy.deepcopy(pre_keys[r]), copy.deepcopy(dks[r]), ())

    def join_session(bmsgs):
        return (bmsgs, copy.deepcopy(jpre[0]), copy.deepcopy(jpre[1]), joins)

    def timed(key, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times[key] = time.perf_counter() - t0
        return out

    def same_key(got, want, what):
        if to_fields(got) != to_fields(want):
            fail(f"sessions: {what} adopted another key than its own collect")

    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()

    # ---- (a) the n receivers of one round in one call ------------------
    one_pairs, fused_pairs = {}, {}
    one = session(0)
    with pair_launches(one_pairs):
        before = _launches()
        timed("collect", RefreshMessage.collect, *one[:3], config=config)
        one_collect = _sub(_launches(), before)
    same_key(one[1], own_keys[0], "a collect")
    sessions = [session(r) for r in range(n)]
    rlc.stats_reset()
    with pair_launches(fused_pairs):
        before = _launches()
        errs = timed("fused", RefreshMessage.collect_sessions, sessions, config)
        fused = _sub(_launches(), before)
    stats = rlc.stats()
    if errs != [None] * n:
        fail(f"sessions: (a) the fused call returned errors {errs}")
    for r, (_, key, _, _) in enumerate(sessions):
        same_key(key, own_keys[r], f"(a) session {r}")
    if {k: stats[k] for k in SESSIONS_FUSED_STATS} != SESSIONS_FUSED_STATS:
        fail(f"sessions: (a) fold counters {stats}, expected {SESSIONS_FUSED_STATS}")
    if fused_pairs != one_pairs:
        fail(f"sessions: (a) the fused pair launches {fused_pairs} differ from one collect's "
             f"{one_pairs}")
    _gate_launches("(a) the fused call", fused, SESSIONS_FUSED, "sessions")
    log(f"sessions: (a) {n} sessions in one call: {times['fused']:.3f} s (one collect "
        f"{times['collect']:.3f} s); every session adopts its own collect's key; "
        f"{stats['xsession_rows_deduped']} pair rows deduped; pair launches == one collect's "
        f"{json.dumps(one_pairs)}; the call's launches {json.dumps(fused)} (one collect's "
        f"{json.dumps(one_collect)}); fold counters {json.dumps(stats)}")

    # ---- (b) two committees sharing the survivors' moduli --------------
    rlc.stats_reset()
    before = _launches()
    two = [session(0), join_session(jmsgs)]
    errs = timed("two_committees", RefreshMessage.collect_sessions, two, config)
    two_launches = _sub(_launches(), before)
    stats = rlc.stats()
    if errs != [None, None]:
        fail(f"sessions: (b) the honest fused call returned errors {errs}")
    _gate_launches("(b) the two committees' call", two_launches, SESSIONS_TWO, "sessions")
    same_key(two[0][1], own_keys[0], "(b) the round's session")
    same_key(two[1][1], jown, "(b) the join round's session")
    if stats["xsession_rows_deduped"] or stats["bisect_fallbacks"]:
        fail(f"sessions: (b) honest fold counters {stats}")
    bad = copy.deepcopy(jmsgs)
    sender, row = len(bad) // 3, n // 5
    p = bad[sender].pdl_proof_vec[row]
    bad[sender].pdl_proof_vec[row] = dataclasses.replace(p, s2=p.s2 + 1)
    try:
        RefreshMessage.collect(*join_session(bad)[:3], joins, config=config)
    except Exception as e:  # noqa: BLE001 - compared below, class and fields
        own_err = e
    else:
        fail("sessions: (b) a tampered join-round collect passed")
    rlc.stats_reset()
    two = [session(0), join_session(bad)]
    errs = timed("two_committees_tampered", RefreshMessage.collect_sessions, two, config)
    bstats = rlc.stats()
    if errs[0] is not None or errs[1] is None or _verdict(errs[1]) != _verdict(own_err) or \
            errs[1].party_index != bad[sender].party_index:
        fail(f"sessions: (b) tampered: {errs}, the session's own collect {own_err!r}")
    same_key(two[0][1], own_keys[0], "(b) the honest session beside a tampered one")
    if bstats["session_bisects"] < 1:
        fail(f"sessions: (b) the tampered group bisected no session first: {bstats}")
    log(f"sessions: (b) the round fused with the join round: {times['two_committees']:.3f} s, "
        f"both adopt their own collects' keys, launches {json.dumps(two_launches)}; a tampered "
        f"PDL s2 row of sender {bad[sender].party_index} in the join round: "
        f"{times['two_committees_tampered']:.3f} s, {errs[1]!r} as its own collect raises, the "
        f"other session adopts; fold counters {json.dumps(bstats)}")

    # ---- (c) the memory plan: 4 tiles at 2 MiB -------------------------
    tiled_one = session(2)
    with knobs(FSDKRC_MEM_BUDGET_MB=tile_budget_mb):
        memplan.stats_reset()
        rlc.stats_reset()
        before = _launches()
        timed("tiled", RefreshMessage.collect, *tiled_one[:3], config=config)
        tiled = _sub(_launches(), before)
        stats, mem = rlc.stats(), memplan.mem_stats()
    same_key(tiled_one[1], own_keys[2], "(c) the tiled collect")
    if stats["stream_tiles"] != 4 or mem["tile_rows"].get("pairs") != 81 or \
            stats["fullwidth_ladders"] != RLC_STATS["fullwidth_ladders"] or \
            stats["rows_folded"] != RLC_STATS["rows_folded"]:
        fail(f"sessions: (c) tiled fold counters {stats}, plan {mem}")
    _gate_launches("(c) the tiled collect", tiled, SESSIONS_TILED, "sessions")
    spare = (pre_keys[3], dks[3])
    mono_err, sender, row = _tampered_collect(msgs, spare, config, "pdl_s2")
    with knobs(FSDKRC_MEM_BUDGET_MB=tile_budget_mb):
        t0 = time.perf_counter()
        tiled_err, _, _ = _tampered_collect(msgs, spare, config, "pdl_s2")
        times["tiled_tampered"] = time.perf_counter() - t0
    if _verdict(tiled_err) != _verdict(mono_err) or tiled_err.party_index != sender:
        fail(f"sessions: (c) tiled tamper {_verdict(tiled_err)}, monolithic {_verdict(mono_err)}")
    log(f"sessions: (c) at {tile_budget_mb} MiB: {times['tiled']:.3f} s (one monolithic collect "
        f"{times['collect']:.3f} s), 4 tiles of {mem['tile_rows']['pairs']} rows, peak "
        f"{mem['peak_staged_bytes_est']} staged bytes (the plan's estimate), the monolithic "
        f"key and "
        f"{stats['fullwidth_ladders']} full-width ladders, launches {json.dumps(tiled)}; a "
        f"tampered PDL s2 row raises {tiled_err!r} as the monolithic collect does")

    counts = _launches()
    shapes = {
        "cios_mont_mul": dict(montgomery_kernels.mont_mul.shapes),
        "cios_modmul": dict(montgomery_kernels.modmul.shapes),
        "cios_modexp": dict(montgomery_kernels.modexp_segments.shapes),
        "cios_comb": dict(montgomery_kernels.comb.shapes),
        "cios_comb_ladder": dict(montgomery_kernels.comb_ladder.shapes),
        "cios_multi_modexp": dict(montgomery_kernels.multi_modexp.shapes),
        "cios_shared_exp": dict(montgomery_kernels.shared_exp_segments.shapes),
        "ec_scalar_mul": dict(ec_kernels.scalar_mul.shapes),
        "ec_tree_sum": dict(ec_kernels.tree_sum.shapes),
    }
    log(f"sessions: the phase's launches: {json.dumps(counts)}")
    for name, by_shape in shapes.items():
        log(f"sessions: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items(), key=str)))
    if any(counts[k] for k in ("rns_mont_mul", "rns_modexp")):
        fail(f"sessions: the RNS kernels launched {counts}")
    if not all(counts[name] > 0 for name in shapes):
        fail(f"sessions: a kernel of the path never launched: {counts}")

    if dev.type == "cuda":
        # device busy time of each case beside the unfused or monolithic call
        busy = {}
        busy["collect"] = device_busy(lambda: RefreshMessage.collect(*session(0)[:3],
                                                                     config=config))
        busy["fused"] = device_busy(lambda: RefreshMessage.collect_sessions(
            [session(r) for r in range(n)], config))
        busy["two_committees"] = device_busy(lambda: RefreshMessage.collect_sessions(
            [session(0), join_session(jmsgs)], config))
        with knobs(FSDKRC_MEM_BUDGET_MB=tile_budget_mb):
            busy["tiled"] = device_busy(lambda: RefreshMessage.collect(*session(2)[:3],
                                                                       config=config))
        for label, (wall_ms, busy_ms, by_name) in busy.items():
            times[f"{label}_busy_ms"] = busy_ms
            top = ", ".join(f"{name} {sum(v for key, v in by_name.items() if sym in key):.2f}"
                            for name, sym in _SYMBOL.items()
                            if any(sym in key for key in by_name))
            log(f"sessions: profile {label}: wall {wall_ms:.1f} ms under the profiler, device "
                f"busy {busy_ms:.1f} ms; by kernel (ms): {top}")
        log(f"sessions: the fused call's busy {busy['fused'][1]:.1f} ms against {n} collects' "
            f"{n * busy['collect'][1]:.1f} ms ({n} x {busy['collect'][1]:.1f}); the tiled "
            f"collect's {busy['tiled'][1]:.1f} ms against the monolithic {busy['collect'][1]:.1f}")
        # the device memory verify_pairs allocates, at two row counts: a
        # fixed part and a part a row, beside the plan's estimate
        mono = pair_staging(dev, lambda: RefreshMessage.collect(*session(0)[:3], config=config))
        with knobs(FSDKRC_MEM_BUDGET_MB=tile_budget_mb):
            tile = pair_staging(dev, lambda: RefreshMessage.collect(*session(2)[:3],
                                                                    config=config))
        per_row = max(0.0, (mono - tile) / (n * n - 81))
        fixed = mono - n * n * per_row
        budget = memplan.mem_budget_bytes(dev)
        est = memplan.pair_row_bytes(2 * bits, bits)
        shapes_rows = (n * n, 64 * n * n, 65536)  # a collect, config 5, n=256
        plan_tiles = [-(-rows // max(1, budget // (est * 2))) for rows in shapes_rows]
        projected = [fixed + rows * per_row for rows in shapes_rows]
        log(f"sessions: device memory verify_pairs allocates above what was live at its call: "
            f"{mono} B at {n * n} rows, {tile} B in 81-row tiles, so {fixed:.0f} B fixed and "
            f"{per_row:.1f} B a row (the plan's estimate {est} B a row, nothing fixed); the "
            f"default budget {budget} B (half the free device memory) gives "
            + ", ".join(f"{rows} rows {tiles} tile(s) (projected peak {peak:.0f} B)"
                        for rows, tiles, peak in zip(shapes_rows, plan_tiles, projected)))
        if any(tiles != 1 for tiles in plan_tiles) or max(projected) > budget:
            fail(f"sessions: the default budget {budget} B tiles a benchmark shape or is "
                 f"below its projected peak: tiles {plan_tiles}, peaks {projected}")
    return counts, shapes, times


# Launches of the streaming collect under the defaults (FSDKRC_RLC,
# FSDKRC_MULTIEXP and FSDKRC_RANGEOPT on) at n=16, t=8, 2048-bit, M=256,
# 11 correct-key rounds (PERF.md section 2), worked out from the code and
# a CPU drive (scripts/stream_launch_drive.py: the wrappers counted on the
# CPU) before the first run on the card. STREAM_OFFER, each accepted
# offer: the message's Feldman MSM (one `ec_scalar_mul`, one
# `ec_tree_sum`), its ring-Pedersen fold (one proof: the T-ladder's
# one-row `cios_modexp`, the 257-term joint row split at 16 terms into
# two Straus launches) and its correct-key fold (the 11-term joint row,
# one Straus launch, then the sigma-aggregate's one-row `cios_modexp`).
# A duplicate, unexpected or late offer launches nothing.
STREAM_OFFER = {"cios_modexp": 2, "cios_multi_modexp": 3, "cios_shared_exp": 0,
                "cios_comb": 0, "cios_comb_ladder": 0, "cios_mont_mul": 0, "cios_modmul": 0,
                "ec_scalar_mul": 1, "ec_tree_sum": 1}
# STREAM_FINALIZE: finalize at quorum: the pair families' launch set, one
# collect's (their PDL u1 MSM among them), and the pk_vec MSM.
STREAM_FINALIZE = {"cios_modexp": 3, "cios_multi_modexp": 5, "cios_shared_exp": 1,
                   "cios_comb": 2, "cios_comb_ladder": 2, "cios_mont_mul": 8, "cios_modmul": 4,
                   "ec_scalar_mul": 2, "ec_tree_sum": 2}
# STREAM_FUSED: finalize_streams of 4 receivers' sessions of one round: their
# 1,024 pair rows dedup to one session's 256, so one pair launch set, and
# each session's pk_vec MSM.
STREAM_FUSED = {"cios_modexp": 3, "cios_multi_modexp": 5, "cios_shared_exp": 1,
                "cios_comb": 2, "cios_comb_ladder": 2, "cios_mont_mul": 8, "cios_modmul": 4,
                "ec_scalar_mul": 5, "ec_tree_sum": 5}


def stream_session(msgs_json, key, dk, config, order, extra=(), late=()):
    """One streamed collect through the port's JSON wire: `key`'s session
    (its committee's indices expected), each message decoded from
    `msgs_json` and offered in `order` (indices), with `extra` offered
    after the first (decoded messages: a duplicate, an unexpected sender),
    then finalize, then `late` offered. Returns (statuses, the finalize
    error or None, each accepted offer's (wall s, launches), the finalize's
    (wall s, launches), decode s), the finalize's wall taken from the last
    offer's return to its own return."""
    from fsdkr_tpu_torch.protocol import RefreshMessage, refresh_message_from_json

    st = RefreshMessage.collect_stream(key, dk, None, (), config)
    statuses, offers, decode = [], [], 0.0
    for pos, idx in enumerate(order):
        t0 = time.perf_counter()
        msg = refresh_message_from_json(msgs_json[idx])
        decode += time.perf_counter() - t0
        before = _launches()
        t0 = time.perf_counter()
        statuses.append(st.offer(msg))
        wall = time.perf_counter() - t0
        offers.append((wall, _sub(_launches(), before)))
        if pos == 0:
            for m in extra:
                before = _launches()
                statuses.append(st.offer(m))
                if any(_sub(_launches(), before).values()):
                    fail(f"stream: a {statuses[-1]} offer launched a kernel")
    before = _launches()
    t0 = time.perf_counter()
    try:
        st.finalize()
        err = None
    except Exception as e:  # noqa: BLE001 - compared by the caller
        err = e
    fin = (time.perf_counter() - t0, _sub(_launches(), before))
    for m in late:
        before = _launches()
        statuses.append(st.offer(m))
        if any(_sub(_launches(), before).values()):
            fail("stream: a late offer launched a kernel")
    return statuses, err, offers, fin, decode


def phase_stream(dev, inputs, own_keys, n=16, t=8, bits=2048, m_security=256, rounds=11,
                 reps=5, seed=20261018):
    """The streaming collect and the JSON wire under the defaults, on the
    rlc phase's messages, keys and dks before any collect, beside the keys
    its own collects adopted (`own_keys`). Every counter is zeroed just
    before the phase's gated calls and read just after them.

    (a) Receiver 1's streamed collect: every message through the port's
    JSON wire, offered in a seeded shuffle, the first message again
    (duplicate) and a copy from an unexpected sender after it, one message
    again after finalize (late): the statuses; `local_key_to_json` of the
    adopted key byte for byte the barrier collect's; each accepted offer's
    launches STREAM_OFFER, the finalize's STREAM_FINALIZE. `reps` such
    sessions (receivers 1, 2, ...): each offer's wall, the post-quorum
    latency (the last offer's return to finalize's return) beside `reps`
    barrier collects' in the same call, run back to back before the
    streams and one after each stream; all of it twice, first with a
    gc.collect() before each timed call, then with the collector left to
    run when the garbage calls for it. A tampered ring-Pedersen proof and
    a tampered PDL row raise what barrier collect raises, with the same
    blame. (b) finalize_streams over receivers 1-4's sessions against
    collect_sessions of the same 4: the keys, rlc.stats() of the offers
    and the finalize together equal to the fused call's, the finalize's
    launches STREAM_FUSED. On the card, the device busy time of one
    stream's offers and of its finalize (torch.profiler).
    Returns (the phase's launches by kernel, its launch shapes, times)."""
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.backend import rlc
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import (
        RefreshMessage,
        finalize_streams,
        local_key_to_json,
        refresh_message_from_json,
        refresh_message_to_json,
    )

    msgs, pre_keys, dks = inputs
    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    if not rlc.rlc_enabled():
        fail("stream: FSDKRC_RLC must be on, as by default")
    times = {}
    rng = random.Random(seed)
    wire = [refresh_message_to_json(m) for m in msgs]

    def spare(r):
        return copy.deepcopy(pre_keys[r]), copy.deepcopy(dks[r])

    def same_key(got, want, what):
        if local_key_to_json(got) != local_key_to_json(want):
            fail(f"stream: {what} adopted another key (local_key_to_json differs)")

    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()

    # ---- (a) one streamed collect, then `reps` for the timings ---------
    order = list(range(n))
    rng.shuffle(order)
    dup = refresh_message_from_json(wire[order[0]])
    stranger = refresh_message_from_json(wire[order[1]])
    stranger.party_index = n + 7
    late = [refresh_message_from_json(wire[order[-1]])]
    key, dk = spare(0)
    statuses, err, offers, fin, decode = stream_session(wire, key, dk, config, order,
                                                        (dup, stranger), late)
    want = ["accepted", "duplicate", "unexpected"] + ["accepted"] * (n - 1) + ["late"]
    if err is not None or statuses != want:
        fail(f"stream: (a) statuses {statuses}, error {err!r}")
    same_key(key, own_keys[0], "(a) the streamed collect")
    for _, got in offers:
        _gate_launches("an accepted offer", got, STREAM_OFFER, "stream")
    _gate_launches("the finalize", fin[1], STREAM_FINALIZE, "stream")
    log(f"stream: (a) receiver 1: statuses {statuses}; local_key_to_json byte for byte the "
        f"barrier collect's; each offer's launches {json.dumps(STREAM_OFFER)}, the finalize's "
        f"{json.dumps(fin[1])}; JSON decode {decode:.3f} s for {n + 1} messages")

    def barrier_collect(r, forced_gc):
        key, dk = spare(r)
        if forced_gc:
            gc.collect()
        t0 = time.perf_counter()
        RefreshMessage.collect(msgs, key, dk, config=config)
        return time.perf_counter() - t0

    def median(walls):
        return sorted(walls)[len(walls) // 2]

    # barrier collects alone first, then streams each followed by a
    # barrier collect: once with a gc.collect() before every timed call,
    # once with the collector left to run when the stream's garbage calls
    # for it, as on a receiver that serves streams
    for tag, forced_gc in (("", True), ("_gc_in", False)):
        block = [barrier_collect(rep % n, forced_gc) for rep in range(reps)]
        offer_walls, post_quorum, barrier = [], [], []
        for rep in range(reps):
            r = rep % n
            key, dk = spare(r)
            order = list(range(n))
            rng.shuffle(order)
            if forced_gc:
                gc.collect()
            _, err, offers, fin, _ = stream_session(wire, key, dk, config, order)
            if err is not None:
                fail(f"stream: timed session {rep} raised {err!r}")
            same_key(key, own_keys[r], f"timed session {rep}")
            offer_walls += [wall for wall, _ in offers]
            post_quorum.append(fin[0])
            barrier.append(barrier_collect(r, forced_gc))
        times["offer_median" + tag] = median(offer_walls)
        times["post_quorum_median" + tag] = median(post_quorum)
        times["barrier_collect_median" + tag] = median(barrier)
        times["barrier_block_median" + tag] = median(block)
        how = "a gc.collect() before each timed call" if forced_gc else \
            "the collector left to run as the garbage calls for it"
        log(f"stream: with {how}: each offer's wall: median "
            f"{times['offer_median' + tag] * 1e3:.1f} ms over {len(offer_walls)} offers "
            f"({min(offer_walls) * 1e3:.1f}..{max(offer_walls) * 1e3:.1f})")
        log(f"stream: with {how}: post-quorum latency (the last offer's return to finalize's "
            f"return): median {times['post_quorum_median' + tag]:.4f} s over {reps} sessions "
            f"({min(post_quorum):.4f}..{max(post_quorum):.4f}); in the same call, barrier "
            f"collect median {times['barrier_collect_median' + tag]:.4f} s over {reps}, each "
            f"after a stream ({min(barrier):.4f}..{max(barrier):.4f}), and "
            f"{times['barrier_block_median' + tag]:.4f} s over {reps} run back to back before "
            f"the streams ({min(block):.4f}..{max(block):.4f})")

    for field in ("ring_pedersen", "pdl"):
        bad, sender, _ = _tamper(msgs, field)
        barrier_err, _, _ = _tampered_collect(msgs, spare(1), config, field)
        bad_wire = [refresh_message_to_json(m) for m in bad]
        key, dk = spare(1)
        order = list(range(n))
        rng.shuffle(order)
        t0 = time.perf_counter()
        _, err, _, _, _ = stream_session(bad_wire, key, dk, config, order)
        wall = time.perf_counter() - t0
        if err is None or _verdict(err) != _verdict(barrier_err) or \
                type(err).__name__ != type(barrier_err).__name__:
            fail(f"stream: tampered {field}: the stream raised {_verdict(err)}, barrier "
                 f"collect {_verdict(barrier_err)}")
        if local_key_to_json(key) != local_key_to_json(pre_keys[1]):
            fail(f"stream: tampered {field}: the key was changed")
        log(f"stream: tampered {field} (sender {bad[sender].party_index}): the stream raises "
            f"{err!r} as barrier collect does ({wall:.3f} s)")

    # ---- (b) finalize_streams over 4 sessions --------------------------
    fused_n = 4
    ref = [(msgs,) + spare(r) + ((),) for r in range(fused_n)]
    rlc.stats_reset()
    t0 = time.perf_counter()
    errs = RefreshMessage.collect_sessions(ref, config)
    times["collect_sessions_4"] = time.perf_counter() - t0
    want_stats = rlc.stats()
    if errs != [None] * fused_n:
        fail(f"stream: (b) collect_sessions returned {errs}")
    rlc.stats_reset()
    streams, keys_b = [], []
    before = _launches()
    t0 = time.perf_counter()
    for r in range(fused_n):
        key, dk = spare(r)
        st = RefreshMessage.collect_stream(key, dk, None, (), config)
        order = list(range(n))
        rng.shuffle(order)
        for idx in order:
            if st.offer(refresh_message_from_json(wire[idx])) != "accepted":
                fail("stream: (b) an offer was not accepted")
        streams.append(st)
        keys_b.append(key)
    times["offers_4_sessions"] = time.perf_counter() - t0
    offers_b = _sub(_launches(), before)
    before = _launches()
    t0 = time.perf_counter()
    errs = finalize_streams(streams, config)
    times["finalize_streams_4"] = time.perf_counter() - t0
    fused = _sub(_launches(), before)
    stats = rlc.stats()
    if errs != [None] * fused_n:
        fail(f"stream: (b) finalize_streams returned {errs}")
    for r in range(fused_n):
        same_key(keys_b[r], ref[r][1], f"(b) session {r}")
        same_key(keys_b[r], own_keys[r], f"(b) session {r} (its own collect)")
    if stats != want_stats:
        fail(f"stream: (b) fold counters {stats}, collect_sessions' {want_stats}")
    _gate_launches("(b) the 4 sessions' offers", offers_b,
                   {k: v * fused_n * n for k, v in STREAM_OFFER.items()}, "stream")
    _gate_launches("(b) finalize_streams", fused, STREAM_FUSED, "stream")
    log(f"stream: (b) {fused_n} sessions: offers {times['offers_4_sessions']:.3f} s, "
        f"finalize_streams {times['finalize_streams_4']:.3f} s (collect_sessions of the same "
        f"{fused_n}: {times['collect_sessions_4']:.3f} s); each adopts collect_sessions' key; "
        f"fold counters == collect_sessions' {json.dumps(stats)}; finalize launches "
        f"{json.dumps(fused)}")

    counts = _launches()
    shapes = {
        "cios_mont_mul": dict(montgomery_kernels.mont_mul.shapes),
        "cios_modmul": dict(montgomery_kernels.modmul.shapes),
        "cios_modexp": dict(montgomery_kernels.modexp_segments.shapes),
        "cios_comb": dict(montgomery_kernels.comb.shapes),
        "cios_comb_ladder": dict(montgomery_kernels.comb_ladder.shapes),
        "cios_multi_modexp": dict(montgomery_kernels.multi_modexp.shapes),
        "cios_shared_exp": dict(montgomery_kernels.shared_exp_segments.shapes),
        "ec_scalar_mul": dict(ec_kernels.scalar_mul.shapes),
        "ec_tree_sum": dict(ec_kernels.tree_sum.shapes),
    }
    log(f"stream: the phase's launches: {json.dumps(counts)}")
    for name, by_shape in shapes.items():
        log(f"stream: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items(), key=str)))
    if any(counts[k] for k in ("rns_mont_mul", "rns_modexp")):
        fail(f"stream: the RNS kernels launched {counts}")

    if dev.type == "cuda":
        # device busy of one stream's offers and of its finalize
        key, dk = spare(2)
        st = RefreshMessage.collect_stream(key, dk, None, (), config)
        decoded = [refresh_message_from_json(w) for w in wire]
        offers_busy = device_busy(lambda: [st.offer(m) for m in decoded])
        fin_busy = device_busy(st.finalize)
        same_key(key, own_keys[2], "the profiled stream")
        collect_busy = device_busy(lambda: RefreshMessage.collect(msgs, *spare(2),
                                                                  config=config))
        for label, (wall_ms, busy_ms, by_name) in (("offers", offers_busy),
                                                   ("finalize", fin_busy),
                                                   ("collect", collect_busy)):
            times[f"{label}_busy_ms"] = busy_ms
            times[f"{label}_profiled_wall_ms"] = wall_ms
            top = ", ".join(f"{name} {sum(v for key, v in by_name.items() if sym in key):.2f}"
                            for name, sym in _SYMBOL.items()
                            if any(sym in key for key in by_name))
            log(f"stream: profile {label}: wall {wall_ms:.1f} ms under the profiler, device "
                f"busy {busy_ms:.1f} ms ({100 * busy_ms / max(wall_ms, 1e-9):.1f}%); by kernel "
                f"(ms): {top}")
        log(f"stream: device busy: {n} offers {offers_busy[1]:.1f} ms, finalize "
            f"{fin_busy[1]:.1f} ms, one barrier collect {collect_busy[1]:.1f} ms")
    return counts, shapes, times


def pair_staging(dev, fn):
    """The most device memory that CudaBatchVerifier.verify_pairs
    allocates above what was live at its call (torch.cuda.max_memory_allocated
    over its outermost calls) while fn runs."""
    import torch

    from fsdkr_tpu_torch.backend.cuda_verifier import CudaBatchVerifier

    raw = CudaBatchVerifier.verify_pairs
    depth, peak = [0], [0]

    def measured(self, *args, **kwargs):
        depth[0] += 1
        if depth[0] == 1:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            return raw(self, *args, **kwargs)
        finally:
            if depth[0] == 1:
                torch.cuda.synchronize(dev)
                peak[0] = max(peak[0], torch.cuda.max_memory_allocated(dev) - base)
            depth[0] -= 1

    CudaBatchVerifier.verify_pairs = measured
    try:
        fn()
    finally:
        CudaBatchVerifier.verify_pairs = raw
    return peak[0]


def _shapes_now():
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels

    return {
        "cios_mont_mul": dict(montgomery_kernels.mont_mul.shapes),
        "cios_modmul": dict(montgomery_kernels.modmul.shapes),
        "cios_modexp": dict(montgomery_kernels.modexp_segments.shapes),
        "cios_comb": dict(montgomery_kernels.comb.shapes),
        "cios_comb_ladder": dict(montgomery_kernels.comb_ladder.shapes),
        "cios_multi_modexp": dict(montgomery_kernels.multi_modexp.shapes),
        "cios_shared_exp": dict(montgomery_kernels.shared_exp_segments.shapes),
        "ec_scalar_mul": dict(ec_kernels.scalar_mul.shapes),
        "ec_tree_sum": dict(ec_kernels.tree_sum.shapes),
    }


def phase_prover(dev, n=16, t=8, bits=2048, m_security=256, rounds=11):
    """The prover path under the defaults, on a committee of its own: (a)
    the inline distribute (no committee prefilled) timed by
    span_distribute: the native core loaded and ran the prime batches,
    S = T^lambda on the CRT legs, no pool touched, the launches
    JOINT_DISTRIBUTE; (b) `precompute.prefill` for the committee, then a
    distribute: its online wall and the takes by kind, no pool dry; (c)
    the pooled messages collected by every party: the group key
    unchanged, a tampered pooled PDL proof blamed on its sender. Returns
    (the launches of (a), the launch shapes of (a)-(c), the phase's
    times, the committee's keys before (a))."""
    from fsdkr_tpu_torch import ProtocolConfig, native, precompute
    from fsdkr_tpu_torch.backend import crt
    from fsdkr_tpu_torch.core import primes, vss
    from fsdkr_tpu_torch.native import gmp
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
    from fsdkr_tpu_torch.errors import PDLwSlackProofError
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage, simulate_keygen

    config = ProtocolConfig(
        paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
        backend="cuda", device=dev.type,
    )
    precompute.clear_pools()
    precompute.clear_targets()
    times = {}

    def primes_on_gmp(label):
        """Every sieved candidate a GMP gcd, every Miller-Rabin round a
        GMP powm, since the last resets."""
        st, gen = gmp.stats(), primes.gen_stats()
        if not gen["candidates"] or st["gcd_calls"] < gen["candidates"] or \
                st["powm_rows"] < gen["mr_rounds"]:
            fail(f"prover: {label}'s primes did not go through GMP: {st}, drawn {gen}")
        return st, gen

    gmp.stats_reset()
    primes.gen_stats_reset()
    t0 = time.perf_counter()
    pre = simulate_keygen(t, n, config)
    times["keygen"] = time.perf_counter() - t0
    st, gen = primes_on_gmp("simulate_keygen")
    log(f"prover: simulate_keygen t={t} n={n}: {times['keygen']:.3f} s; GMP {st}, prime "
        f"search {gen}; native core {native.LIB.so_path().name}, engine "
        f"{native.engine_kind()}, {native.thread_count()} threads")
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()

    # (a) the inline distribute
    gmp.stats_reset()
    primes.gen_stats_reset()
    crt.stats_reset()
    precompute.stats_reset()
    before = _launches()
    keys = copy.deepcopy(pre)
    _, wall, phases, _ = span_distribute([(k.i, k) for k in keys], n, config, "inline")
    counts = _sub(_launches(), before)
    gst, gen = primes_on_gmp("the inline distribute")
    cst, pst = crt.crt_stats(), precompute.precompute_stats()
    times["inline"] = wall
    times["inline_phases"] = phases
    log(f"prover: inline distribute {wall:.3f} s; launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; GMP {gst}; prime search "
        f"{gen}; CRT {cst}")
    # S = T^lambda, one fault-checked row a sender, its two legs on
    # mpz_powm_sec; the provers' columns run on the card
    if cst["rows"] != n or cst["fault_checks"] != 2 * n or gst["powm_sec_rows"] != 2 * n:
        fail(f"prover: S = T^lambda took {cst['rows']} CRT rows and {gst['powm_sec_rows']} "
             f"mpz_powm_sec rows, expected {n} and {2 * n}: {cst} {gst}")
    if pst["consumed"] or pst["dry_fallbacks"]:
        fail(f"prover: a distribute of a committee never prefilled touched a pool: {pst}")
    _gate_launches("the inline distribute", counts, JOINT_DISTRIBUTE, "prover")

    # (b) prefill, then the pooled (online) distribute
    keys = copy.deepcopy(pre)
    precompute.stats_reset()
    t0 = time.perf_counter()
    produced = precompute.prefill(keys[0], n, n, config)
    times["prefill"] = time.perf_counter() - t0
    log(f"prover: prefill {produced} entries in {times['prefill']:.3f} s "
        f"({json.dumps(precompute.precompute_stats())})")
    if produced != 3 * n * n + n:
        fail(f"prover: prefill produced {produced} entries, expected {3 * n * n + n}")
    precompute.stats_reset()
    before = _launches()
    out, wall, phases, _ = span_distribute([(k.i, k) for k in keys], n, config, "pooled")
    pooled_launches = _sub(_launches(), before)
    times["pooled"] = wall
    times["pooled_phases"] = phases
    st = precompute.precompute_stats(by_kind=True)
    takes = {kind: ev.get("consumed", 0) for kind, ev in st["kinds"].items()}
    log(f"prover: pooled distribute (online) {wall:.3f} s; takes by kind {json.dumps(takes)}; "
        f"dry {st['dry_fallbacks']}; launches "
        f"{json.dumps({k: v for k, v in pooled_launches.items() if v})}")
    if st["dry_fallbacks"] or takes != {"enc": n * n, "pdl": n * n, "alice": n * n, "keys": n}:
        fail(f"prover: a pool ran dry in the pooled distribute: {st}")

    # (c) the pooled messages collected by every party; a tampered pooled
    # PDL proof blamed on its sender
    msgs = [m for m, _ in out]
    spare = (copy.deepcopy(keys[0]), copy.deepcopy(out[0][1]))
    t0 = time.perf_counter()
    for key, (_, dk) in zip(keys, out):
        RefreshMessage.collect(msgs, key, dk, config=config)
    times["pooled_collects"] = time.perf_counter() - t0
    idx = list(range(t + 1))
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(t, n)).reconstruct(
        idx, [keys[i].keys_linear.x_i for i in idx])
    if GENERATOR * secret != keys[0].y_sum_s or any(k.pk_vec != keys[0].pk_vec for k in keys):
        fail("prover: the pooled round's new shares do not reconstruct the group key")
    err, party, _row = _tampered_collect(msgs, spare, config, "pdl")
    if not isinstance(err, PDLwSlackProofError) or err.party_index != party:
        fail(f"prover: a tampered pooled PDL proof raised {err!r}, expected the PDL error "
             f"naming party {party}")
    log(f"prover: {n} collects of the pooled messages {times['pooled_collects']:.3f} s; the "
        f"group key is unchanged; a tampered pooled PDL proof raised {err!r}")
    precompute.clear_pools()
    precompute.clear_targets()
    return counts, _shapes_now(), times, pre


# The serve phase's session: a pooled distribute (SERVE_DISTRIBUTE, from
# scripts/serve_launch_drive.py at 2048 bits), n^2 offers (each message
# into each receiver's stream: STREAM_OFFER apiece) and one finalize of
# the n streams, whose pair rows dedup to one round's: one pair launch
# set (STREAM_FINALIZE's, the PDL u1 MSM among it) and one pk_vec MSM a
# stream, as STREAM_FUSED is for 4.
# SERVE_DISTRIBUTE: every stage-1 power pooled, the distribute launches the
# shared witness column h1^x (16 groups of 16 rows: below the comb's 256,
# so generic rows) and stage 2's response columns, two `cios_modexp`
# launches, and its three generator fan-outs on the card.
SERVE_DISTRIBUTE = {"cios_modexp": 2, "cios_multi_modexp": 0, "cios_shared_exp": 0,
                    "cios_comb": 0, "cios_comb_ladder": 0, "cios_mont_mul": 0, "cios_modmul": 0,
                    "ec_scalar_mul": 3, "ec_tree_sum": 0}


def serve_tables(n):
    """(distribute, offers, finalize) launch tables of one serve session."""
    offers = {k: n * n * v for k, v in STREAM_OFFER.items()}
    finalize = dict(STREAM_FINALIZE)
    finalize["ec_scalar_mul"] += n - 1
    finalize["ec_tree_sum"] += n - 1
    return SERVE_DISTRIBUTE, offers, finalize


SERVE_TAMPER = "seed=7,msg_tamper=1.0,msg_tamper_max=1"


@contextlib.contextmanager
def stage_launches(stages, results):
    """Inside the block, the launches of each call of the service's three
    stages (`RefreshMessage.distribute_batch`, `StreamingCollect.offer`,
    `finalize_streams`) add into stages[name], and finalize's returned
    verdicts into `results`. Exact while one session runs: the producer's
    launches count apart."""
    from fsdkr_tpu_torch.protocol import RefreshMessage, StreamingCollect
    from fsdkr_tpu_torch.serving import service

    def counted(name, fn):
        def call(*args, **kwargs):
            before = _launches()
            out = fn(*args, **kwargs)
            got = _sub(_launches(), before)
            stages[name] = {k: stages.get(name, {}).get(k, 0) + v for k, v in got.items()}
            if name == "finalize":
                results.extend(out)
            return out
        return call

    dist, offer, fin = RefreshMessage.distribute_batch, StreamingCollect.offer, \
        service.finalize_streams
    RefreshMessage.distribute_batch = staticmethod(counted("distribute", dist))
    StreamingCollect.offer = counted("offers", offer)
    service.finalize_streams = counted("finalize", fin)
    try:
        yield
    finally:
        RefreshMessage.distribute_batch = staticmethod(dist)
        StreamingCollect.offer = offer
        service.finalize_streams = fin


def _apart_shapes():
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, tally

    fns = {"cios_mont_mul": montgomery_kernels.mont_mul, "cios_modmul": montgomery_kernels.modmul,
           "cios_modexp": montgomery_kernels.modexp_segments, "cios_comb": montgomery_kernels.comb,
           "cios_comb_ladder": montgomery_kernels.comb_ladder,
           "cios_multi_modexp": montgomery_kernels.multi_modexp,
           "cios_shared_exp": montgomery_kernels.shared_exp_segments,
           "ec_scalar_mul": ec_kernels.scalar_mul, "ec_tree_sum": ec_kernels.tree_sum}
    return {name: tally.shapes(fn, "producer") for name, fn in fns.items()}


def _apart_launches():
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels

    return {**montgomery_kernels.launch_counts("producer"), **ec_kernels.launch_counts("producer"),
            **rns_kernels.launch_counts("producer")}


def _reconstructs(keys, t):
    from fsdkr_tpu_torch.core import vss
    from fsdkr_tpu_torch.core.secp256k1 import GENERATOR

    idx = list(range(t + 1))
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(t, len(keys))).reconstruct(
        idx, [keys[i].keys_linear.x_i for i in idx])
    return GENERATOR * secret == keys[0].y_sum_s and all(k.pk_vec == keys[0].pk_vec
                                                        for k in keys)


def session_stages(spans):
    """A served session's wall by stage from its spans, in seconds:
    distribute, the offers (summed over their spans), the finalize with
    the share recovery and adoption inside it, and the producer thread's
    precompute spans (its steps, and the kinds they produced)."""
    out = {}
    for sp in spans:
        if sp.thread_name == "fsdkr-precompute":
            if sp.name.startswith("precompute."):
                key = "producer thread: " + sp.name
                out[key] = out.get(key, 0.0) + sp.duration
        elif sp.name in ("distribute", "collect.stream.offer", "collect.stream.finalize",
                         "collect.share_recovery", "collect.adopt"):
            out[sp.name] = out.get(sp.name, 0.0) + sp.duration
    return {k: round(v, 6) for k, v in sorted(out.items())}


def phase_serve(dev, committees=(), n=16, t=8, bits=2048, m_security=256, rounds=11):
    """The serving layer's in-process core on the card (the module
    docstring's `serve`). `committees`: up to two lists of n LocalKeys
    made earlier in the run; the phase makes the rest. Returns (the
    session's launches, the phase's launch shapes, the producer's
    shapes apart, the phase's times)."""
    import shutil
    import tempfile

    from fsdkr_tpu_torch import ProtocolConfig, precompute
    from fsdkr_tpu_torch.errors import PDLwSlackProofError
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import simulate_keygen
    from fsdkr_tpu_torch.serving import SLO, RefreshService, faults, recover
    from fsdkr_tpu_torch.telemetry import registry
    from fsdkr_tpu_torch.telemetry.spans import get_tracer

    config = ProtocolConfig(paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
                            backend="cuda", device=dev.type)
    times = {}
    committees = [copy.deepcopy(c) for c in committees][:2]
    t0 = time.perf_counter()
    while len(committees) < 2:
        committees.append(simulate_keygen(t, n, config))
    times["keygen"] = time.perf_counter() - t0
    cids = ("A", "B")
    group_keys = {cid: keys[0].y_sum_s for cid, keys in zip(cids, committees)}
    precompute.clear_pools()
    precompute.clear_targets()
    precompute.stats_reset()
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    jdir = tempfile.mkdtemp(prefix="fsdkr_serve_journal_")
    errors_gauge = registry.get_registry().get("fsdkr_producer_errors")
    errors_before = errors_gauge.snapshot_values()[0]["value"]
    try:
        svc = RefreshService(workers=2, journal=jdir, deadline_s=300, device=dev.type)
        for cid, keys in zip(cids, committees):
            svc.admit(cid, keys, config, SLO())
        t0 = time.perf_counter()
        svc.start()
        while precompute.deficit_total():
            if time.perf_counter() - t0 > 120:
                fail(f"serve: the producer left {precompute.deficit_total()} entries after 120 s")
            time.sleep(0.01)
        times["fill"] = time.perf_counter() - t0
        fill_apart = _apart_launches()
        if any(_launches().values()) or not any(fill_apart.values()):
            fail(f"serve: the fill's launches {_launches()} entered the counters, or the "
                 f"producer launched nothing apart ({fill_apart})")
        st = precompute.precompute_stats()
        log(f"serve: start() and the producer's fill of both committees' targets "
            f"{times['fill']:.3f} s: {st['entries']} entries in {st['pools']} pools; its "
            f"launches, counted apart: {json.dumps({k: v for k, v in fill_apart.items() if v})}")

        # (d) one session alone: its launches by stage, its device busy,
        # its wall by stage from the span tracer
        stages, verdicts, sessions = {}, [], {}
        before, before_apart = _launches(), _apart_launches()
        def alone():
            sessions[("A", 1)] = svc.wait(svc.submit("A", epoch=1), 300)

        tracer = get_tracer()
        tracer.reset()
        with stage_launches(stages, verdicts):
            tracer.enable()
            t0 = time.perf_counter()
            try:
                if dev.type == "cuda":
                    wall_ms, busy_ms, by_name = device_busy(alone)
                else:  # a CPU drive of the phase: no device to profile
                    alone()
                    wall_ms, busy_ms, by_name = (time.perf_counter() - t0) * 1e3, 0.0, {}
            finally:
                tracer.disable()
            times["session_alone"] = time.perf_counter() - t0
        times["stage_s"] = session_stages(tracer.spans())
        tracer.reset()
        session = _sub(_launches(), before)
        beside = {k: v for k, v in _sub(_apart_launches(), before_apart).items() if v}
        if verdicts != [None] * n:
            fail(f"serve: the session alone did not verify: {verdicts}")
        want = serve_tables(n)
        for label, got, table in zip(("distribute", "offers", "finalize"),
                                     (stages.get(k, {}) for k in ("distribute", "offers",
                                                                  "finalize")), want):
            _gate_launches(f"the session's {label}", got, table, "serve")
        total = {k: sum(tab[k] for tab in want) for k in want[0]}
        _gate_launches("one session", session, total, "serve")
        times["session_busy_ms"] = busy_ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"serve: one session alone {times['session_alone']:.3f} s, {wall_ms:.1f} ms under "
            f"the profiler, device busy {busy_ms:.1f} ms (the producer's refill of the key "
            f"bundles it took ran beside it, its launches apart {json.dumps(beside)}); "
            f"launches by stage {json.dumps(stages)}; top device time "
            f"{json.dumps({k[:40]: round(v, 3) for k, v in top})}")
        log(f"serve: the session's finalize {times['stage_s'].get('collect.stream.finalize')} s, "
            f"its {n} share recoveries {times['stage_s'].get('collect.share_recovery')} s "
            f"(their Paillier rows on GMP)")
        n_apart = sum(beside.values())
        log(f"serve: the session's wall by stage from the spans (seconds; offers summed over "
            f"their {n * n} spans, the producer's over its thread's spans): "
            f"{json.dumps(times['stage_s'])}; the producer's share of the launches in the "
            f"session's window {n_apart} of {n_apart + sum(session.values())}")

        # (a) the pools and the committees after it (the extra sessions
        # side by side that measured throughput here were cut to keep the
        # whole run well inside its time limit with the ingress and fleet
        # phases, which measure sessions/s over the socket and across a kill)
        bad = {k: (s.state, s.error) for k, s in sessions.items() if s.state != "done"}
        if bad:
            fail(f"serve: sessions not done: {bad}")
        for cid, keys in zip(cids, committees):
            if svc._committees[cid].epochs != {"A": 1, "B": 0}[cid]:
                fail(f"serve: committee {cid} advanced {svc._committees[cid].epochs} epochs")
            if keys[0].y_sum_s != group_keys[cid] or not _reconstructs(keys, t):
                fail(f"serve: committee {cid}'s new shares do not reconstruct its group key")
        st = precompute.precompute_stats(by_kind=True)
        stats = svc.stats()  # raises a producer step's exception
        if not st["consumed"] or errors_gauge.snapshot_values()[0]["value"] != errors_before:
            fail(f"serve: no pool taken ({st}), or the producer raised")
        log(f"serve: the session done, A one epoch on, group keys unchanged, t+1 new shares "
            f"reconstruct them; pools {json.dumps({k: v for k, v in st.items() if k != 'kinds'})}"
            f"; service {json.dumps(stats)}")

        # (b) a tampered broadcast: aborted, blamed on its sender
        stages, verdicts = {}, []
        with stage_launches(stages, verdicts):
            plan = faults.configure(SERVE_TAMPER)
            t0 = time.perf_counter()
            try:
                bad = svc.wait(svc.submit("A", epoch=2), 300)
            finally:
                faults.reset()
            times["tampered"] = time.perf_counter() - t0
        tampered = [int(f.split(":")[1]) for f in bad.faults if f.startswith("msg_tamper:")]
        errs = [e for e in verdicts if e is not None]
        if (bad.state, bad.blame) != ("aborted", True) or len(tampered) != 1 or not errs or any(
                not isinstance(e, PDLwSlackProofError) or e.party_index != tampered[0]
                for e in errs):
            fail(f"serve: the tampered epoch ended {bad.state} (blame {bad.blame}, faults "
                 f"{bad.faults}): {errs[:2]}")
        log(f"serve: an epoch under {plan.spec()!r}: {times['tampered']:.3f} s, aborted, "
            f"{len(errs)} of {n} receivers blamed sender {tampered[0]} ({bad.error})")
        sessions[("A", 2)] = bad
        svc.stop()

        # (c) a fresh service recovers every session from the journal
        svc2 = RefreshService(workers=2, journal=jdir, keystore=svc.keystore, device=dev.type)
        t0 = time.perf_counter()
        rep = recover(svc2, jdir)
        times["recover"] = time.perf_counter() - t0
        svc2.stop()
        want_states = {s.session_id: s.state for s in sessions.values()}
        got_states = {sid: (e["disposition"], e.get("state"))
                      for sid, e in rep["sessions"].items()}
        if got_states != {sid: ("replayed_terminal", st) for sid, st in want_states.items()}:
            fail(f"serve: recover() gave {got_states}, expected every session's terminal "
                 f"{want_states}")
        log(f"serve: recover() on a fresh service {times['recover']:.3f} s: "
            f"{rep['replayed_terminal']} sessions replayed as terminals with their verdicts")
    finally:
        faults.reset()
        precompute.clear_pools()
        precompute.clear_targets()
        shutil.rmtree(jdir, ignore_errors=True)
    shapes = _shapes_now()
    apart = _apart_shapes()
    log(f"serve: {smi_line()}")
    return session, shapes, apart, times


def _wire_sizes(wires, max_frame, conn_budget):
    """The broadcast set's wire sizes against the ingress's limits: each
    message's JSON bytes, its broadcast frame's, and the set's total."""
    from fsdkr_tpu_torch.serving.ingress import encode_frame

    sizes = [len(w.encode()) for _s, w in wires]
    frames = [len(encode_frame({"op": "broadcast", "rid": 1 << 20, "sid": 1 << 20, "wire": w}))
              for _s, w in wires]
    return {"messages": len(sizes), "wire_min": min(sizes), "wire_max": max(sizes),
            "set_total": sum(sizes), "frame_max": max(frames),
            "inlined_limit": max_frame // 2, "max_frame": max_frame,
            "conn_budget": conn_budget, "frame_fits_conn_budget": max(frames) <= conn_budget}


def _ingress_metrics():
    from fsdkr_tpu_torch.telemetry import export

    return {name: [(rec["labels"], rec["value"]) for rec in m["values"]]
            for name, m in export.snapshot()["metrics"].items()
            if name.startswith("fsdkr_ingress_")}


def _hostile_conn(port, blob):
    """A raw connection that sends `blob`: the server must close it (EOF
    or reset) within 10 s."""
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(blob)
        end = time.monotonic() + 10
        while time.monotonic() < end:
            try:
                if not s.recv(1 << 16):
                    return True
            except OSError:
                return True
        return False
    finally:
        s.close()


def _socket_epoch(cli, sid_resp, tamper=None):
    """Re-deliver a submitted session's broadcast set over `cli` (the
    client is the broadcast channel), per sender when the set was not
    inlined; `tamper`: a sender whose PDL proof is flipped in its wire,
    the tampered copy first and the honest one as its duplicate. Returns
    (the wires, each delivery's ack)."""
    from fsdkr_tpu_torch.protocol.serialization import (refresh_message_from_json,
                                                        refresh_message_to_json)
    from fsdkr_tpu_torch.serving import faults

    sid = sid_resp["sid"]
    wires = sid_resp.get("broadcasts")
    if wires is None:
        wires = []
        for snd in sid_resp["senders"]:
            got = cli.fetch(sid, [snd], timeout=600)
            if got["type"] != "fetched" or len(got["broadcasts"]) != 1:
                fail(f"ingress: fetch of sender {snd} answered {str(got)[:200]}")
            wires.extend(got["broadcasts"])
    acks = []
    for snd, wire in wires:
        if snd == tamper:
            bad = refresh_message_to_json(faults.tamper_message(refresh_message_from_json(wire)))
            acks.append((snd, cli.broadcast(sid, bad, timeout=600).get("result")))
        acks.append((snd, cli.broadcast(sid, wire, timeout=600).get("result")))
    return [tuple(w) for w in wires], acks


def phase_ingress(dev, committees=(), n=16, t=8, bits=2048, m_security=256, rounds=11):
    """The TCP ingress at full width (the module docstring's `ingress`).
    Returns (the honest session's launches, the phase's launch shapes,
    the phase's times)."""
    import shutil
    import struct
    import tempfile

    from fsdkr_tpu_torch import ProtocolConfig, precompute
    from fsdkr_tpu_torch.errors import PDLwSlackProofError
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, rns_kernels
    from fsdkr_tpu_torch.protocol import simulate_keygen
    from fsdkr_tpu_torch.serving import SLO, IngressClient, IngressServer, RefreshService, metrics
    from fsdkr_tpu_torch.serving.ingress import encode_frame

    config = ProtocolConfig(paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
                            backend="cuda", device=dev.type)
    times = {}
    t0 = time.perf_counter()
    keys = copy.deepcopy(committees[0]) if committees else simulate_keygen(t, n, config)
    times["keygen"] = time.perf_counter() - t0
    group_key = keys[0].y_sum_s
    precompute.clear_pools()
    precompute.clear_targets()
    for mod in (rns_kernels, montgomery_kernels, ec_kernels):
        mod.reset_launch_counts()
    jdir = tempfile.mkdtemp(prefix="fsdkr_ingress_journal_")
    svc = srv = cli = None
    try:
        svc = RefreshService(workers=2, journal=jdir, deadline_s=300, device=dev.type)
        svc.admit("I", keys, config, SLO())
        t0 = time.perf_counter()
        svc.start()
        while precompute.deficit_total():
            if time.perf_counter() - t0 > 120:
                fail(f"ingress: the producer left {precompute.deficit_total()} entries after 120 s")
            time.sleep(0.01)
        times["fill"] = time.perf_counter() - t0
        srv = IngressServer(svc).start()
        cli = IngressClient("127.0.0.1", srv.port, timeout=600)
        snap0 = metrics.ingress_snapshot()

        # the honest epoch, a hostile connection beside it
        stages, verdicts, out = {}, [], {}
        before, before_apart = _launches(), _apart_launches()

        def honest():
            t1 = time.perf_counter()
            r = cli.submit("I", epoch=1, timeout=600)
            if r.get("type") != "submitted" or r.get("state") != "collecting":
                fail(f"ingress: submit answered {str(r)[:300]}")
            out["submitted_s"] = time.perf_counter() - t1
            out["inlined"] = "broadcasts" in r
            out["hostile"] = [
                _hostile_conn(srv.port, b"".join((encode_frame({"op": "ping", "rid": 1})[:-1],
                                                   b"\xff"))),
                _hostile_conn(srv.port, struct.pack("<II", srv.max_frame + 1, 0)),
            ]
            out["wires"], out["acks"] = _socket_epoch(cli, r)
            out["term"] = cli.wait(r["sid"], 600)
            out["wall_s"] = time.perf_counter() - t1

        with stage_launches(stages, verdicts):
            if dev.type == "cuda":
                wall_ms, busy_ms, by_name = device_busy(honest)
            else:  # a CPU drive of the phase: no device to profile
                honest()
                wall_ms, busy_ms, by_name = out["wall_s"] * 1e3, 0.0, {}
        session = _sub(_launches(), before)
        beside = {k: v for k, v in _sub(_apart_launches(), before_apart).items() if v}
        term = out["term"]
        if (term.get("type"), term.get("state"), term.get("blame")) != ("terminal", "done", False):
            fail(f"ingress: the honest epoch ended {str(term)[:300]}")
        if verdicts != [None] * n or [a for _s, a in out["acks"]] != ["accepted"] * n:
            fail(f"ingress: the honest epoch's offers {out['acks']} or verdicts {verdicts}")
        if out["hostile"] != [True, True]:
            fail(f"ingress: a hostile connection stayed open: {out['hostile']}")
        if keys[0].y_sum_s != group_key or not _reconstructs(keys, t):
            fail("ingress: the new shares do not reconstruct the group key")
        snap1 = metrics.ingress_snapshot()
        rejected = {k: v - snap0["frames_rejected"].get(k, 0)
                    for k, v in snap1["frames_rejected"].items()}
        if rejected.get("crc") != 1 or rejected.get("oversize") != 1:
            fail(f"ingress: the hostile frames were rejected as {rejected}")
        if cli.ping().get("type") != "pong":
            fail("ingress: the client's connection did not outlive the hostile ones")
        want = serve_tables(n)
        for label, table in zip(("distribute", "offers", "finalize"), want):
            _gate_launches(f"the session's {label}", stages.get(label, {}), table, "ingress")
        _gate_launches("one session", session,
                       {k: sum(tab[k] for tab in want) for k in want[0]}, "ingress")
        sizes = _wire_sizes(out["wires"], srv.max_frame, srv.conn_inflight_budget)
        if sizes["frame_max"] > srv.max_frame or out["inlined"] != (
                sizes["set_total"] <= srv.max_frame // 2):
            fail(f"ingress: the broadcast set's frames {sizes} against inlined {out['inlined']}")
        times.update(session_s=out["wall_s"], submit_s=out["submitted_s"],
                     service_latency_s=term["latency_s"], session_busy_ms=busy_ms,
                     session_profiled_ms=wall_ms)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"ingress: wire sizes at n={n}, {bits} bits: {json.dumps(sizes)}; the set was "
            f"{'inlined in submitted' if out['inlined'] else 'fetched per sender'}")
        log(f"ingress: the honest epoch over the socket, submit to terminal "
            f"{out['wall_s']:.3f} s (submitted after {out['submitted_s']:.3f} s; the "
            f"service's latency {term['latency_s']} s), {wall_ms:.1f} ms under the profiler, "
            f"device busy {busy_ms:.1f} ms; done, no blame, {n} offers accepted, t+1 new "
            f"shares reconstruct the group key; a bad CRC and an oversize prefix closed their "
            f"own connections ({json.dumps(rejected)}); launches by stage {json.dumps(stages)} "
            f"(the producer's beside them, apart: {json.dumps(beside)}); top device time "
            f"{json.dumps({k[:40]: round(v, 3) for k, v in top})}")

        # the tampered epoch: one broadcast's PDL proof flipped on the wire
        stages, verdicts = {}, []
        with stage_launches(stages, verdicts):
            t1 = time.perf_counter()
            r = cli.submit("I", epoch=2, timeout=600)
            if r.get("type") != "submitted":
                fail(f"ingress: the second submit answered {str(r)[:300]}")
            victim = sorted(r["senders"])[n // 3]
            _wires, acks = _socket_epoch(cli, r, tamper=victim)
            term = cli.wait(r["sid"], 600)
            times["tampered_s"] = time.perf_counter() - t1
        errs = [e for e in verdicts if e is not None]
        dup = [a for s, a in acks if s == victim]
        if (term.get("state"), term.get("blame")) != ("aborted", True) or dup != [
                "accepted", "duplicate"] or not errs or any(
                not isinstance(e, PDLwSlackProofError) or e.party_index != victim for e in errs):
            fail(f"ingress: the tampered epoch ended {str(term)[:300]}, acks {dup}: {errs[:2]}")
        if not str(term.get("error", "")).startswith("PDLwSlackProofError"):
            fail(f"ingress: the tampered epoch's error {term.get('error')!r}")
        log(f"ingress: sender {victim}'s PDL proof flipped on the wire (tampered copy accepted, "
            f"the honest copy a duplicate): {times['tampered_s']:.3f} s, aborted, {len(errs)} "
            f"of {n} receivers blamed sender {victim} ({term['error'][:80]})")
        snap2 = metrics.ingress_snapshot()
        traffic = {key: {k: v - snap0[key].get(k, 0) for k, v in snap2[key].items()}
                   for key in ("frames", "bytes", "connections", "frames_rejected")}
        times["traffic"] = traffic
        log(f"ingress: frames and bytes over both epochs {json.dumps(traffic)}; "
            f"export.snapshot()'s fsdkr_ingress_*: {json.dumps(_ingress_metrics())}")
    finally:
        if cli is not None:
            cli.close()
        if srv is not None:
            srv.stop()
        if svc is not None:
            svc.stop()
        precompute.clear_pools()
        precompute.clear_targets()
        shutil.rmtree(jdir, ignore_errors=True)
    shapes = _shapes_now()
    log(f"ingress: {smi_line()}")
    return session, shapes, times


FLEET_VICTIM_EPOCHS = (1,)  # queued on the victim's committee after epoch 0


def _one_per_shard(n_shards):
    from fsdkr_tpu_torch.serving.supervisor import shard_for

    cids, want, i = [], set(range(n_shards)), 0
    while want:
        cid = f"F{i}"
        if shard_for(cid, n_shards) in want:
            want.discard(shard_for(cid, n_shards))
            cids.append(cid)
        i += 1
    return cids


def phase_fleet(dev, committees=(), n=16, t=8, bits=2048, m_security=256, rounds=11,
                backend="cuda"):
    """Two shard processes of the supervisor on the card (the module
    docstring's `fleet`). Returns the phase's times."""
    import shutil
    import signal
    import tempfile

    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.protocol import simulate_keygen
    from fsdkr_tpu_torch.serving import faults, recovery
    from fsdkr_tpu_torch.serving.supervisor import ShardSupervisor

    config = ProtocolConfig(paillier_bits=bits, m_security=m_security, correct_key_rounds=rounds,
                            backend=backend, device=dev.type)
    times = {}
    t0 = time.perf_counter()
    committees = list(committees)[:2]
    while len(committees) < 2:
        committees.append(simulate_keygen(t, n, config))
    times["keygen"] = time.perf_counter() - t0
    if dev.type == "cuda":  # the shards load what the parent built
        from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels

        montgomery_kernels.load_library()
        ec_kernels.load_library()
    root = tempfile.mkdtemp(prefix="fsdkr_fleet_")
    sup = ShardSupervisor(shards=2, root=root, deadline_s=300.0, hb_interval=0.5,
                          device=dev.type, spawn_timeout=300.0)
    try:
        t0 = time.perf_counter()
        sup.start()
        times["start_s"] = time.perf_counter() - t0
        want_device = "cpu" if dev.type == "cpu" else __import__("torch").cuda.get_device_name(0)
        devices = [h.device for h in sup.shards]
        if devices != [want_device] * 2:
            fail(f"fleet: the shards report devices {devices}, expected {want_device} twice")
        times["startup"] = {h.idx: h.startup for h in sup.shards}
        log(f"fleet: both shards ready on {devices} in {times['start_s']:.3f} s; start-up by "
            f"shard (spawn to ready, import, CUDA init, kernel load, service) "
            f"{json.dumps(times['startup'])}")
        cids = _one_per_shard(2)
        for cid, keys in zip(cids, committees):
            sup.admit(cid, keys, config)
        victim_cid = cids[0]
        victim = sup.assignment[victim_cid]

        # epoch 0 on both: the baseline, and the terminals the replay restores
        t0 = time.perf_counter()
        for cid in cids:
            sup.submit(cid, 0)
        if not sup.drain(600):
            fail(f"fleet: epoch 0 did not drain: {sup.pending}")
        times["epoch0_s"] = time.perf_counter() - t0
        base = [(o["state"], o["blame"], o["error"]) for o in sup.outcomes]
        if base != [("done", False, None)] * 2:
            fail(f"fleet: epoch 0 ended {sup.outcomes}")

        # more epochs queued on the victim, killed once its session is
        # collecting (the storm phase's bystanders are the control)
        t0 = time.perf_counter()
        for e in FLEET_VICTIM_EPOCHS:
            sup.submit(victim_cid, e)
        end = time.monotonic() + 300
        while time.monotonic() < end:
            sup.pump(0.2)
            states = sup.shards[victim].last_stats.get("states", {})
            if states.get("collecting"):
                break
        else:
            fail("fleet: the victim's session never reached collecting")
        faults.configure("seed=11,shard_kill=1.0,shard_kill_max=1")
        try:
            t_kill = time.monotonic()
            killed = sup.chaos_kill(round(t_kill - t0, 3), victim)
        finally:
            faults.reset()
        if killed != victim:
            fail(f"fleet: shard_kill killed {killed}, not the victim {victim}")
        if not sup.drain(900):
            fail(f"fleet: the epochs did not drain after the kill: {sup.pending}")
        times["epochs_s"] = time.perf_counter() - t0
        by_epoch = {(o["cid"], o["epoch"]): o for o in sup.outcomes}
        got = {e: by_epoch[(victim_cid, e)] for e in FLEET_VICTIM_EPOCHS}
        verdict = base[0]
        if any((o["state"], o["blame"], o["error"]) != verdict for o in got.values()):
            fail(f"fleet: the victim's epochs {got}, not epoch 0's verdict {verdict}")
        vias = {o["via"] for o in got.values()}
        if not vias & {"failover", "resubmit"}:
            fail(f"fleet: no epoch crossed the failover: {vias}")
        fo = sup.failovers[0]
        detect_s = fo["detected_mono"] - t_kill
        agg = sup.aggregate()
        rec = fo.get("recovery") or {}
        if len(agg["failovers"]) != 1 or rec.get("replayed_terminal", 0) < 1 or rec.get(
                "skipped") != 0 or fo["moved"] != [victim_cid] or fo["mttr_s"] is None:
            fail(f"fleet: failover {agg['failovers']}")
        if (fo["cause"], fo["exit_code"]) != ("exit", -signal.SIGKILL) or agg["errors"]:
            fail(f"fleet: the failover's cause {fo['cause']} (exit code {fo['exit_code']}), "
                 f"the shards' errors {agg['errors']}")
        flight_path = sup.shards[victim].journal_dir / "flight.json"
        if fo["flight_dump"] != str(flight_path):
            fail(f"fleet: no flight.json beside the dead journal: {fo['flight_dump']}")
        flight = json.loads(flight_path.read_text())
        if not flight["events"] or flight["schema"] != "fsdkr-flight/1":
            fail("fleet: the dead shard's flight ring is empty")
        sessions, _ = recovery.load_state(fo["journal_dir"])
        settled = rec["replayed_terminal"] + rec["resumed"] + rec["aborted_transient"]
        if settled != len(sessions) or agg["journal"].get("records", 0) <= 0:
            fail(f"fleet: the journals account for {settled} of {len(sessions)} sessions: {rec}")
        done = sum(1 for o in sup.outcomes if o["state"] == "done")
        times.update(detect_s=detect_s, mttr_s=fo["mttr_s"], recover_s=fo.get("recover_s"),
                     sessions_done=done,
                     sessions_per_s=(done - 2) / times["epochs_s"],
                     latency={f"{o['cid']}:{o['epoch']}": o["total_s"] for o in sup.outcomes},
                     vias={f"{o['cid']}:{o['epoch']}": o["via"] for o in sup.outcomes})
        log(f"fleet: SIGKILL of shard {victim} mid-session through shard_kill: death detected "
            f"{detect_s:.3f} s after the kill, the peer adopted the journal {fo.get('recover_s')} "
            f"s after detection (replay {json.dumps(rec)}), MTTR {fo['mttr_s']} s; the victim's "
            f"epochs {json.dumps({e: (o['state'], o['via'], o['total_s']) for e, o in got.items()})}"
            f", {verdict} as epoch 0; flight.json beside the dead journal "
            f"({len(flight['events'])} events, {flight['reason']}); {settled} of "
            f"{len(sessions)} journaled sessions settled")
        log(f"fleet: epoch 0 on both {times['epoch0_s']:.3f} s; after it {done - 2} sessions in "
            f"{times['epochs_s']:.3f} s ({times['sessions_per_s']:.4f} sessions/s across the "
            f"kill); aggregate {json.dumps({k: agg[k] for k in ('alive', 'kills', 'journal')})}, "
            f"serving {json.dumps({k: v for k, v in agg['serving'].items() if k.startswith('sessions')})}")
    finally:
        sup.stop()
        shutil.rmtree(root, ignore_errors=True)
    log(f"fleet: {smi_line()}")
    return times


# sessions/s offered across the storm's clients: half of what the storm
# sustained at 1.0 offered on the H100 (0.628 over TCP, PERF.md section 5)
STORM_RATE = 0.3


def phase_storm(dev, seed, bits=2048, m_security=256, rounds=11, window=60, backend="cuda"):
    """The load generator's network storm with 3 SIGKILLs on 4 shards on
    the card (the module docstring's `storm`). Returns its report's
    numbers."""
    from fsdkr_tpu_torch.serving import loadgen

    out = os.path.join("chiprun_out", "chip_storm.json")
    args = loadgen.parse_args([
        "--net", "--kills", "3", "--shards", "4", "--clients", "2",
        "--committees", "12", "--bases", "3", "--n", "3", "--t", "1", "--bits", str(bits),
        "--m-security", str(m_security), "--ck-rounds", str(rounds), "--window", str(window),
        "--rate", repr(STORM_RATE), "--baseline-window", "10", "--deadline", "600",
        "--deadline-factor", "4", "--seed", str(seed), "--device", dev.type,
        "--backend", backend, "--out", out,
    ])
    t0 = time.perf_counter()
    rep = loadgen.run_net_storm(args)
    wall = time.perf_counter() - t0
    want_device = "cpu" if dev.type == "cpu" else __import__("torch").cuda.get_device_name(0)
    bad_gates = [k for k, v in rep["gates"].items() if not v]
    causes = [(fo["cause"], fo["exit_code"]) for fo in rep["failovers"]]
    if bad_gates or rep["shard_devices"] != [want_device] or \
            any(c != ("exit", -9) for c in causes) or len(causes) != rep["kills_injected"]:
        fail(f"storm: gates failed {bad_gates}, shard devices {rep['shard_devices']}, "
             f"failovers' causes {causes} (report {out})")
    log(f"storm: {rep['kills_injected']} SIGKILLs under {rep['net_fault_spec']!r}, "
        f"{rep['epochs_submitted']} epochs: {json.dumps(rep['outcomes'])}; gates "
        f"{json.dumps(rep['gates'])}; every shard on {want_device}; the failovers' causes "
        f"{causes}")
    log(f"storm: MTTR per failover {rep['mttr_s']['per_failover']} s, recover_s "
        f"{rep['recover_s']['per_failover']} s, bystander p99 {rep['bystander_p99_s']} s "
        f"({rep['bystander_done']} done, bound {rep['p99_bound_s']} s), deadline "
        f"{rep['deadline_s']} s (4 x seed p99 {rep['seed_p99_s']} s), {rep['net_sessions_per_s']}"
        f" sessions/s over TCP against {rep['in_process_baseline']['sessions_per_s']} in "
        f"process; ingress {json.dumps(rep['aggregate']['ingress'])}; client "
        f"{json.dumps(rep['client_counters'])}; {wall:.1f} s")
    return {k: rep[k] for k in ("mttr_s", "recover_s", "bystander_p99_s", "net_sessions_per_s",
                                "deadline_s", "seed_p99_s", "outcomes", "kills_injected")}


def rns_path(pre, config, n, party=2):
    """Inside forced_rns_route(), with the RNS kernels' counters zeroed
    just before and read just after: distribute_batch by all n senders
    from `pre` (their keys before the routed distribute), then `party`'s
    collect of those messages, timed layer by layer. The same party's
    collect of the same messages through the CIOS engine must adopt the
    same key. Returns the counts, the launches by shape and the
    distribute's wall time."""
    from fsdkr_tpu_torch.backend.powm import forced_rns_route, powm_cache_stats
    from fsdkr_tpu_torch.carry import to_fields
    from fsdkr_tpu_torch.ops import rns_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage

    with forced_rns_route():
        rns_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = RefreshMessage.distribute_batch([(k.i, k) for k in pre], n, config)
        wall = time.perf_counter() - t0
        msgs = [m for m, _ in out]
        routed = (copy.deepcopy(pre[party]), copy.deepcopy(out[party][1]))
        s0 = powm_cache_stats()
        totals = span_collect(msgs, (pre[party], out[party][1]), config, "rns")
        s1 = powm_cache_stats()
        counts = rns_kernels.launch_counts()
        shapes = {"rns_mont_mul": dict(rns_kernels.mont_mul.shapes),
                  "rns_modexp": dict(rns_kernels.modexp.shapes)}
    log(f"rns path: distribute_batch, {n} senders: {wall:.3f} s; then one collect; "
        f"launches {counts}; precompute cache over the collect: "
        f"{s1['hits'] - s0['hits']} hits, {s1['misses'] - s0['misses']} misses")
    for name, by_shape in shapes.items():
        log(f"rns path: {name} launches by shape: "
            + ", ".join(f"{shape}: {c}" for shape, c in sorted(by_shape.items())))
    if counts != {"rns_mont_mul": 14, "rns_modexp": 15}:
        fail(f"the RNS path launched {counts}, expected kernel 1 14 times and "
             f"kernel 2 15 times")
    honest_u1_check(totals, "rns")
    RefreshMessage.collect(msgs, routed[0], routed[1], config=config)
    if to_fields(pre[party]) != to_fields(routed[0]):
        fail("the RNS route's collect adopted another key than the CIOS engine's")
    log("rns path: adopted key == the same collect's through the CIOS engine")
    return counts, shapes, wall


# the layers of one collect, timed from here by wrapping the callables the
# protocol and verifier look up by name: (module path, attribute, class)
_SPANS = (
    ("fsdkr_tpu_torch.protocol.refresh", "check_structure", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "validate_feldman", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_pairs", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_pdl_u1_batch", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_pdl_u1_host", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "batch_inv", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_ring_pedersen", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.protocol.refresh", "share_recovery_check", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "verify_correct_key", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.protocol.refresh", "adopt_session", None),
    ("fsdkr_tpu_torch.protocol.refresh", "combine_committed_points", None),
    # device EC (its callers look the entry points up in ops.ec_batch);
    # the conversions host <-> device, the second of which waits for the
    # kernels
    ("fsdkr_tpu_torch.ops.ec_batch", "batch_msm", None),
    ("fsdkr_tpu_torch.ops.ec_batch", "points_to_device", None),
    ("fsdkr_tpu_torch.ops.ec_batch", "device_to_points", None),
    ("fsdkr_tpu_torch.backend.powm", "device_powm_batches", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "device_modmul", None),
    # the joint path's: the planner, the RANGEOPT engines, the host's
    # base inversions
    ("fsdkr_tpu_torch.backend.powm", "multi_powm", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "device_powm_shared_exp_groups", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "joint_comb2_groups", None),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "batch_base_inv", None),
    # the RLC path's: each family's arm, the host's rho draws and folds,
    # the merged (h1, h2) rows, and the Straus rows' planner with its host
    # products of the parts of a split row
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_pdl_rlc_prepare", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_pdl_rlc_finish", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_ring_pedersen_rlc", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "_correct_key_rlc", "CudaBatchVerifier"),
    ("fsdkr_tpu_torch.backend.cuda_verifier", "fold_ladder2", None),
    ("fsdkr_tpu_torch.backend.rlc", "sample_rhos", None),
    ("fsdkr_tpu_torch.proofs.pdl_slack", "rlc_fold_nt", "PDLwSlackProof"),
    ("fsdkr_tpu_torch.proofs.pdl_slack", "rlc_fold_nn", "PDLwSlackProof"),
    ("fsdkr_tpu_torch.proofs.ring_pedersen", "rlc_fold", "RingPedersenProof"),
    ("fsdkr_tpu_torch.proofs.correct_key", "rlc_fold", "NiCorrectKeyProof"),
    ("fsdkr_tpu_torch.backend.powm", "_joint_rows", None),
    ("fsdkr_tpu_torch.backend.powm", "_prod_mod", None),
    # the grouped columns' two routes: the comb and the generic engine
    # (every width batch of a powm_columns call in one launch)
    ("fsdkr_tpu_torch.backend.powm", "device_powm_shared", None),
    ("fsdkr_tpu_torch.ops.montgomery", "modexp_batches", None),
    # the RNS route's (inside forced_rns_route()); the CIOS modmul, the
    # comb (their results end in a host copy) and the batch inverse's
    # product tree
    ("fsdkr_tpu_torch.backend.powm", "device_powm", None),
    ("fsdkr_tpu_torch.ops.montgomery", "modmul", "BatchModExp"),
    ("fsdkr_tpu_torch.ops.montgomery", "shared_base_modexp", None),
    ("fsdkr_tpu_torch.ops.montgomery", "batch_mod_inv_grouped", None),
)
# the steps inside device_powm / device_modmul (ops/rns.py's globals); each
# of these spans ends in torch.cuda.synchronize(), so it holds its own
# device work. The kernel wrappers are wrapped in the `rns_kernels` name
# that ops/rns.py looks up, never in rns_kernels itself: the raw wrapper
# bumps its counter through its own global name.
_RNS_SPANS = ("_row_consts", "ints_to_limbs", "to_device", "_limbs_to_residues",
              "_crt_exit_kernel", "limbs_to_ints")
# the same for the CIOS engine's steps (ops/montgomery.py's globals)
_CIOS_SPANS = ("ints_to_limbs", "to_device", "_download_all", "_comb_table")


def span_collect(msgs, spare, config, label):
    """Wall time of each layer inside one collect (inclusive and self
    seconds, by parent span); returns the spans' totals, {(parent,
    name): [calls, inclusive s, self s]}. device_powm / device_modmul end in a host
    copy of their result, so their spans include the device time. Inside
    them, every step's span ends in a synchronize, so the device work
    falls in the step that queued it; what the columns keep as self time
    is the download of the result limbs (between `_crt_exit_kernel` and
    `limbs_to_ints`) and the Python between the steps. Which steps wait
    on the device without that synchronize: `to_device` (a copy from
    pageable host memory synchronises its stream) and `_crt_exit_kernel`
    (its carry loop reads `bool(hi.any())`)."""
    import importlib
    import types

    import torch

    from fsdkr_tpu_torch.ops import (ec_batch, ec_kernels, montgomery, montgomery_kernels, rns,
                                     rns_kernels)
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
    for owner, attrs in ((rns, _RNS_SPANS), (montgomery, _CIOS_SPANS)):
        for attr in attrs:
            patched.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, wrap(attr, getattr(owner, attr), sync=True))
    proxy = types.SimpleNamespace(**vars(rns_kernels))
    proxy.mont_mul = wrap("kernel 1 mont_mul", rns_kernels.mont_mul, sync=True)
    proxy.modexp = wrap("kernel 2 modexp", rns_kernels.modexp, sync=True)
    patched.append((rns, "rns_kernels", rns_kernels))
    rns.rns_kernels = proxy
    proxy = types.SimpleNamespace(**vars(montgomery_kernels))
    for attr in ("mont_mul", "modmul", "modexp_segments", "comb", "comb_ladder", "multi_modexp",
                 "shared_exp_segments"):
        setattr(proxy, attr, wrap(f"cios_{attr}", getattr(montgomery_kernels, attr),
                                  sync=True))
    patched.append((montgomery, "montgomery_kernels", montgomery_kernels))
    montgomery.montgomery_kernels = proxy
    proxy = types.SimpleNamespace(**vars(ec_kernels))
    for attr in ("scalar_mul", "tree_sum"):
        setattr(proxy, attr, wrap(f"ec_{attr}", getattr(ec_kernels, attr), sync=True))
    patched.append((ec_batch, "ec_kernels", ec_kernels))
    ec_batch.ec_kernels = proxy
    try:
        t0 = time.perf_counter()
        RefreshMessage.collect(msgs, spare[0], spare[1], config=config)
        wall = time.perf_counter() - t0
    finally:
        for owner, attr, raw in patched:
            setattr(owner, attr, raw)
    top = sum(tot[1] for (parent, _), tot in totals.items() if parent == "collect")
    log(f"spans ({label}): one collect {wall:.3f} s; outside the spans "
        f"{wall - top:.3f} s")
    for (parent, name), (calls, incl, own) in totals.items():
        log(f"spans ({label}):   {parent:>22} > {name:<22} calls {calls:3d}  "
            f"incl {incl:8.3f} s  self {own:8.3f} s")
    return totals


def span_distribute(senders, new_n, config, label):
    """Wall time of one distribute_batch by its phases, the JAX package's
    names, from the span tracer (telemetry.spans): each phase's seconds,
    and the rest of the call, outside the top-level phases (the Feldman
    commitments, which no phase holds), as `outside the spans`. Every
    phase that holds device work ends in a host copy of its result, so
    it holds that work. Returns (messages, wall, {phase: s}, the
    tracer's stats)."""
    from fsdkr_tpu_torch.protocol import RefreshMessage
    from fsdkr_tpu_torch.telemetry.spans import get_tracer

    tr = get_tracer()
    tr.reset()
    tr.enable()
    try:
        t0 = time.perf_counter()
        out = RefreshMessage.distribute_batch(senders, new_n, config)
        wall = time.perf_counter() - t0
    finally:
        tr.disable()
    spans = tr.spans()
    root = [sp for sp in spans if sp.name == "distribute" and sp.parent_id is None]
    top = sum(sp.duration for sp in spans if root and sp.parent_id == root[-1].span_id)
    stats = tr.stats()
    tr.reset()
    phases = {k: st.seconds for k, st in stats.items() if k.startswith("distribute.")}
    phases["outside the spans"] = wall - top
    log(f"distribute spans ({label}): one distribute_batch of {len(senders)} senders "
        f"{wall:.3f} s")
    for key, sec in phases.items():
        log(f"distribute spans ({label}):   {key:<34} {sec:8.3f} s")
    return out, wall, phases, stats


def honest_u1_check(totals, label):
    """An honest collect's PDL u1 column is one combined MSM on the card:
    `_pdl_u1_batch` once, the per-row host check never."""
    calls = {name: sum(tot[0] for (_, n), tot in totals.items() if n == name)
             for name in ("_pdl_u1_batch", "_pdl_u1_host")}
    if calls != {"_pdl_u1_batch": 1, "_pdl_u1_host": 0}:
        fail(f"an honest collect ({label}) made the u1 calls {calls}")
    log(f"spans ({label}): PDL u1 by one device MSM, no per-row host check")


def device_busy(fn):
    """Runs fn under torch.profiler (device activity only: recording every
    host-side op as well slowed a profiled collect to 8.6-15.1 s): its wall
    ms, the device's busy ms and the device ms by event name. Device events
    only (kernels, memcpy, memset): a CPU op's row repeats the device time
    of the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    return wall_ms, sum(by_name.values()), by_name


def profile_collect(msgs, spare, config, median_s, joins=()):
    """Device time by kernel over one collect (torch.profiler), beside
    the collect's wall time: the device's busy and idle share. The
    profiler slows the host side, so the share is given against the
    median collect without it as well."""
    from fsdkr_tpu_torch.protocol import RefreshMessage

    wall_ms, busy_ms, by_name = device_busy(
        lambda: RefreshMessage.collect(msgs, spare[0], spare[1], joins, config=config))
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


# each kernel: a substring of its device events' (mangled) names, its
# source, the function of the JAX package it replaces, and the launches
# per timing (modexp launches take milliseconds, products microseconds)
KERNELS = {
    "rns_mont_mul": ("rns_mont_mul_kernel", "fsdkr_tpu_torch/csrc/rns_kernels.cu",
                     "fsdkr_tpu/ops/pallas_rns.py:184", 200),
    "rns_modexp": ("rns_modexp_kernel", "fsdkr_tpu_torch/csrc/rns_kernels.cu",
                   "fsdkr_tpu/ops/pallas_rns.py:317", 10),
    # both layouts: cios_mont_mul_kernel (one warp a row) and
    # cios_mont_mul_rows_kernel (from R* rows)
    "cios_mont_mul": ("cios_mont_mul_", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                      "fsdkr_tpu/ops/montgomery.py:102", 200),
    "cios_modmul": ("cios_modmul_rows_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                    "fsdkr_tpu/ops/montgomery.py:606", 200),
    "cios_modexp": ("cios_modexp_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                    "fsdkr_tpu/ops/montgomery.py:137", 10),
    "cios_comb": ("cios_comb_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                  "fsdkr_tpu/ops/montgomery.py:372", 10),
    "cios_comb_ladder": ("cios_comb_ladder_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                         "fsdkr_tpu/ops/montgomery.py:323", 10),
    "ec_scalar_mul": ("ec_scalar_mul_kernel", "fsdkr_tpu_torch/csrc/ec_kernels.cu",
                      "fsdkr_tpu/ops/ec_batch.py:136", 10),
    "ec_tree_sum": ("ec_tree_sum_kernel", "fsdkr_tpu_torch/csrc/ec_kernels.cu",
                    "fsdkr_tpu/ops/ec_batch.py:175", 50),
    "cios_multi_modexp": ("cios_multi_modexp_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                          "fsdkr_tpu/ops/montgomery.py:450", 10),
    "cios_shared_exp": ("cios_shared_exp_kernel", "fsdkr_tpu_torch/csrc/cios_kernels.cu",
                        "fsdkr_tpu/ops/montgomery.py:183", 10),
}
_SYMBOL = {name: spec[0] for name, spec in KERNELS.items()}


def _device_ms(fn, reps, name):
    """The kernel's own time per launch: the same `reps` calls as
    `_events_ms`, under torch.profiler, summing the self device time of
    the device events whose name holds the kernel's symbol, over the
    launches the profiler recorded (it may miss the first few of a
    window). The events time above also holds the wrapper's host work
    wherever that is slower than the kernel; this does not.

    A window in which the profiler recorded no launch of the kernel is
    taken again once, as one plain profiled window after an unprofiled
    warm-up call. Should both come back empty (late in a long run most
    windows taken again stay empty too, and each costs the window's
    launches), the CUDA-events time per call stands in, and the log says
    so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernel_time(averages):
        us, launches = 0.0, 0
        for ev in averages:
            if ev.device_type == DeviceType.CUDA and _SYMBOL[name] in ev.key:
                us += getattr(ev, "self_device_time_total", 0) or 0
                launches += ev.count
        return us, launches

    for attempt in range(2):
        if attempt < 1:
            schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
            recorded = []
            with profile(activities=[ProfilerActivity.CUDA], schedule=schedule,
                         on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
                fn()
                torch.cuda.synchronize()
                prof.step()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
            us, launches = kernel_time(recorded[0] if recorded else ())
        else:
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            us, launches = kernel_time(prof.key_averages())
        if launches:
            break
        log(f"time: the profiler recorded no launch of {_SYMBOL[name]} "
            f"(attempt {attempt + 1}); recording again")
    if not launches:
        ms = _events_ms(fn, reps)
        log(f"time: the profiler recorded no launch of {_SYMBOL[name]} in two windows: "
            f"its device time stands as the CUDA-events time, {ms:.4f} ms a call")
        return ms
    if launches > reps or us <= 0:
        fail(f"the profiler saw {launches} launches of {_SYMBOL[name]} "
             f"({us} us) over {reps} calls")
    return us / 1e3 / launches


def _bits_of_k(k):
    from fsdkr_tpu_torch.ops import rns

    return next(b for b in (256, 512, 1024, 1536, 2048, 3072, 4096, 5120,
                            6144, 7168)
                if rns.rns_bases_for_bits(b, b // 16).k == k)


def _max_err(got, want):
    """The largest absolute difference of two tensors, or of two lists of
    tensors (a segmented launch's results)."""
    import torch

    torch.cuda.synchronize()
    if isinstance(got, list):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _shape(name, shape):
    """A shapes-map key as (k, rows, exp_bits, groups): exp_bits None for
    the products, groups None but for the comb (whose rows are groups x
    rows per group); the ladder's rows are its groups."""
    if name == "cios_comb":
        k, g, m, exp_bits = shape
        return k, g * m, exp_bits, g
    if name == "ec_scalar_mul":
        rows, bits = shape
        return 16, rows, bits, None
    if name == "ec_tree_sum":
        g, m = shape
        return 16, g * m, None, g
    return ((*shape, None) if len(shape) == 2 else shape) + (None,)


def _shape_str(name, k, rows, exp_bits, groups=None):
    if name == "ec_scalar_mul":
        return f"rows={rows} scalar_bits={exp_bits}"
    if name == "ec_tree_sum":
        return f"groups={groups} rows={rows // groups}"
    kk = "k" if name.startswith("rns") else "K"
    if name == "cios_comb":
        rows_s = f"groups={groups} rows={rows // groups}"
    else:
        rows_s = f"groups={rows}" if name == "cios_comb_ladder" else f"rows={rows}"
    return f"{kk}={k} {rows_s}" + (f" exp_bits={exp_bits}" if exp_bits else "")


def kernel_calls(name, dev, rng, k, rows, exp_bits, worst, groups=None):
    """(kernel call, plain call) on fresh inputs at one shape; `worst`
    rows (the comb's kernels: `worst` groups) worst-case."""
    if name == "ec_scalar_mul":
        return ec_calls(name, ec_inputs(rng, dev, rows, exp_bits, worst), exp_bits)
    if name == "ec_tree_sum":
        return ec_calls(name, (tree_inputs(rng, dev, groups, rows // groups),))
    if name in COMB:
        if name == "cios_comb_ladder":
            groups = rows
        args = comb_inputs(rng, dev, k, groups, rows // groups, exp_bits, worst)
        return comb_calls(name, args, exp_bits)
    if name.startswith("cios"):
        args = cios_inputs(rng, dev, k, rows, exp_bits or 64, worst)
        return cios_calls(name, args, exp_bits)
    from fsdkr_tpu_torch.ops import rns, rns_kernels

    bits = _bits_of_k(k)
    rb = rns.rns_bases_for_bits(bits, bits // 16)
    K = rns._device_consts(rb, dev).kernel
    x, y, c1, nb, exp = kernel_inputs(rng, rb, dev, rows, exp_bits or 256, worst)
    if name == "rns_mont_mul":
        return (lambda: rns_kernels.mont_mul(x, y, c1, nb, K),
                lambda: rns_kernels.mont_mul_plain(x, y, c1, nb, K))
    return (lambda: rns_kernels.modexp(x, exp, y, c1, nb, K, exp_bits),
            lambda: rns_kernels.modexp_plain(x, exp, y, c1, nb, K, exp_bits))


def _timed_ms(fn):
    """(result, CUDA-events ms) of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def ec_chain(scalar_bits):
    """Complete additions along a scalar-mul row's chain: the table's 14,
    then 4 doublings and one add a window."""
    return 14 + 5 * scalar_bits // 4


def ec_macs(name, rows, scalar_bits, groups=None):
    """16x16-bit multiply-adds of one EC launch: per scalar-mul row the
    table's 14 additions, then per window 4 doublings and one addition;
    M - 1 additions a tree group of M rows."""
    if name == "ec_scalar_mul":
        return ec_scalar_mul_macs(rows, scalar_bits)
    return ec_tree_sum_macs(rows, groups)


def bound_ms(name, k, rows, exp_bits, groups=None):
    """The least time the H100 could take for one launch: (ms, "bytes" or
    "operations"). Bytes: each input read once, each output written once
    (int32 tensors), the shared constants once. Operations: the
    multiply-adds of 16x16 bits, each four 8-bit ones: the RNS base
    extensions' 2k(k+1) per product per row, the CIOS product's 2K^2.
    The comb: W + 1 products a row (W = exp_bits / 4 windows) and the
    16-entry table of every window and group read once; its ladder: 1 +
    4(W - 1) products a group, the W powers written. Device EC: the
    multiply-adds its additions and doublings need (`ec_macs`); the points
    and scalars read once, the points written."""
    if name in EC:
        macs_per_product, products = 1, ec_macs(name, rows, exp_bits, groups)
        if name == "ec_scalar_mul":
            in_out_bytes = 4 * rows * (2 * 3 * k + exp_bits // 16)
        else:
            in_out_bytes = 4 * 3 * k * (rows + groups)
        const_bytes = 0
    elif name.startswith("rns"):
        C = 2 * k + 1
        macs_per_product = 2 * k * (k + 1)
        const_bytes = 4 * (2 * k * (k + 1) + C + (k + 1) + 2 * k)
        if name == "rns_mont_mul":
            products = rows
            in_out_bytes = 4 * rows * (3 * C + 2 * k + 1)
        else:
            products = rows * (17 + 5 * exp_bits // 4)
            in_out_bytes = 4 * rows * (3 * C + exp_bits // 16 + 2 * k + 1)
    else:
        # x, y (or base, r2, one), n, the result, and n_inv's low two limbs
        macs_per_product = 2 * k * k
        const_bytes = 0
        if name == "cios_mont_mul":
            products, limbs = rows, 4 * k + 2
        elif name == "cios_modmul":
            products, limbs = 2 * rows, 5 * k + 2
        elif name == "cios_comb":
            w_cnt = exp_bits // 4
            products = rows * (w_cnt + 1)
            # exponents and results per row; the table, n, one and n_inv's
            # low limbs per group
            limbs = exp_bits // 16 + k
            const_bytes = 4 * groups * (16 * w_cnt * k + 2 * k + 2)
        elif name == "cios_comb_ladder":
            w_cnt = exp_bits // 4
            products = rows * (1 + 4 * (w_cnt - 1))
            limbs = 3 * k + 2 + w_cnt * k  # base, r2, n, n_inv; the powers
        elif name == "cios_multi_modexp":
            # exp_bits: the terms' widths; the widest's squarings, each
            # term's window products and its 16-entry table
            widths = exp_bits
            products = rows * (widths[0] + sum(widths) // 4 + 16 * len(widths))
            # each term's base and exponent, r2, one, n, n_inv; the result
            limbs = len(widths) * (k + widths[0] // 16) + 4 * k + 2
        elif name == "cios_shared_exp":
            # one segment: each row's base and result; the modulus, its
            # constants and the digits once
            products = rows * (16 + 5 * exp_bits // 4)
            limbs = 2 * k
            const_bytes = 4 * (4 * k + 2 + exp_bits // 4)
        else:
            products = rows * (16 + 5 * exp_bits // 4)
            limbs = 5 * k + 2 + exp_bits // 16
        in_out_bytes = 4 * rows * limbs
    ops_ms = products * macs_per_product * 4 * 2 / INT8_OPS_PER_S * 1e3
    bytes_ms = (in_out_bytes + const_bytes) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _time_launch(name, fn):
    """(events ms, device ms) per launch of the kernel's wrapper."""
    reps = KERNELS[name][3]
    return _events_ms(fn, reps), _device_ms(fn, reps, name)


def modexp_bound(segments, name="cios_modexp"):
    """A segmented launch's bound (`cios_modexp`, `cios_shared_exp`): the
    sum of its segments' bounds, each as `bound_ms` gives it; bound by
    what bounds the largest."""
    parts = [bound_ms(name, k, rows, exp_bits) for k, rows, exp_bits in segments]
    return sum(ms for ms, _ in parts), max(parts)[1]


def chain_steps(shape):
    """CIOS steps (one per 32-bit word of a product) along the longest
    chain of a `cios_modexp` launch (its segments')."""
    return max((16 + 5 * exp_bits // 4) * (k // 2) for k, _, exp_bits in shape)


def ladder_products(shape):
    """Dependent products along a ladder launch's chain: the entry, then
    four squarings a window after the first."""
    _, _, exp_bits = shape
    return 1 + 4 * (exp_bits // 4 - 1)


# one SM's 32-bit integer multiply-adds a cycle (4 schedulers x 16 lanes)
SM_INT_MACS_PER_CYCLE = 64


def max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def ladder_chain_ms(shape, clock_hz):
    """The ladder's chain at one SM: its products, each a Montgomery
    product's 2W^2 32-bit multiply-adds at one SM's integer rate at the
    card's maximum SM clock. A yardstick for a latency-bound chain beside
    the throughput bound of `bound_ms`."""
    k = shape[0]
    macs = 2 * (k // 2) ** 2
    return ladder_products(shape) * macs / (SM_INT_MACS_PER_CYCLE * clock_hz) * 1e3


def _case(name, shape, dev, rng):
    """One main-path launch shape on fresh inputs, rows (the comb's:
    groups) half random and half worst-case: (kernel call, plain call,
    bound ms, what bounds it, the shape as text, its JSON fields)."""
    if name in ("cios_modexp", "cios_shared_exp"):
        calls = modexp_segment_calls if name == "cios_modexp" else shared_exp_calls
        kernel, plain = calls(dev, rng, shape)
        bound, by = modexp_bound(shape, name)
        text = "segments (K, rows, exp_bits) " + ", ".join(map(str, shape))
        return kernel, plain, bound, by, text, {"segments": [list(seg) for seg in shape]}
    if name == "cios_multi_modexp":
        k, rows, widths = shape
        kernel, plain = multi_calls(dev, rng, k, rows, widths, rows // 2)
        bound, by = bound_ms(name, k, rows, widths)
        return (kernel, plain, bound, by, f"K={k} rows={rows} T={len(widths)} exp_bits={widths}",
                {"k": k, "rows": rows, "exp_bits": list(widths)})
    k, rows, exp_bits, groups = _shape(name, shape)
    half = (groups or rows) // 2 if name in COMB else rows // 2
    kernel, plain = kernel_calls(name, dev, rng, k, rows, exp_bits, half, groups)
    bound, by = bound_ms(name, k, rows, exp_bits, groups)
    if name == "ec_scalar_mul":
        fields = {"rows": rows, "scalar_bits": exp_bits}
    elif name == "ec_tree_sum":
        fields = {"groups": groups, "rows": rows // groups}
    else:
        fields = {"k": k, "rows": rows, "exp_bits": exp_bits, "groups": groups}
    return (kernel, plain, bound, by, _shape_str(name, k, rows, exp_bits, groups), fields)


def comb_row_steps(shape):
    """CIOS steps of all rows of a `cios_comb` launch: W + 1 products a
    row (W = exp_bits / 4 windows) of K/2 steps."""
    k, groups, per_group, exp_bits = shape
    return groups * per_group * (exp_bits // 4 + 1) * (k // 2)


def _per_step(name, shape, dms):
    if name in EC:
        k, rows, bits, groups = _shape(name, shape)
        chain = ec_chain(bits) if name == "ec_scalar_mul" else (rows // groups).bit_length() - 1
        return f", {dms * 1e3 / max(chain, 1):.3f} us per complete addition of a row's chain ({chain})"
    if name == "cios_comb":
        return f", {dms * 1e6 / comb_row_steps(shape):.4f} ns per row-step"
    if name == "cios_comb_ladder":
        return (f", {dms * 1e3 / ladder_products(shape):.3f} us per product of the chain "
                f"(one SM's chain: {ladder_chain_ms(shape, _CLOCK['hz']):.4f} ms)")
    if name in JOINT:
        products = joint_products(name, shape)
        return f", {dms * 1e3 / products:.3f} us per product of a row's chain ({products})"
    if name != "cios_modexp":
        return ""
    return f", {dms * 1e6 / chain_steps(shape):.2f} ns per CIOS step of the longest chain"


def joint_products(name, shape):
    """Dependent products along a joint kernel's row: each term's table
    (the entry by r2 and 14 products), the widest term's squarings, one a
    window of each term, the exit (the longest segment's, for
    `cios_shared_exp`)."""
    if name == "cios_multi_modexp":
        _, _, widths = shape
        return 15 * len(widths) + widths[0] + sum(widths) // 4 + 1
    return max(16 + 5 * exp_bits // 4 for _, _, exp_bits in shape)


_CLOCK = {}  # the card's maximum SM clock, read once by phase_time


def check_and_time_shapes(dev, rng, shapes):
    """Each kernel at every shape the main path launched it with, on one
    set of inputs whose first half of rows (the comb's: groups; a
    segmented launch's: each segment's) is random and second half
    worst-case: the kernel against its plain version (bit-identical), the
    plain version's time (CUDA events, one call), the kernel's times
    (CUDA events and device time; no kernel's work depends on its data)
    and its bound. Returns the largest absolute difference of each kernel
    (0 when bit-identical), the plain times by (name, shape) and the rows
    of the per-shape table."""
    errs = {name: 0 for name in KERNELS}
    plain_ms, table = {}, []
    t0 = time.perf_counter()
    for name, by_shape in shapes.items():
        for shape, launches in sorted(by_shape.items()):
            t1 = time.perf_counter()
            kernel, plain, bound, by, shape_s, fields = _case(name, shape, dev, rng)
            want, plain_ms[name, shape] = _timed_ms(plain)
            err = _max_err(kernel(), want)
            errs[name] = max(errs[name], err)
            if err:
                fail(f"{name} disagrees with its plain version at {shape_s}")
            del want
            ms, dms = _time_launch(name, kernel)
            log(f"time: per shape {name} {shape_s}: == plain; events {ms:.4f} ms, "
                f"device {dms:.4f} ms, bound {bound:.6f} ms ({by}), device "
                f"{dms / bound:.1f}x bound, plain {plain_ms[name, shape]:.4f} ms, "
                f"{launches} launches{_per_step(name, shape, dms)} "
                f"({time.perf_counter() - t1:.1f} s)")
            table.append({"name": name, "shape": shape, "text": shape_s, "by": by,
                          "fields": fields, "launches": launches, "ms": ms, "device_ms": dms,
                          "bound_ms": bound})
    log(f"time: every kernel == plain, bit-identical, at all {len(table)} "
        f"shapes, rows (the comb's: groups) half random, half worst-case; checked and "
        f"timed in {time.perf_counter() - t0:.1f} s")
    return errs, plain_ms, table


def time_segments_alone(dev, rng, segments):
    """The segmented `cios_modexp` launch over `segments` beside each of
    its segments launched alone, on the same inputs, by device time;
    returns {"joint_ms", "alone": [[K, rows, exp_bits, device ms], ...]}."""
    from fsdkr_tpu_torch.ops import montgomery_kernels as mk

    segs = modexp_segment_inputs(dev, rng, segments)
    reps = KERNELS["cios_modexp"][3]
    joint = _device_ms(lambda: mk.modexp_segments(segs), reps, "cios_modexp")
    alone = []
    for shape, seg in zip(segments, segs):
        alone.append([*shape, _device_ms(lambda: mk.modexp_segments([seg]), reps,
                                         "cios_modexp")])
        log(f"time: cios_modexp segment {shape} alone: device {alone[-1][-1]:.4f} ms"
            f"{_per_step('cios_modexp', (shape,), alone[-1][-1])}")
    longest = max(ms for *_, ms in alone)
    log(f"time: cios_modexp over the {len(segments)} segments {segments} in one launch: "
        f"device {joint:.4f} ms{_per_step('cios_modexp', segments, joint)}; the longest "
        f"segment alone {longest:.4f} ms, the segments alone one after another "
        f"{sum(ms for *_, ms in alone):.4f} ms; joint / longest alone "
        f"{joint / longest:.3f}")
    return {"joint_ms": joint, "alone": alone}


def _cost(name, shape, launches):
    if name in ("cios_modexp", "cios_shared_exp"):
        return sum(k * k * rows * exp_bits for k, rows, exp_bits in shape) * max(launches, 1)
    if name == "cios_multi_modexp":
        k, rows, widths = shape
        return k * k * rows * (widths[0] + sum(widths) // 4) * max(launches, 1)
    k, rows, exp_bits, _ = _shape(name, shape)
    return k * k * rows * (exp_bits or 1) * max(launches, 1)


def phase_time(dev, rng, counts, shapes, extra=(), path_counts=()):
    """`counts` and `shapes` are the main path's launch counts, in total
    and by kernel and shape ((k, rows), (k, rows, exp_bits), the comb's
    (k, groups, rows per group, exp_bits), or a `cios_modexp` launch's
    segments -> launches). `extra`: (label, {kernel: {shape: launches}})
    pairs, another path's own launch shapes (the RLC path's `cios_modexp`
    shapes, the join round's), checked and timed as well, and listed in
    each kernel's entry as `<label>_per_shape`. `path_counts`: (label,
    launches by kernel) pairs, another path's own run's launches (the join
    round's, the sessions and stream phases'), each entry's
    `<label>_launches`."""
    if not all(shapes.values()):
        fail("no main-path launch shapes recorded for a kernel")
    _CLOCK["hz"] = max_sm_clock_hz()
    log(f"time: maximum SM clock {_CLOCK['hz'] / 1e6:.0f} MHz")
    errs, plain_times, per_shape = check_and_time_shapes(dev, rng, shapes)
    extra_rows = {}
    for label, by_name in extra:
        by_name = {name: by_shape for name, by_shape in by_name.items() if by_shape}
        if not by_name:
            continue
        log(f"time: the {label} path's own shapes")
        x_errs, _, extra_rows[label] = check_and_time_shapes(dev, rng, by_name)
        for name in by_name:
            errs[name] = max(errs[name], x_errs[name])
    # the launch of the most segments: the pair families' columns
    pairs = max(shapes["cios_modexp"], key=lambda s: (len(s), _cost("cios_modexp", s, 1)))
    alone = time_segments_alone(dev, rng, pairs)
    # the kernels line: each kernel at its costliest shape on the main path
    out = []
    for name, by_shape in shapes.items():
        shape = max(by_shape, key=lambda s: _cost(name, s, by_shape[s]))
        row = next(r for r in per_shape if r["name"] == name and r["shape"] == shape)
        ms, dms, bound = row["ms"], row["device_ms"], row["bound_ms"]
        plain_ms = plain_times[name, shape]
        log(f"time: {name} at {row['text']}: events {ms:.4f} ms, device {dms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({row['by']})")
        _, source, replaces, _ = KERNELS[name]
        out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "device_ms": dms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": row["by"],
            "library_ms": None,
            "shape": row["text"],
            "per_shape": [{**r["fields"], **{key: r[key] for key in ("launches", "ms", "device_ms",
                                                                    "bound_ms")}}
                          for r in per_shape if r["name"] == name],
            **({"segments_alone": alone} if name == "cios_modexp" else {}),
            **{f"{label}_launches": c[name] for label, c in path_counts if c},
            **{f"{label}_per_shape": [{**r["fields"], **{key: r[key] for key in
                                                         ("launches", "ms", "device_ms",
                                                          "bound_ms")}}
                                      for r in rows if r["name"] == name]
               for label, rows in extra_rows.items() if any(r["name"] == name for r in rows)},
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

    def done(phase):
        log(f"chip_smoke: {phase} phase done at {time.perf_counter() - t_start:.1f} s")

    if "env" in phases:
        phase_env(dev)
        done("env")
    if "kernels" in phases:
        phase_kernels(dev, rng)
        done("kernels")
    if "routes" in phases:
        phase_routes(dev, rng)
        done("routes")
    if "host" in phases:
        log("host: phase seconds " + json.dumps(phase_host(rng)))
        done("host")
    pre = None
    if "main" in phases:
        with column_path():
            counts, shapes, times, per_collect, pre = phase_main(dev)
        log("main: phase seconds " + json.dumps(
            {**times, "collect_each": per_collect}))
        done("main")
    rlc_inputs, rlc_keys, rlc_modexp = None, None, {}
    if "joint" in phases:
        if pre is None:
            fail("the joint phase takes the main phase's keys")
        with knobs(FSDKRC_RLC="0"):
            jcounts, jshapes, jtimes, rlc_inputs = phase_joint(dev, pre)
        log("joint: phase seconds " + json.dumps(jtimes))
        # the joint kernels' launches are those of the joint path's run
        counts.update({name: jcounts[name] for name in JOINT})
        shapes.update(jshapes)
        done("joint")
    if "rlc" in phases:
        if rlc_inputs is None:
            fail("the rlc phase takes the joint phase's messages")
        rcounts, rshapes, rtimes, rlc_keys = phase_rlc(dev, rlc_inputs)
        log("rlc: phase seconds " + json.dumps(rtimes))
        # the joint kernels' launches: the joint path's run and the RLC
        # path's, each counted from 0; their shapes, both runs'
        for name in JOINT:
            counts[name] += rcounts[name]
            for shape, c in rshapes[name].items():
                shapes[name][shape] = shapes[name].get(shape, 0) + c
        # the RLC path's own `cios_modexp` launches (its 16-row full-width
        # chains), checked and timed beside the main path's
        rlc_modexp = {shape: c for shape, c in rshapes["cios_modexp"].items()
                      if shape not in shapes.get("cios_modexp", {})}
        done("rlc")
    if "trace" in phases:
        if rlc_keys is None:
            fail("the trace phase takes the rlc phase's messages and keys")
        ttimes = phase_trace(dev, rlc_inputs, rlc_keys)
        log("trace: phase seconds " + json.dumps(ttimes))
        done("trace")
    join_counts, join_shapes, join_inputs = None, {}, None
    if "join" in phases:
        if pre is None:
            fail("the join phase takes the main phase's keys")
        join_counts, jshapes, jtimes, join_inputs = phase_join(dev, pre)
        log("join: phase seconds " + json.dumps(jtimes))
        # the join round's own launch shapes, checked and timed beside the
        # other paths'
        seen = {**shapes, "cios_modexp": {**shapes["cios_modexp"], **rlc_modexp}}
        join_shapes = {name: {shape: c for shape, c in by_shape.items()
                              if shape not in seen.get(name, {})}
                       for name, by_shape in jshapes.items()}
        done("join")
    sessions_counts, sessions_shapes = None, {}
    if "sessions" in phases:
        if rlc_keys is None or join_inputs is None:
            fail("the sessions phase takes the rlc phase's keys and the join phase's round")
        sessions_counts, sshapes, stimes = phase_sessions(dev, rlc_inputs, rlc_keys, join_inputs)
        log("sessions: phase seconds " + json.dumps(stimes))
        # the phase's own launch shapes, checked and timed beside the others
        seen = {name: {**shapes.get(name, {}), **join_shapes.get(name, {})}
                for name in sshapes}
        seen["cios_modexp"].update(rlc_modexp)
        sessions_shapes = {name: {shape: c for shape, c in by_shape.items()
                                  if shape not in seen[name]}
                           for name, by_shape in sshapes.items()}
        done("sessions")
    stream_counts, stream_shapes = None, {}
    if "stream" in phases:
        if rlc_keys is None:
            fail("the stream phase takes the rlc phase's messages and keys")
        stream_counts, xshapes, xtimes = phase_stream(dev, rlc_inputs, rlc_keys)
        log("stream: phase seconds " + json.dumps(xtimes))
        # the phase's own launch shapes, checked and timed beside the others
        seen = {name: {**shapes.get(name, {}), **join_shapes.get(name, {}),
                       **sessions_shapes.get(name, {})} for name in xshapes}
        seen["cios_modexp"].update(rlc_modexp)
        stream_shapes = {name: {shape: c for shape, c in by_shape.items()
                                if shape not in seen[name]}
                         for name, by_shape in xshapes.items()}
        done("stream")
    prover_counts, prover_shapes, prover_pre = None, {}, None
    if "prover" in phases:
        prover_counts, pshapes, ptimes, prover_pre = phase_prover(dev)
        log("prover: phase seconds " + json.dumps(ptimes))
        # the phase's own launch shapes, checked and timed beside the others
        if shapes is not None:
            seen = {name: {**shapes.get(name, {}), **join_shapes.get(name, {}),
                           **sessions_shapes.get(name, {}), **stream_shapes.get(name, {})}
                    for name in pshapes}
            seen["cios_modexp"].update(rlc_modexp)
            prover_shapes = {name: {shape: c for shape, c in by_shape.items()
                                    if shape not in seen[name]}
                             for name, by_shape in pshapes.items()}
        done("prover")
    serve_counts, serve_shapes = None, {}
    if "serve" in phases:
        t_phase = time.perf_counter()
        serve_counts, vshapes, vapart, vtimes = phase_serve(
            dev, [c for c in (pre, prover_pre) if c is not None])
        log("serve: phase seconds " + json.dumps(vtimes))
        # the committees' keygen, where no earlier phase made them, is
        # set-up, not serving: it stays out of the phase's 150 s
        served_s = time.perf_counter() - t_phase - vtimes["keygen"]
        # the phase's own launch shapes and the producer's, checked and
        # timed beside the others
        seen = {name: {**shapes.get(name, {}), **join_shapes.get(name, {}),
                       **sessions_shapes.get(name, {}), **stream_shapes.get(name, {}),
                       **prover_shapes.get(name, {})} for name in vshapes} \
            if shapes is not None else {name: {} for name in vshapes}
        seen.setdefault("cios_modexp", {}).update(rlc_modexp)
        serve_shapes = {name: {shape: c for shape, c in {**by_shape, **vapart[name]}.items()
                               if shape not in seen[name]}
                        for name, by_shape in vshapes.items()}
        if served_s > 150:
            fail(f"serve: the phase took {served_s:.1f} s past its committees' keygen, "
                 f"over 150 s")
        log(f"serve: the phase took {served_s:.1f} s past its committees' keygen "
            f"({vtimes['keygen']:.1f} s)")
        done("serve")
    ingress_counts, ingress_shapes = None, {}
    if "ingress" in phases:
        ingress_counts, ishapes, itimes = phase_ingress(
            dev, [c for c in (pre, prover_pre) if c is not None])
        log("ingress: phase seconds " + json.dumps(itimes))
        # the phase's own launch shapes, checked and timed beside the others
        seen = {name: {**shapes.get(name, {}), **join_shapes.get(name, {}),
                       **sessions_shapes.get(name, {}), **stream_shapes.get(name, {}),
                       **prover_shapes.get(name, {}), **serve_shapes.get(name, {})}
                for name in ishapes} if shapes is not None else {name: {} for name in ishapes}
        seen.setdefault("cios_modexp", {}).update(rlc_modexp)
        ingress_shapes = {name: {shape: c for shape, c in by_shape.items()
                                 if shape not in seen[name]}
                          for name, by_shape in ishapes.items()}
        done("ingress")
    if "fleet" in phases:
        ftimes = phase_fleet(dev, [c for c in (pre, prover_pre) if c is not None])
        log("fleet: phase seconds " + json.dumps(ftimes))
        done("fleet")
    if "storm" in phases:
        log("storm: " + json.dumps(phase_storm(dev, args.seed)))
        done("storm")
    if "time" in phases:
        if counts is None or any(name not in shapes for name in JOINT):
            fail("the time phase needs the main and joint phases' launch counts")
        if "rlc" not in phases:
            log("time: no rlc phase: the Straus kernel at the joint path's shapes only")
        kernels = phase_time(dev, rng, counts, shapes,
                             (("rlc", {"cios_modexp": rlc_modexp}), ("join", join_shapes),
                              ("sessions", sessions_shapes), ("stream", stream_shapes),
                              ("prover", prover_shapes), ("serve", serve_shapes),
                              ("ingress", ingress_shapes)),
                             (("join", join_counts), ("sessions", sessions_counts),
                              ("stream", stream_counts), ("prover", prover_counts),
                              ("serve", serve_counts), ("ingress", ingress_counts)))
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
