"""Work out chip_smoke's sessions-phase launch tables (SESSIONS_FUSED,
SESSIONS_TWO, SESSIONS_TILED) on the CPU, without a card.

Builds the phase's inputs with the port's host backend (a 16-party round,
its receivers' own collects, and a join round in which parties 2 and 16
leave and two joiners take their indices, as chip_smoke's join phase
does), then runs `chip_smoke.phase_sessions` on device="cpu" with every
kernel wrapper of `ops.montgomery_kernels` and `ops.ec_kernels` replaced
by a call counter (on the card a wrapper call is one launch; on the CPU
the wrappers run their plain versions and count nothing). chip_smoke's
gates print instead of exiting, so a table that the drive does not meet
prints its (got, expected) pairs and the drive goes on.

The comb's group cap (`backend.powm.device_powm_shared`) depends on the
exponent's width bucket: at --bits 1536 the joint range column's s2
exponents fall in the 2560-bit bucket, whose cap (16 groups) is the one
of the 3072-bit bucket at 2048 bits, where the card runs the phase.

    python3 scripts/sessions_launch_drive.py [--bits 1536] [--threads 4]

Takes about 75 minutes at 1536 bits on four CPU threads: 35 to build
the round on the host backend, the rest the phase on the plain versions
of the kernels at n=16, M=256.
"""

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def count_wrappers():
    """Replace each kernel wrapper by a counter with the wrapper's
    `launches` and `shapes` attributes, which `launch_counts()` reads."""
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels

    for mod, names in ((montgomery_kernels, ("mont_mul", "modmul", "modexp_segments", "comb",
                                             "comb_ladder", "multi_modexp",
                                             "shared_exp_segments")),
                       (ec_kernels, ("scalar_mul", "tree_sum"))):
        for name in names:
            raw = getattr(mod, name)

            def counted(*args, _raw=raw, **kwargs):
                counted_by_name[_raw.__name__].launches += 1
                return _raw(*args, **kwargs)

            counted.launches = 0
            counted.shapes = {}
            counted_by_name[raw.__name__] = counted
            setattr(mod, name, counted)


counted_by_name = {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bits", type=int, default=1536)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import torch

    torch.set_num_threads(args.threads)
    import chip_smoke
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.backend import memplan
    from fsdkr_tpu_torch.protocol import JoinMessage, RefreshMessage, simulate_keygen

    chip_smoke.fail = lambda msg: print("FAIL:", msg, flush=True)
    count_wrappers()
    n, t, bits = 16, 8, args.bits
    host = ProtocolConfig(paillier_bits=bits, m_security=256, correct_key_rounds=11,
                          backend="host", device="cpu")
    t0 = time.perf_counter()
    pre = simulate_keygen(t, n, host)
    print(f"keygen {time.perf_counter() - t0:.1f} s", flush=True)

    keys = copy.deepcopy(pre)
    out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], n, host)
    msgs, dks = [m for m, _ in out], [d for _, d in out]
    own = []
    for key, dk in zip(copy.deepcopy(keys), copy.deepcopy(dks)):
        RefreshMessage.collect(msgs, key, dk, config=host)
        own.append(key)
    print(f"round {time.perf_counter() - t0:.1f} s", flush=True)

    removed = (2, n)
    survivors = [k for k in copy.deepcopy(pre) if k.i not in removed]
    old_to_new = dict(zip([k.i for k in survivors], reversed([k.i for k in survivors])))
    joins = []
    for idx in removed:
        join, _pair = JoinMessage.distribute(host)
        join.set_party_index(idx)
        joins.append(join)
    jmsgs, jdks = [], []
    for key in survivors:
        m, d = RefreshMessage.replace(joins, key, old_to_new, n, host)
        jmsgs.append(m)
        jdks.append(d)
    jpre = (copy.deepcopy(survivors[0]), copy.deepcopy(jdks[0]))
    jown = copy.deepcopy(survivors[0])
    RefreshMessage.collect(jmsgs, jown, copy.deepcopy(jdks[0]), joins, config=host)
    print(f"join round {time.perf_counter() - t0:.1f} s", flush=True)

    # chip_smoke's (c) cuts 256 pair rows into tiles of 81 at 2048 bits
    budget = repr(81 * memplan.pair_row_bytes(2 * bits, bits) * 2 / (1 << 20))
    _counts, _shapes, times = chip_smoke.phase_sessions(
        torch.device("cpu"), (msgs, keys, dks), own, (jmsgs, joins, jpre, jown),
        n=n, t=t, bits=bits, tile_budget_mb=budget)
    print("times " + json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
