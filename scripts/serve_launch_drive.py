"""Work out the launches of chip_smoke's serve-phase session on the CPU,
without a card: the pooled distribute (SERVE_DISTRIBUTE).

A session of the serve phase is one pooled `distribute_batch` of 16
senders (the producer filled every pool of the committee first), 256
offers (16 messages into each of 16 receivers' streams: 256 times
STREAM_OFFER, which scripts/stream_launch_drive.py worked out) and one
`finalize_streams` of the 16 streams (their pair rows dedup to one
round's: one pair launch set, STREAM_FINALIZE's, and one pk_vec MSM a
stream). This script measures the part no earlier table gives: it
builds a 16-party committee with the port's host backend, fills its
pools with `precompute.prefill` on the host engines (the pooled values
are the same on any engine, and so is the pooled branch's layout), then
runs the pooled `distribute_batch` on the cuda backend's plain versions
(device="cpu") with every kernel wrapper of `ops.montgomery_kernels` and
`ops.ec_kernels` replaced by a call counter (on the card a wrapper call
is one launch). It prints the counts as a table.

    python3 scripts/serve_launch_drive.py [--bits 2048] [--threads 4]

At 2048 bits (the card's width, so every width bucket and group cap is
the card's) it takes about 10 minutes on four CPU threads, most of it
the committee's keygen and the pools' key bundles.

    python3 scripts/serve_launch_drive.py --ingress [--bits 768] [--n 3]

holds chip_smoke's ingress phase to serve's tables: one journaled
RefreshService on the plain versions (device="cpu"), the wrappers
counted through `ops.tally` (the producer's launches apart), runs one
session in process (`submit`) and one over the TCP ingress (its offers
on the ingress's handler threads, delivered by an IngressClient), and
requires the two sessions' launches to be equal stage by stage
(`chip_smoke.stage_launches`): distribute, offers, finalize. The stages
are the same calls whatever the width, so the card's ingress table is
serve's (SERVE_DISTRIBUTE, n^2 STREAM_OFFER, the finalize set). About 3
minutes at n=3, 768 bits on four threads.
"""

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from sessions_launch_drive import count_wrappers, counted_by_name  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--ingress", action="store_true",
                    help="an ingress session's launches against an in-process one's")
    ap.add_argument("--n", type=int, default=3, help="committee size (--ingress)")
    args = ap.parse_args()
    if args.ingress:
        return ingress_drive(args)

    import torch

    torch.set_num_threads(args.threads)
    from fsdkr_tpu_torch import ProtocolConfig, precompute
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels
    from fsdkr_tpu_torch.protocol import RefreshMessage, simulate_keygen

    n, t, bits = 16, 8, args.bits
    host = ProtocolConfig(paillier_bits=bits, m_security=256, correct_key_rounds=11,
                          backend="host", device="cpu")
    device = ProtocolConfig(paillier_bits=bits, m_security=256, correct_key_rounds=11,
                            backend="cuda", device="cpu")
    t0 = time.perf_counter()
    keys = simulate_keygen(t, n, host)
    print(f"keygen {time.perf_counter() - t0:.1f} s", flush=True)
    produced = precompute.prefill(keys[0], n, n, host)
    print(f"prefill {produced} entries {time.perf_counter() - t0:.1f} s", flush=True)
    if produced != 3 * n * n + n:
        raise SystemExit(f"prefill produced {produced}, expected {3 * n * n + n}")

    count_wrappers()
    precompute.stats_reset()
    RefreshMessage.distribute_batch([(k.i, k) for k in copy.deepcopy(keys)], n, device)
    st = precompute.precompute_stats()
    print(f"pooled distribute {time.perf_counter() - t0:.1f} s; pools {json.dumps(st)}",
          flush=True)
    if st["dry_fallbacks"] or st["consumed"] != 3 * n * n + n:
        raise SystemExit("the distribute did not take every pooled entry")
    names = {"mont_mul": "cios_mont_mul", "modmul": "cios_modmul",
             "modexp_segments": "cios_modexp", "comb": "cios_comb",
             "comb_ladder": "cios_comb_ladder", "multi_modexp": "cios_multi_modexp",
             "shared_exp_segments": "cios_shared_exp", "scalar_mul": "ec_scalar_mul",
             "tree_sum": "ec_tree_sum"}
    table = {names[raw]: fn.launches for raw, fn in counted_by_name.items()}
    assert set(table) == set(montgomery_kernels.launch_counts()) | set(
        ec_kernels.launch_counts())
    print("SERVE_DISTRIBUTE = " + json.dumps(table), flush=True)


def count_through_tally():
    """Replace each kernel wrapper by a counter that counts through
    `ops.tally` (so a thread inside `tally.apart` counts apart, as the
    wrappers do on the card) and then runs the wrapper."""
    from fsdkr_tpu_torch.ops import ec_kernels, montgomery_kernels, tally

    for mod, names in ((montgomery_kernels, ("mont_mul", "modmul", "modexp_segments", "comb",
                                             "comb_ladder", "multi_modexp",
                                             "shared_exp_segments")),
                       (ec_kernels, ("scalar_mul", "tree_sum"))):
        for name in names:
            raw = getattr(mod, name)

            def counted(*args, _raw=raw, **kwargs):
                tally.count(counted_fns[_raw.__name__], ())
                return _raw(*args, **kwargs)

            counted.launches = 0
            counted.shapes = {}
            counted_fns[raw.__name__] = counted
            setattr(mod, name, counted)


counted_fns = {}


def ingress_drive(args):
    import torch

    torch.set_num_threads(args.threads)
    import shutil
    import tempfile

    import chip_smoke
    from fsdkr_tpu_torch import ProtocolConfig, precompute
    from fsdkr_tpu_torch.protocol import simulate_keygen
    from fsdkr_tpu_torch.serving import IngressClient, IngressServer, RefreshService

    n, t = args.n, max(1, (args.n - 1) // 2)
    host = ProtocolConfig(paillier_bits=args.bits, m_security=32, correct_key_rounds=3,
                          backend="host", device="cpu")
    device = ProtocolConfig(paillier_bits=args.bits, m_security=32, correct_key_rounds=3,
                            backend="cuda", device="cpu")
    t0 = time.perf_counter()
    keys = simulate_keygen(t, n, host)
    count_through_tally()
    jdir = tempfile.mkdtemp(prefix="fsdkr_drive_")
    svc = RefreshService(workers=1, journal=jdir, deadline_s=3600, device="cpu")
    svc.admit("A", keys, device)
    svc.start()
    tables = {}
    try:
        for epoch, how in ((1, "in process"), (2, "over the ingress")):
            while precompute.deficit_total():
                time.sleep(0.05)
            stages, verdicts = {}, []
            with chip_smoke.stage_launches(stages, verdicts):
                if epoch == 1:
                    sess = svc.wait(svc.submit("A", epoch=1), 3600)
                    state = sess.state
                else:
                    srv = IngressServer(svc).start()
                    cli = IngressClient("127.0.0.1", srv.port, timeout=3600)
                    try:
                        r = cli.submit("A", epoch=2, timeout=3600)
                        chip_smoke._socket_epoch(cli, r)
                        state = cli.wait(r["sid"], 3600)["state"]
                    finally:
                        cli.close()
                        srv.stop()
            if state != "done" or verdicts != [None] * n:
                raise SystemExit(f"the session {how} ended {state}: {verdicts}")
            tables[how] = {stage: {k: v for k, v in got.items() if v}
                           for stage, got in stages.items()}
            print(f"{how}: {time.perf_counter() - t0:.1f} s; launches by stage "
                  f"{json.dumps(tables[how])}", flush=True)
    finally:
        svc.stop()
        shutil.rmtree(jdir, ignore_errors=True)
    if tables["in process"] != tables["over the ingress"]:
        raise SystemExit("the ingress session's launches differ from the in-process one's")
    offers = tables["over the ingress"]["offers"]
    if any(v % (n * n) for v in offers.values()):
        raise SystemExit(f"the offers' launches {offers} are not n^2 times one offer's")
    print(f"INGRESS == SERVE at n={n}, {args.bits} bits: offers n^2 x "
          f"{json.dumps({k: v // (n * n) for k, v in offers.items()})}", flush=True)


if __name__ == "__main__":
    main()
