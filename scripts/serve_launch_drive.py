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
    args = ap.parse_args()

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


if __name__ == "__main__":
    main()
