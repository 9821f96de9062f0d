"""Work out chip_smoke's stream-phase launch tables (STREAM_OFFER,
STREAM_FINALIZE, STREAM_FUSED) on the CPU, without a card.

Builds the phase's inputs with the port's host backend (a 16-party round
at M=256 and 11 correct-key rounds, and the first four receivers' own
collects), then runs `chip_smoke.phase_stream` on device="cpu" with every
kernel wrapper of `ops.montgomery_kernels` and `ops.ec_kernels` replaced
by a call counter (on the card a wrapper call is one launch; on the CPU
the wrappers run their plain versions and count nothing). chip_smoke's
gates print instead of exiting, so a table that the drive does not meet
prints its (got, expected) pairs and the drive goes on.

At n=16 no streamed call has more than 16 comb groups, so the comb's
group cap (which depends on the exponents' width) cuts nothing at 1024
bits or at the card's 2048.

    python3 scripts/stream_launch_drive.py [--bits 1024] [--threads 4]
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bits", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import torch

    torch.set_num_threads(args.threads)
    import chip_smoke
    from sessions_launch_drive import count_wrappers
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.protocol import RefreshMessage, simulate_keygen

    chip_smoke.fail = lambda msg: print("FAIL:", msg, flush=True)
    count_wrappers()
    n, t, bits = 16, 8, args.bits
    host = ProtocolConfig(paillier_bits=bits, m_security=256, correct_key_rounds=11,
                          backend="host", device="cpu")
    t0 = time.perf_counter()
    keys = simulate_keygen(t, n, host)
    out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], n, host)
    msgs, dks = [m for m, _ in out], [d for _, d in out]
    own = []
    for key, dk in zip(copy.deepcopy(keys[:4]), copy.deepcopy(dks[:4])):
        RefreshMessage.collect(msgs, key, dk, config=host)
        own.append(key)
    print(f"round {time.perf_counter() - t0:.1f} s", flush=True)

    counts, _shapes, times = chip_smoke.phase_stream(
        torch.device("cpu"), (msgs, keys, dks), own, n=n, t=t, bits=bits, reps=1)
    print("counts " + json.dumps(counts), flush=True)
    print("times " + json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
