"""Time one `distribute_batch` on the card by the JAX package's phase
names (chip_smoke.span_distribute, from the port's span tracer), for the
port in this checkout or in another tree: a parent commit unpacked
beside it, so that two trees are compared in one call on the same card.
The other tree needs the tracer (`fsdkr_tpu_torch/telemetry/spans.py`).

    python3 scripts/distribute_spans.py [--tree DIR] [--n 16] [--bits 2048] [--label TEXT]

Builds a committee with simulate_keygen (timed: its prime generation is
the distribute's keygen work twice over), then runs one distribute by
all n senders under the spans, and prints the card's name and power
limit and, last, one JSON line of the keygen, the wall and each phase's
seconds.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="directory holding fsdkr_tpu_torch/")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch finds no CUDA device")
    import fsdkr_tpu_torch
    from fsdkr_tpu_torch import ProtocolConfig
    from fsdkr_tpu_torch.protocol import simulate_keygen

    if os.path.dirname(os.path.dirname(os.path.abspath(fsdkr_tpu_torch.__file__))) != tree:
        chip_smoke.fail(f"fsdkr_tpu_torch came from {fsdkr_tpu_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label or os.path.basename(tree)
    n = args.n
    config = ProtocolConfig(paillier_bits=args.bits, m_security=256, correct_key_rounds=11,
                            backend="cuda", device="cuda")
    t0 = time.perf_counter()
    keys = simulate_keygen(n // 2, n, config)
    keygen = time.perf_counter() - t0
    chip_smoke.log(f"{label}: simulate_keygen n={n}: {keygen:.3f} s")
    _, wall, phases, _ = chip_smoke.span_distribute([(k.i, k) for k in keys], n, config, label)
    chip_smoke.log(chip_smoke.smi_line())
    print(json.dumps({"label": label, "keygen_s": keygen, "distribute_s": wall,
                      "phases": phases}), flush=True)


if __name__ == "__main__":
    main()
