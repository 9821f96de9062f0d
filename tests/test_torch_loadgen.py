"""The port's load generator (fsdkr_tpu_torch/serving/loadgen.py) on
device="cpu" shards at a small width, against the JAX package's.

- The storms' kill schedule: `faults.configure("seed=S,shard_kill=1.0,
  shard_kill_max=k")` fires on the same window ticks in both packages.
- One `--net` storm with one kill (3 shards, host backend, 640-bit, a
  few seconds' window, one wire-protocol client process, the deadline
  set to 4 times the seed epoch's p99): its gates hold, every shard ran
  on the CPU, and the JAX package's
  `recovery.load_state` reads the storm's journals to the port's
  sessions, broadcasts and terminal records.
"""

import json
import pathlib

import pytest

from fsdkr_tpu.serving import faults as jfaults
from fsdkr_tpu.serving import recovery as jrecovery

from fsdkr_tpu_torch.serving import faults, loadgen, recovery


@pytest.mark.parametrize("seed,kills,window", [(1, 3, 60.0), (7, 1, 6.0), (23, 5, 45.0)])
def test_shard_kill_fires_on_the_jax_packages_ticks(seed, kills, window):
    spec = f"seed={seed},shard_kill=1.0,shard_kill_max={kills}"
    # the storm's evenly spaced ticks, then more than the cap allows
    ticks = [(i + 1) * window / (kills + 1) for i in range(kills + 3)]
    fired = []
    for mod in (jfaults, faults):
        plan = mod.configure(spec)
        try:
            fired.append([plan.fire("shard_kill", (round(t, 3),)) for t in ticks])
            fired[-1].append(plan.injected())
        finally:
            mod.reset()
    assert fired[1] == fired[0]
    assert fired[1][:kills] == [True] * kills and not any(fired[1][kills:-1])


def test_net_storm_with_a_kill_holds_its_gates(tmp_path):
    root = tmp_path / "journals"
    args = loadgen.parse_args([
        "--net", "--kills", "1", "--shards", "3", "--committees", "3", "--bases", "1",
        "--device", "cpu", "--backend", "host", "--window", "6", "--rate", "1.5",
        "--clients", "1", "--baseline-window", "2", "--seed", "3", "--deadline", "60",
        "--deadline-factor", "4",
        "--journal-root", str(root), "--out", str(tmp_path / "net_storm.json"),
        "--trace", str(tmp_path / "trace.json"),
    ])
    report = loadgen.run_net_storm(args)
    assert report["gates"] == dict.fromkeys(report["gates"], True), report["gates"]
    assert report["platform"] == "cpu-shards-tcp" and report["shard_devices"] == ["cpu"]
    # the deadline after the seed epoch: 4 times its p99, on every shard
    assert report["deadline_s"] == round(4 * report["seed_p99_s"], 3) < 60
    assert report["kills_injected"] == 1 and len(report["failovers"]) == 1
    assert report["failovers"][0]["recover_s"] > 0
    done = report["outcomes"]["done_clean"] + report["outcomes"]["recovered"]
    assert done >= 1 and report["epochs_submitted"] >= done
    assert (tmp_path / "net_storm.json").exists() and (tmp_path / "trace.json").exists()
    # the survivors' traces (a SIGKILLed shard leaves none)
    traces = report["shard_traces"]
    assert 1 <= len(traces["paths"]) <= 2
    for path in traces["paths"]:
        assert pathlib.Path(path).parent == tmp_path
        trace = json.loads(pathlib.Path(path).read_text())
        assert trace["otherData"]["spans_dropped"] == 0
    assert traces["phase_seconds"]["collect.stream.offer"] > 0

    audited = 0
    for shard_dir in sorted(pathlib.Path(root).glob("shard*")):
        port_sessions, port_coms = recovery.load_state(shard_dir)
        jax_sessions, jax_coms = jrecovery.load_state(shard_dir)
        assert list(port_sessions) == list(jax_sessions)
        assert sorted(map(str, port_coms)) == sorted(map(str, jax_coms))
        for sid, js in port_sessions.items():
            ref = jax_sessions[sid]
            assert (js.cid, js.epoch, js.expected, js.broadcasts, js.terminal) == \
                (ref.cid, ref.epoch, ref.expected, ref.broadcasts, ref.terminal)
        audited += len(port_sessions)
    assert audited == report["journal_audit"]["sessions"] > 0
