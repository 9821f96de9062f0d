"""The port's shard supervisor (fsdkr_tpu_torch/serving/supervisor.py):
real shard processes of the port (`python -m
fsdkr_tpu_torch.serving.supervisor --shard`), a real SIGKILL through
the `shard_kill` fault site, journal replay on the peer.

- `shard_for` is the JAX package's partition.
- tests/test_supervisor.py's kill, failover, replay and resume scenario
  on two port shards with device="cpu" and backend "host": every
  interrupted epoch and the control done without blame, at least one
  across the failover, the dead shard's flight dump beside its journal,
  the journals' accounting of every accepted broadcast.
- A shard whose precompute producer raises reports a fault: the
  supervisor records it, SIGKILLs and reaps the shard, and only then
  hands its journal to the peer.
- ingress=True: each shard serves a TCP ingress; the shard that does not
  own a committee redirects to the JAX package's fingerprint owner; a
  socket epoch on the owner; a shard whose heartbeat stops (SIGSTOP) is
  SIGKILLed before its failover, the survivor's port map shrinks to the
  living, and the moved committee's next socket epoch runs there.
- A shard spawned on device "cuda" where torch finds no card fails its
  start, and the supervisor raises.
"""

import dataclasses
import json
import os
import signal
import sys
import time

import pytest

from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.serving.supervisor import shard_for as j_shard_for

from fsdkr_tpu_torch import TEST_CONFIG
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.serving import faults
from fsdkr_tpu_torch.serving.ingress import IngressClient
from fsdkr_tpu_torch.serving.supervisor import ShardSupervisor, shard_for

HOST = dataclasses.replace(TEST_CONFIG, backend="host")


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_for_is_the_jax_packages_partition(shards):
    ids = [f"c{i}" for i in range(46)] + list(range(8)) + [["a", 1], {"k": 2}] + [
        None, 3.5, "com0", "", "é", True, [1, [2]], {"b": [1], "a": 0}]
    assert len(ids) == 64
    got = [shard_for(cid, shards) for cid in ids]
    assert got == [j_shard_for(cid, shards) for cid in ids]
    assert set(got) == set(range(shards))


def _one_per_shard(n_shards):
    cids, want, i = [], set(range(n_shards)), 0
    while want:
        cid = f"com{i}"
        if shard_for(cid, n_shards) in want:
            want.discard(shard_for(cid, n_shards))
            cids.append(cid)
        i += 1
    return cids


def test_kill_failover_replay_and_resume(tmp_path):
    from fsdkr_tpu_torch.serving import recovery

    keys = from_reference(jax_keygen(1, 3, JAX_CONFIG))
    sup = ShardSupervisor(shards=2, root=tmp_path, deadline_s=120.0, hb_interval=0.4,
                          device="cpu")
    sup.start()
    try:
        assert {h.device for h in sup.shards} == {"cpu"}
        assert all(h.startup["spawn_to_ready_s"] > 0 for h in sup.shards)
        cids = _one_per_shard(2)
        for cid in cids:
            sup.admit(cid, keys, HOST)
        # epoch 0 everywhere: the healthy baseline AND the terminal
        # records the failover replay must restore
        for cid in cids:
            sup.submit(cid, 0)
        assert sup.drain(120), f"epoch 0 wedged: {sup.pending}"
        assert all(o["state"] == "done" for o in sup.outcomes), sup.outcomes

        victim_cid, bystander_cid = cids
        victim_shard = sup.assignment[victim_cid]
        # three epochs queued on the victim committee (one in flight a
        # committee), so the SIGKILL lands with work still pending
        for e in (1, 2, 3):
            sup.submit(victim_cid, e)
        sup.submit(bystander_cid, 1)  # the uninterrupted control
        time.sleep(0.3)  # mid-session
        faults.configure("seed=1,shard_kill=1.0,shard_kill_max=1")
        try:
            assert sup.chaos_kill(0.3, victim_shard) == victim_shard
            assert sup.chaos_kill(0.6, victim_shard) is None  # the cap is spent
        finally:
            faults.reset()
        assert sup.drain(180), f"post-kill wedge: {sup.pending}"

        by_epoch = {(o["cid"], o["epoch"]): o for o in sup.outcomes}
        control = by_epoch[(bystander_cid, 1)]
        assert control["state"] == "done" and not control["blame"]
        vias = set()
        for e in (1, 2, 3):
            recovered = by_epoch[(victim_cid, e)]
            assert recovered["state"] == "done" and not recovered["blame"], recovered
            vias.add(recovered["via"])
        assert vias & {"failover", "resubmit"}, vias

        agg = sup.aggregate()
        assert agg["kills"] == 1 and agg["alive"] == 1 and len(agg["failovers"]) == 1
        fo = agg["failovers"][0]
        assert fo["dead"] == victim_shard and fo["moved"] == [victim_cid]
        assert fo["mttr_s"] is not None and fo["mttr_s"] > 0
        rec = fo["recovery"]
        assert rec["replayed_terminal"] >= 1
        assert rec["skipped"] == 0
        # the dead shard's postmortem sits beside its journal
        assert fo["flight_dump"] == str(tmp_path / f"shard{victim_shard:02d}" / "flight.json")
        flight = json.loads(open(fo["flight_dump"]).read())
        assert flight["schema"] == "fsdkr-flight/1" and flight["reason"] == "heartbeat"
        assert flight["events"], "dead shard's flight ring empty"
        assert agg["journal"]["records"] > 0
        assert agg["serving"]["sessions_done"] >= 5
        # zero lost accepted broadcasts: every session that accepted a
        # broadcast has a terminal record or was settled by the replay
        sessions, _coms = recovery.load_state(fo["journal_dir"])
        settled = rec["replayed_terminal"] + rec["resumed"] + rec["aborted_transient"]
        assert settled == len(sessions), (rec, len(sessions))
    finally:
        sup.stop()
    assert all(h.proc.returncode is not None for h in sup.shards)


# a shard child whose precompute producer raises at its first step
_FAULTY_PRODUCER = """
import sys
from fsdkr_tpu_torch.precompute import producer

def _step():
    raise RuntimeError("injected producer fault")

producer._step = _step
from fsdkr_tpu_torch.serving.supervisor import main
sys.exit(main(sys.argv[1:]))
"""


class _FaultyShard0(ShardSupervisor):
    def _child_cmd(self, idx):
        if idx == 0:
            return [sys.executable, "-c", _FAULTY_PRODUCER]
        return super()._child_cmd(idx)


def _until(pred, timeout, what, sup=None):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = pred()
        if got:
            return got
        if sup is not None:
            sup.pump(0.1)
        else:
            time.sleep(0.1)
    raise AssertionError(f"{what} not within {timeout} s")


def test_a_producer_fault_fails_the_shard_over_once_it_is_dead(tmp_path):
    keys = from_reference(jax_keygen(1, 3, JAX_CONFIG))
    sup = _FaultyShard0(shards=2, root=tmp_path, deadline_s=120.0, hb_interval=0.3,
                        device="cpu")
    sup.start()
    try:
        cid = next(c for c in _one_per_shard(2) if shard_for(c, 2) == 0)
        sup.admit(cid, keys, HOST)
        sup.submit(cid, 0)  # its distribute kicks the producer
        _until(lambda: sup.failovers, 60, "the fault's failover", sup)
        detail = "RuntimeError: injected producer fault"
        assert sup.errors == [{"shard": 0, "cmd": None, "detail": detail}]
        assert sup.shards[0].fault == detail
        fo = sup.failovers[0]
        assert (fo["dead"], fo["peer"], fo["moved"]) == (0, 1, [cid])
        assert fo["cause"] == f"fault: {detail}"
        # reaped before the peer was handed the journal: SIGKILLed, not a
        # process still writing it
        assert fo["exit_code"] == -signal.SIGKILL
        sup.submit(cid, 1)
        assert sup.drain(120), f"wedged after the fault: {sup.pending}"
        by_epoch = {o["epoch"]: o for o in sup.outcomes}
        assert all((by_epoch[e]["state"], by_epoch[e]["blame"]) == ("done", False)
                   for e in (0, 1)), sup.outcomes
        assert by_epoch[1]["shard"] == 1
        agg = sup.aggregate()
        assert agg["errors"] == sup.errors and agg["alive"] == 1 and agg["kills"] == 0
    finally:
        sup.stop()
    assert all(h.proc.returncode is not None for h in sup.shards)


def _socket_epoch(port, cid, epoch):
    cli = IngressClient("127.0.0.1", port, timeout=120)
    try:
        def submitted():
            r = cli.submit(cid, epoch=epoch, timeout=120)
            return None if r["type"] == "redirect" else r

        # a shard redirects until it has processed the committee's admit
        r = _until(submitted, 30, "the shard's admit")
        assert r["type"] == "submitted", r
        bcasts = r.get("broadcasts")
        if bcasts is None:
            bcasts = cli.fetch(r["sid"])["broadcasts"]
        for _snd, wire in bcasts:
            assert cli.broadcast(r["sid"], wire)["type"] != "error"
        return cli.wait(r["sid"], 120)
    finally:
        cli.close()


def _redirect(port, cid):
    cli = IngressClient("127.0.0.1", port, timeout=30)
    try:
        r = cli.submit(cid, epoch=0, timeout=30)
    finally:
        cli.close()
    return {k: r.get(k) for k in ("type", "ports", "hint")}


def test_ingress_fleet_redirects_and_a_stale_shard_is_killed_before_failover(tmp_path):
    keys = from_reference(jax_keygen(1, 3, JAX_CONFIG))
    sup = ShardSupervisor(shards=2, root=tmp_path, deadline_s=120.0, hb_interval=0.3,
                          hb_timeout=3.0, ingress=True, device="cpu")
    sup.start()
    try:
        ports = sup.ingress_ports()
        assert sorted(ports) == [0, 1] and all(ports.values())
        cid, other_cid = _one_per_shard(2)
        owner = j_shard_for(cid, 2)
        peer = 1 - owner
        sup.admit(cid, keys, HOST)
        assert sup.assignment[cid] == owner
        # the shard that does not own the committee names the fleet's
        # ports and the JAX package's fingerprint owner
        want = {"type": "redirect", "ports": {str(i): p for i, p in ports.items()},
                "hint": ports[owner]}
        _until(lambda: _redirect(ports[peer], cid) == want, 20, "the redirect")
        term = _socket_epoch(ports[owner], cid, 0)
        assert (term["type"], term["state"], term["blame"]) == ("terminal", "done", False)
        _until(lambda: sup.shards[owner].last_ingress.get("frames", {}).get("in"), 10,
               "the owner's ingress counters in a heartbeat", sup)

        # the owner stops beating but lives: killed before its failover
        os.kill(sup.shards[owner].proc.pid, signal.SIGSTOP)
        _until(lambda: sup.failovers, 30, "the stale shard's failover", sup)
        fo = sup.failovers[0]
        assert (fo["dead"], fo["peer"], fo["cause"]) == (owner, peer, "stale heartbeat")
        assert fo["exit_code"] == -signal.SIGKILL
        assert sup.ingress_ports() == {peer: ports[peer]}
        # the survivor's port map holds the living alone: a committee
        # fingerprinted to the dead shard gets no hint
        unowned = next(f"x{i}" for i in range(64) if j_shard_for(f"x{i}", 2) == owner)
        _until(lambda: _redirect(ports[peer], unowned) == {
            "type": "redirect", "ports": {str(peer): ports[peer]}, "hint": None},
            20, "the survivor's port map")
        _until(lambda: "recovery" in fo, 30, "the peer's replay", sup)
        assert fo["recovery"]["replayed_terminal"] == 1
        term = _socket_epoch(ports[peer], cid, 1)
        assert (term["type"], term["state"], term["blame"]) == ("terminal", "done", False)
        assert other_cid not in sup.assignment
        agg = sup.aggregate()
        assert agg["errors"] == [] and agg["ingress"]["frames"]["in"] > 0
    finally:
        sup.stop()
    assert all(h.proc.returncode is not None for h in sup.shards)


def test_cuda_shards_without_a_card_make_the_supervisor_raise(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sup = ShardSupervisor(shards=1, root=tmp_path, spawn_timeout=120.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sup.start()
    assert time.monotonic() - t0 < 110  # the failed start, not the timeout
    assert all(h.proc.poll() is not None for h in sup.shards)
    # nothing reached the protocol but the failure: no stray stdout
    assert "Traceback" not in (tmp_path / "shard00" / "stderr.log").read_text()
