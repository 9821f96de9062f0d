"""The port's serving failure semantics (fsdkr_tpu_torch/serving/faults.py
and service.py) against the JAX package's, n=3, host backends.

- SITES: every fault site the port wires into the service, pool store,
  memory plan and journal gives the JAX package's terminal state, blame
  flag, error class, stamped faults and retry count for the same plan.
- The plan: parsing, canonical spec, seed determinism and caps, as the
  JAX package's; the env is never read.
- Worker-crash isolation and respawn, finalize retries and their
  exhaustion (no blame), repeated finalize bit identity, the deadline
  reaper naming missing senders, epoch idempotency, wait() timeouts,
  overload shedding and the bisection guard.

No healthy session here is held to a wall deadline: sessions that must
time out run with a deadline of their own, and the healthy sessions
beside them with none or with minutes.
"""

import copy
import dataclasses

import pytest

from fsdkr_tpu import precompute as j_precompute
from fsdkr_tpu import serving as j_serving
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.serving import faults as j_faults

from fsdkr_tpu_torch import TEST_CONFIG, precompute, serving
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.protocol import RefreshMessage, finalize_streams
from fsdkr_tpu_torch.serving import faults, metrics
from fsdkr_tpu_torch.telemetry import registry

HOST = dataclasses.replace(TEST_CONFIG, backend="host")
PKG = {"port": (serving, faults), "jax": (j_serving, j_faults)}


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, j_faults):
        f.reset()
    yield
    for f in (faults, j_faults):
        f.reset()
    for pc in (precompute, j_precompute):
        pc.clear_pools()
        pc.clear_targets()


@pytest.fixture(scope="module")
def committee():
    return jax_keygen(1, 3, JAX_CONFIG)


def _service(pkg, committee, **kw):
    mod, _ = PKG[pkg]
    kw.setdefault("policy", mod.BatchPolicy(max_sessions=6, linger_s=0.02))
    kw.setdefault("backoff_s", 0.01)
    if pkg == "port":
        kw["device"] = "cpu"
        keys, config = from_reference(committee), HOST
    else:
        keys, config = copy.deepcopy(committee), JAX_CONFIG
    svc = mod.RefreshService(**kw)
    # one epoch of key material ahead: the port's producer makes no more
    svc.admit("com", keys, config, mod.SLO(arrival_rate_hz=0.01))
    return svc


def _outcome(s):
    err = s.error.split(":")[0] if s.error else None
    missing = s.error[s.error.index("missing"):] if s.error and "missing" in s.error else None
    return s.state, s.blame, err, missing, sorted(s.faults), s.retries


# (fault spec, service kwargs, expected (state, blame))
SITES = {
    "worker_crash": ("seed=4,worker_crash=1.0", {"retries": 0}, ("aborted", False)),
    "worker_crash_retried": ("seed=5,worker_crash=1.0,worker_crash_max=1", {"retries": 2},
                             ("done", False)),
    "finalize_exc_retried": ("seed=6,finalize_exc=1.0,finalize_exc_max=1", {"retries": 2},
                             ("done", False)),
    "finalize_exc_exhausted": ("seed=7,finalize_exc=1.0", {"retries": 1}, ("aborted", False)),
    "pool_dry": ("seed=2,pool_dry=1.0", {}, ("done", False)),
    "msg_delay": ("seed=9,msg_delay=1.0,msg_delay_max=1,delay_s=0.3", {"deadline_s": 600.0},
                  ("done", False)),
    "msg_drop": ("seed=8,msg_drop=1.0", {"retries": 0}, ("timed_out", False)),
    "msg_drop_and_delay": ("seed=13,msg_drop=1.0,msg_drop_max=1,msg_delay=1.0,"
                           "msg_delay_max=1,delay_s=0.2", {"retries": 0}, ("timed_out", False)),
    "msg_dup": ("seed=11,msg_dup=1.0", {}, ("done", False)),
    "msg_tamper": ("seed=10,msg_tamper=1.0,msg_tamper_max=1", {"retries": 2}, ("aborted", True)),
    "mem_squeeze": ("seed=3,mem_squeeze=1.0,squeeze_factor=0.25", {}, ("done", False)),
    "journal_torn_write": ("seed=5,journal_torn_write=1.0,journal_torn_write_max=1", {},
                           ("done", False)),
}


@pytest.mark.parametrize("site", list(SITES))
def test_fault_site_gives_the_jax_packages_outcome(committee, site, tmp_path):
    spec, kw, want = SITES[site]
    out = {}
    for pkg in ("jax", "port"):
        mod, fmod = PKG[pkg]
        svc_kw = dict(kw)
        if site == "journal_torn_write":
            svc_kw["journal"] = str(tmp_path / pkg)
        svc = _service(pkg, committee, **svc_kw)
        svc.start()
        try:
            plan = fmod.configure(spec)
            s = svc.wait(svc.submit("com"), timeout=600)
            fmod.reset()
            assert svc.drain(timeout=600)
            out[pkg] = (_outcome(s), sorted(k for k, v in plan.injected().items() if v))
            if site in ("worker_crash", "worker_crash_retried"):
                assert svc.stats()["workers_respawned"] >= 1
            if site in ("worker_crash", "msg_drop"):
                # the committee is not wedged: a healthy session completes
                assert svc.wait(svc.submit("com"), timeout=600).state == "done"
        finally:
            fmod.reset()
            svc.stop()
    assert out["port"][0][:2] == want
    assert out["port"] == out["jax"]


def test_injected_dry_is_labeled_and_keeps_the_entry():
    from fsdkr_tpu_torch.precompute import pools

    dry = registry.counter("fsdkr_pool_dry", labelnames=("kind", "cause"))
    inj0, real0 = dry.value(kind="enc", cause="injected"), dry.value(kind="enc", cause="real")
    assert pools.put("enc", 31337, (5, 25))
    faults.configure("seed=2,pool_dry=1.0")
    assert pools.take("enc", 31337) is None  # starved, the entry kept
    assert dry.value(kind="enc", cause="injected") == inj0 + 1
    faults.reset()
    assert pools.take("enc", 31337) == (5, 25)
    assert pools.take("enc", 31337) is None
    assert dry.value(kind="enc", cause="real") == real0 + 1


def test_mem_squeeze_budget(monkeypatch):
    from fsdkr_tpu_torch.backend import memplan

    monkeypatch.delenv("FSDKRC_MEM_BUDGET_MB", raising=False)
    full = memplan.mem_budget_bytes()
    faults.configure("seed=3,mem_squeeze=1.0,squeeze_factor=0.25")
    assert memplan.mem_budget_bytes() == full // 4
    faults.reset()
    assert memplan.mem_budget_bytes() == full


def test_fault_plan_parse_determinism_and_caps(monkeypatch):
    spec = "seed=42,msg_tamper=0.5,worker_crash=0.25,msg_drop_max=2,delay_s=0.5"
    ours, theirs = faults.FaultPlan.parse(spec), j_faults.FaultPlan.parse(spec)
    assert ours.spec() == theirs.spec()
    keys = [(sid, pid) for sid in range(40) for pid in range(1, 4)]
    assert [ours._roll("msg_tamper", k) for k in keys] == \
        [theirs._roll("msg_tamper", k) for k in keys]
    capped = faults.FaultPlan.parse("seed=1,msg_drop=1.0,msg_drop_max=2")
    assert [capped.fire("msg_drop", (i,)) for i in range(4)] == [True, True, False, False]
    assert capped.injected() == {"msg_drop": 2}
    for bad in ("seed=1,msg_tampr=0.5", "nonsense"):
        with pytest.raises(ValueError):
            faults.FaultPlan.parse(bad)
    # the port reads no environment: only configure() installs a plan
    monkeypatch.setenv("FSDKR_FAULTS", "seed=1,worker_crash=1.0")
    assert faults.active() is None
    assert faults.configure(spec) is faults.active()
    faults.reset()
    assert faults.active() is None
    # every site of the JAX package parses, the network ones included
    assert faults.SITES == j_faults.SITES


def test_repeated_finalize_bit_identity(committee):
    """A finalize attempt that dies before the launch leaves the streams
    re-finalizable; the retry adopts what barrier collect adopts, and a
    further finalize replays the verdict without adopting again."""
    keys = from_reference(committee)
    res = RefreshMessage.distribute_batch([(k.i, k) for k in keys], 3, HOST)
    msgs = [m for m, _ in res]
    kb, ks = copy.deepcopy(keys[0]), copy.deepcopy(keys[0])
    RefreshMessage.collect(msgs, kb, copy.deepcopy(res[0][1]), (), HOST)
    st = RefreshMessage.collect_stream(ks, res[0][1], [m.party_index for m in msgs], (), HOST)
    for m in msgs:
        assert st.offer(m) == "accepted"
    assert finalize_streams([st], HOST) == [None]
    assert to_fields(ks) == to_fields(kb)
    assert finalize_streams([st], HOST) == [None]
    assert to_fields(ks) == to_fields(kb)


def test_deadline_reaper_names_missing_senders_and_frees_the_committee(committee):
    """Every broadcast dropped: the reaper times the session out at its
    deadline, naming the missing senders, and the committee serves the
    next session. Only the dropped session has a short deadline."""
    svc = _service("port", committee, retries=0, deadline_s=0.5)
    svc.start()
    try:
        faults.configure("seed=8,msg_drop=1.0")
        s = svc.wait(svc.submit("com"), timeout=600)
        faults.reset()
        assert s.state == "timed_out" and not s.blame
        assert "missing senders [1, 2, 3]" in s.error
        assert svc.stats()["sessions_timed_out"] == 1
        svc.deadline_s = 600.0  # the healthy session's: minutes
        assert svc.wait(svc.submit("com"), timeout=600).state == "done"
    finally:
        faults.reset()
        svc.stop()


def test_epoch_idempotency_and_retry_after_failure(committee):
    svc = _service("port", committee, retries=0)
    svc.start()
    try:
        sid = svc.submit("com", epoch=0)
        assert svc.submit("com", epoch=0) == sid  # in flight: deduped
        assert svc.wait(sid, timeout=600).state == "done"
        assert svc.submit("com", epoch=0) == sid  # finished: deduped
        faults.configure("seed=12,msg_drop=1.0")
        sid1 = svc.submit("com", epoch=1)
        assert svc.wait(sid1, timeout=600).state == "timed_out"
        faults.reset()
        sid1b = svc.submit("com", epoch=1)  # a failed epoch runs again
        assert sid1b != sid1 and svc.wait(sid1b, timeout=600).state == "done"
        assert svc.submit("com", epoch=1) == sid1b
        assert svc.stats()["sessions_done"] == 2
    finally:
        faults.reset()
        svc.stop()


def test_wait_timeout_overload_and_bisect_guard(committee):
    svc = _service("port", committee, overload=serving.OverloadPolicy(max_queue=1))
    sid = svc.submit("com")  # never started: stays pooled
    with pytest.raises(TimeoutError, match="pooled"):
        svc.wait(sid, timeout=0.05)
    with pytest.raises(KeyError):
        svc.wait(999999, timeout=0)
    r0 = metrics.sessions_counter().value(outcome="rejected")
    with pytest.raises(serving.ServeRejected) as ei:
        svc.submit("com")  # queue depth 1 >= max_queue: shed
    assert ei.value.retry_after_s > 0 and ei.value.reason == "overload"
    assert svc.stats()["sessions_rejected"] == 1
    assert metrics.sessions_counter().value(outcome="rejected") == r0 + 1
    svc.stop()

    g, jg = serving.BisectGuard(budget=2, window_s=1.0), j_serving.BisectGuard(2, 1.0)
    for guard in (g, jg):
        guard.charge("c", 3, now=100.0)
    for now in (100.1, 101.2):
        assert g.blocked("c", now=now) == jg.blocked("c", now=now)
    assert g.blocked("other", now=100.1) is None
    svc = _service("port", committee, guard=serving.BisectGuard(budget=1, window_s=60.0))
    svc.guard.charge("com", 5)
    with pytest.raises(serving.ServeRejected) as ei:
        svc.submit("com")
    assert ei.value.reason == "bisection budget exhausted"
    svc.stop()


def test_batch_policy_is_the_jax_packages():
    ours = serving.BatchPolicy(max_sessions=16, linger_s=0.05, devices=4)
    theirs = j_serving.BatchPolicy(max_sessions=16, linger_s=0.05, devices=4)
    for ready, wait, rows in ((0, 1.0, 0), (3, 0.01, 27), (3, 0.06, 27), (20, 0.0, 27),
                              (7, 1.0, 6), (16, 0.0, 256)):
        assert ours.take(ready, wait, rows) == theirs.take(ready, wait, rows)
    assert ours.wait_budget(0.01) == theirs.wait_budget(0.01)
