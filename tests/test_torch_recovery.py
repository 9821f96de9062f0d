"""The port's crash recovery (fsdkr_tpu_torch/serving/recovery.py)
against the JAX package's, on one journal (n=3, host backends).

The JAX package's RefreshService writes the journal: epoch 0 done,
epoch 1 aborted by a tampered broadcast, epoch 2 killed between quorum
and finalize (the launcher lingering 'forever'). Copies of it are
replayed by both packages' `recover()`, each into a fresh service with
a keystore holding the same secrets (the port's carried over): the
reports are equal — terminal replays, the resumed in-flight session,
the broadcasts replayed — and the resumed session finalizes to the same
verdict and the same adopted LocalKeys. Without a keystore the
in-flight session aborts transient (no blame) in both, and the epoch
resubmits. A same-directory restart does not re-journal replayed
terminals.
"""

import copy
import dataclasses
import shutil
import time

import pytest

from fsdkr_tpu import precompute as j_precompute
from fsdkr_tpu import serving as j_serving
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.serving import faults as j_faults

from fsdkr_tpu_torch import TEST_CONFIG, precompute, serving
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.serving import faults
from fsdkr_tpu_torch.serving.journal import read_records

HOST = dataclasses.replace(TEST_CONFIG, backend="host")
TAMPER = "seed=21,msg_tamper=1.0,msg_tamper_max=1"


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, j_faults):
        mod.reset()
    yield
    for mod in (faults, j_faults):
        mod.reset()
    for pc in (precompute, j_precompute):
        pc.clear_pools()
        pc.clear_targets()


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    """(journal dir, JAX keystore, in-flight sid) after the JAX service's
    three epochs, the last one abandoned at quorum."""
    jdir = tmp_path_factory.mktemp("wal") / "j"
    ks = j_serving.MemoryKeystore()
    svc = j_serving.RefreshService(
        journal=str(jdir), keystore=ks, workers=1,
        policy=j_serving.BatchPolicy(max_sessions=3, linger_s=0.0))
    svc.admit("com", jax_keygen(1, 3, JAX_CONFIG), JAX_CONFIG)
    svc.start()
    try:
        assert svc.wait(svc.submit("com", epoch=0), timeout=600).state == "done"
        j_faults.configure(TAMPER)
        assert svc.wait(svc.submit("com", epoch=1), timeout=600).state == "aborted"
        j_faults.reset()
        # the launcher lingers from here on: epoch 2 stops at quorum
        svc.policy.max_sessions, svc.policy.linger_s = 10 ** 6, 3600.0
        sid = svc.submit("com", epoch=2)
        end = time.monotonic() + 600
        while True:
            with svc._lock:
                if svc._ready:
                    break
            assert time.monotonic() < end, "epoch 2 never reached quorum"
            time.sleep(0.02)
    finally:
        j_faults.reset()
        svc.stop(timeout=10)
    return jdir, ks, sid


def _replay(pkg, jdir, keys, dks, sid, with_keystore=True):
    """recover() into a fresh `pkg` service; returns (report without its
    directory, the service, the committee's live keys)."""
    mod = serving if pkg == "port" else j_serving
    kw = {"device": "cpu"} if pkg == "port" else {}
    ks = None
    if with_keystore:
        ks = mod.MemoryKeystore()
        ks.put_committee("com", keys)
        ks.put_session_dks("com", sid, dks)
        svc = mod.RefreshService(journal=str(jdir), keystore=ks, workers=1, **kw)
    else:
        svc = mod.RefreshService(workers=1, **kw)
        svc.admit("com", keys, HOST if pkg == "port" else JAX_CONFIG)
    svc.start()
    rep = mod.recover(svc, jdir, ks)
    rep.pop("journal_dir")
    return rep, svc, keys


def test_report_resume_verdict_and_keys_match_jax(crashed, tmp_path):
    src, ks, sid = crashed
    jkeys = copy.deepcopy(ks.committee_keys("com"))
    jdks = copy.deepcopy(ks.session_dks("com", sid))
    out = {}
    for pkg, keys, dks in (("jax", jkeys, jdks),
                           ("port", from_reference(jkeys), from_reference(jdks))):
        jdir = tmp_path / pkg
        shutil.copytree(src, jdir)
        rep, svc, live = _replay(pkg, jdir, keys, dks, sid)
        try:
            new_sid = rep["sessions"][sid]["sid"]
            assert svc.drain(timeout=600)
            s = svc.wait(new_sid, timeout=1)
            verdict = (s.state, s.blame, s.error)
        finally:
            svc.stop()
        # a second incarnation of the same directory replays every
        # session as a terminal and resumes nothing
        mod = serving if pkg == "port" else j_serving
        kw = {"device": "cpu"} if pkg == "port" else {}
        svc3 = mod.RefreshService(journal=str(jdir), keystore=svc.keystore, **kw)
        again = mod.recover(svc3, jdir, svc.keystore)
        svc3.stop()
        again.pop("journal_dir")
        terminals = [r for r in read_records(jdir) if r["t"] == "terminal" and r["epoch"] == 0]
        out[pkg] = (rep, verdict, [to_fields(from_reference(k) if pkg == "jax" else k)
                                   for k in live], again, len(terminals))
    rep, verdict, keys, again, terminals = out["port"]
    assert rep["replayed_terminal"] == 2 and rep["resumed"] == 1
    assert rep["broadcasts_replayed"] == 3 and rep["committees_admitted"] == 1
    assert rep["sessions"][sid]["disposition"] == "resumed"
    assert verdict == ("done", False, None)
    assert again["resumed"] == 0 and again["aborted_transient"] == 0
    assert terminals == 1  # a replayed terminal is not journaled again
    assert out["port"] == out["jax"]


def test_without_a_keystore_the_session_aborts_transient_like_jax(crashed, tmp_path):
    src, ks, sid = crashed
    jkeys = copy.deepcopy(ks.committee_keys("com"))
    out = {}
    for pkg, keys in (("jax", jkeys), ("port", from_reference(jkeys))):
        jdir = tmp_path / pkg
        shutil.copytree(src, jdir)
        rep, svc, _ = _replay(pkg, jdir, keys, None, sid, with_keystore=False)
        try:
            new_sid = rep["sessions"][sid]["sid"]
            s = svc.wait(new_sid, timeout=1)
            # retryable: the epoch resubmits as a fresh session
            assert svc.submit("com", epoch=2) != new_sid
            assert svc.drain(timeout=600)
            out[pkg] = (rep, s.state, s.blame, s.error.split(":")[0], svc.stats()["sessions_done"])
        finally:
            svc.stop()
    rep, state, blame, err, done = out["port"]
    assert rep["aborted_transient"] == 1 and rep["replayed_terminal"] == 2
    assert (state, blame, err, done) == ("aborted", False, "RecoverySecretsUnavailable", 1)
    assert out["port"] == out["jax"]


def test_missing_or_empty_journal_is_a_no_op(tmp_path):
    svc = serving.RefreshService(journal=str(tmp_path / "live"), device="cpu")
    for d in (tmp_path / "nonexistent", tmp_path / "empty"):
        if d.name == "empty":
            d.mkdir()
        rep = serving.recover(svc, d)
        assert rep["resumed"] == rep["replayed_terminal"] == rep["skipped"] == 0
    assert svc.stats()["inflight"] == 0
    svc.stop()
