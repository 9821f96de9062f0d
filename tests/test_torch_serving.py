"""The port's RefreshService (fsdkr_tpu_torch/serving) against the JAX
package's, at TEST_CONFIG widths.

- BYTES: one committee (n=3), one worker, two honest epochs and one
  tampered epoch (`msg_tamper`, fired once) on the JAX package's
  RefreshService and on the port's at backend "host", both with the
  shared deterministic samplers (tests/_torch_samplers.py): the journal
  segments are identical byte for byte; so are the terminal states,
  blame, error texts, the adopted LocalKeys (`to_fields`) and the
  `fsdkr_serving_*` and fault counters. The port's producer fills the
  planner's targets before each epoch, so its distributes are pooled
  where the JAX package's (its producer off in the suite) are inline:
  the same bytes either way.
- DEVICE: the same on the cuda backend's plain versions (device="cpu"),
  an honest epoch and a tampered one, each on a committee of its own
  (n=2, so that each stays well inside a minute): the verdicts and keys
  are the JAX package's, and the journals differ only in the committee
  record's `backend`.
- CONTROL: the service's results equal `distribute_batch` +
  `collect_sessions` called directly on the same committee.
- PRODUCER: the pools were filled by the producer and taken by the
  distributes; a service on device "cuda" raises without a card.
"""

import copy
import dataclasses
import json
import time

import pytest

from _torch_samplers import JAX, PORT, canned_material, install_samplers
from fsdkr_tpu import precompute as j_precompute
from fsdkr_tpu import serving as j_serving
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.serving import faults as j_faults
from fsdkr_tpu.serving.journal import read_records as j_read_records
from fsdkr_tpu.telemetry import registry as j_registry

from fsdkr_tpu_torch import TEST_CONFIG, precompute, serving
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.serving import faults
from fsdkr_tpu_torch.serving.journal import read_records
from fsdkr_tpu_torch.telemetry import registry

HOST = dataclasses.replace(TEST_CONFIG, backend="host")
DEVICE_CPU = TEST_CONFIG  # backend "cuda" on device "cpu": the plain versions
TAMPER = "seed=7,msg_tamper=1.0,msg_tamper_max=1"
EPOCHS = ((1, None), (2, None), (3, TAMPER))
CANNED = 18  # key bundles: three epochs of three, and the pools' runway
COUNTERS = ("fsdkr_serving_sessions", "fsdkr_serving_retries", "fsdkr_fault_injected")


@pytest.fixture(scope="module")
def committee3():
    return jax_keygen(1, 3, JAX_CONFIG)


@pytest.fixture(scope="module")
def committee2():
    return jax_keygen(1, 2, JAX_CONFIG)


@pytest.fixture(scope="module")
def canned():
    return canned_material(JAX_CONFIG, CANNED)


@pytest.fixture
def samplers(monkeypatch, canned):
    jreset = install_samplers(monkeypatch, JAX, canned["jax"], JAX_CONFIG.paillier_bits)
    preset = install_samplers(monkeypatch, PORT, canned["port"], TEST_CONFIG.paillier_bits)
    yield jreset, preset
    _clear_both()


@pytest.fixture
def one_torch_thread():
    """The plain versions' small tensor ops on one torch thread (more
    gain nothing on them and oversubscribe the suite's workers)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _clear_both():
    for pc in (precompute, j_precompute):
        pc.clear_pools()
        pc.clear_targets()
    faults.reset()
    j_faults.reset()


def _counters(reg):
    out = {}
    for name in COUNTERS:
        m = reg.get_registry().get(name)
        for rec in m.snapshot_values() if m is not None else ():
            out[(name, tuple(sorted(rec["labels"].items())))] = rec["value"]
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _wait_filled(timeout=120.0):
    """The port's producer has filled every registered target: no draw of
    the samplers runs beside the next distribute's."""
    end = time.monotonic() + timeout
    while precompute.deficit_total():
        assert time.monotonic() < end, "the producer did not fill the targets"
        time.sleep(0.01)


def serve(pkg, keys, config, jdir, epochs, slo=None, **kw):
    """Run `epochs` [(epoch, fault spec or None)] of one committee through
    `pkg`'s RefreshService with one worker; returns ([(state, blame,
    error)], the counters' change). The port's service waits for its
    producer before each epoch."""
    port = pkg == "port"
    svc_mod, fmod, reg = (serving, faults, registry) if port else (j_serving, j_faults, j_registry)
    before = _counters(reg)
    svc = svc_mod.RefreshService(workers=1, journal=str(jdir), **kw)
    svc.admit("c1", keys, config, *(() if slo is None else (slo,)))
    svc.start()
    verdicts = []
    try:
        for epoch, spec in epochs:
            if port:
                _wait_filled()
            if spec:
                fmod.configure(spec)
            try:
                sess = svc.wait(svc.submit("c1", epoch=epoch), timeout=600)
            finally:
                fmod.reset()
            verdicts.append((sess.state, sess.blame, sess.error))
        stats = svc.stats()
    finally:
        svc.stop()
    assert stats["inflight"] == 0
    return verdicts, _delta(_counters(reg), before)


def _segments(jdir):
    return [p.read_bytes() for p in sorted(jdir.glob("wal-*.seg"))]


def test_host_journal_bytes_verdicts_keys_and_counters_match_jax(
        samplers, committee3, tmp_path):
    jreset, preset = samplers
    jreset()
    _clear_both()
    jkeys = copy.deepcopy(committee3)
    want, want_counts = serve("jax", jkeys, JAX_CONFIG, tmp_path / "jax", EPOCHS)
    preset()
    _clear_both()
    pkeys = from_reference(committee3)
    precompute.stats_reset()
    # the gauge reads the producer's lifetime error count: an earlier
    # test in this process may have left it above 0
    errors = registry.get_registry().get("fsdkr_producer_errors")
    errors0 = errors.snapshot_values()[0]["value"] if errors is not None else 0
    got, got_counts = serve("port", pkeys, HOST, tmp_path / "port", EPOCHS, device="cpu")

    assert [v[:2] for v in want] == [("done", False), ("done", False), ("aborted", True)]
    assert want[2][2].startswith("PDLwSlackProofError")
    assert got == want
    assert got_counts == want_counts
    assert [to_fields(k) for k in pkeys] == [to_fields(from_reference(k)) for k in jkeys]
    assert _segments(tmp_path / "port") == _segments(tmp_path / "jax")
    assert sum(map(len, _segments(tmp_path / "port"))) > 12  # records, not only headers
    # the producer filled the pools the distributes took
    st = precompute.precompute_stats()
    assert st["produced"] > 0 and st["consumed"] > 0
    errors = registry.get_registry().get("fsdkr_producer_errors")
    assert errors.snapshot_values()[0]["value"] == errors0


@pytest.mark.parametrize("spec", [None, TAMPER], ids=["honest", "tampered"])
def test_device_backend_plain_versions_verdicts_and_keys_match_jax(
        samplers, committee2, tmp_path, one_torch_thread, spec):
    jreset, preset = samplers
    jreset()
    _clear_both()
    jkeys = copy.deepcopy(committee2)
    epochs = ((1, spec),)
    want, _ = serve("jax", jkeys, JAX_CONFIG, tmp_path / "jax", epochs)
    preset()
    _clear_both()
    pkeys = from_reference(committee2)
    # one epoch's key material ahead (the default SLO's runway is two)
    slo = serving.SLO(arrival_rate_hz=0.01)
    got, _ = serve("port", pkeys, DEVICE_CPU, tmp_path / "port", epochs, slo, device="cpu")
    assert got == want
    assert want[0][:2] == (("aborted", True) if spec else ("done", False))
    assert [to_fields(k) for k in pkeys] == [to_fields(from_reference(k)) for k in jkeys]
    recs, jrecs = read_records(tmp_path / "port"), j_read_records(tmp_path / "jax")
    assert [r["t"] for r in recs] == [r["t"] for r in jrecs]
    for r, j in zip(recs, jrecs):
        if r["t"] == "committee":
            assert r["config"].pop("backend") == "cuda"
            assert j["config"].pop("backend") == "host"
            assert "device" not in r["config"]
        assert r == j


def test_service_results_equal_the_control_arm(samplers, committee3, tmp_path):
    """distribute_batch + collect_sessions called directly, epoch by
    epoch, adopt the keys the service adopted and raise its verdicts."""
    _jreset, preset = samplers
    preset()
    _clear_both()
    served = from_reference(committee3)
    got, _ = serve("port", served, HOST, tmp_path / "svc", EPOCHS, device="cpu")
    preset()
    _clear_both()
    keys = from_reference(committee3)
    control = []
    for epoch, spec in EPOCHS:
        res = RefreshMessage.distribute_batch([(k.i, k) for k in keys], len(keys), HOST)
        msgs = [m for m, _ in res]
        if spec:
            # the service's shuffled arrival tampers sender 1's message
            # first; first arrival wins
            msgs = [faults.tamper_message(m) if m.party_index == 1 else m for m in msgs]
        errs = RefreshMessage.collect_sessions(
            [(msgs, k, dk, ()) for k, (_m, dk) in zip(keys, res)], HOST)
        err = next((e for e in errs if e is not None), None)
        control.append(("done", False, None) if err is None else
                       ("aborted", True, f"{type(err).__name__}: {err}"))
    assert got == control
    assert [to_fields(k) for k in served] == [to_fields(k) for k in keys]


def test_cuda_service_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.RefreshService()
    svc = serving.RefreshService(device="cpu")
    with pytest.raises(ValueError, match="runs on 'cuda'"):
        svc.admit("c1", [], dataclasses.replace(TEST_CONFIG, device="cuda"))


def test_journaled_committee_record_carries_no_device(tmp_path):
    from fsdkr_tpu_torch.serving.recovery import config_from_record, config_record

    rec = config_record(DEVICE_CPU)
    assert rec == {"paillier_bits": 768, "m_security": 32, "correct_key_rounds": 3,
                   "backend": "cuda", "hash_alg": "sha256", "curve": "secp256k1"}
    assert config_from_record(json.loads(json.dumps(rec)), "cpu") == DEVICE_CPU
