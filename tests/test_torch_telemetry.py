"""The port's telemetry (fsdkr_tpu_torch/telemetry) against the JAX
package's: the same sequence of registry operations gives the JAX
registry's snapshot and Prometheus exposition text, byte for byte
(histograms observe fixed values here, so their sums and buckets are
compared too; the serving layer's histograms time phases and stay out
of the cross-package checks); labels refuse operand-wide values in both;
the flight recorder keeps the same ring. The JSON export's snapshot and
its Prometheus file hold the JAX package's samples for the same
recorded metrics; the flight dump writes the JAX recorder's fields and
scrubs exception text as it does; `install` hooks an uncaught exception
and SIGTERM.
"""

import json

import pytest

from fsdkr_tpu.telemetry import export as j_export
from fsdkr_tpu.telemetry import flight as j_flight
from fsdkr_tpu.telemetry import registry as j_registry

from fsdkr_tpu_torch.telemetry import flight, registry


def _drive(reg):
    """One sequence of operations on a fresh registry."""
    c = reg.counter("fsdkr_t_sessions", "sessions by outcome", labelnames=("outcome",))
    c.inc(outcome="done")
    c.inc(2, outcome="aborted")
    c.labels(outcome="done").inc(0.5)
    reg.counter("fsdkr_t_bytes_total", "bytes").inc(4096)
    g = reg.gauge("fsdkr_t_inflight", "inflight sessions")
    g.set(3)
    g.inc()
    g.dec(2)
    reg.gauge("fsdkr_t_depth", "pool depth").set_function(lambda: 7)
    reg.gauge("fsdkr_t_kinds", "depth by kind", labelnames=("kind",)).set_labeled_function(
        lambda: {("enc",): 3, ("pdl",): 1.5})
    reg.gauge("fsdkr_t_broken", "a raising function").set_function(lambda: 1 / 0)
    h = reg.histogram("fsdkr_t_phase_seconds", "phase latency", labelnames=("phase",),
                      buckets=(0.01, 0.1, 1.0, 10.0))
    for v in (0.005, 0.05, 0.05, 0.5, 2.0, 20.0):
        h.observe(v, phase="finalize")
    h.observe(0.2, phase="queue")
    reg.histogram("fsdkr_t_batch", "batch sizes", buckets=(1, 2, 4)).observe(3)
    reg.counter("fsdkr_t_reset", "reset window").inc(9)
    reg.reset_window(["fsdkr_t_reset"])
    return reg


def test_exposition_text_is_the_jax_registrys():
    ours = _drive(registry.Registry())
    theirs = _drive(j_registry.Registry())
    assert ours.snapshot() == theirs.snapshot()
    text = registry.prometheus_text(ours.snapshot())
    assert text == j_export.prometheus_text(theirs.snapshot())
    assert 'fsdkr_t_sessions_total{outcome="done"} 1.5' in text
    assert 'fsdkr_t_phase_seconds_bucket{phase="finalize",le="+Inf"} 6' in text
    assert "# TYPE fsdkr_t_broken gauge" in text and "\nfsdkr_t_broken " not in text


@pytest.mark.parametrize("value", [1 << 64, -(1 << 70), "x" * 121, float("nan"), (1, 2)])
def test_labels_refuse_operand_material_like_jax(value):
    for mod in (registry, j_registry):
        reg = mod.Registry()
        c = reg.counter("fsdkr_t_c", "c", labelnames=("k",))
        with pytest.raises(ValueError):
            c.inc(k=value)
    assert registry.check_label_value(5) == j_registry.check_label_value(5)


def test_registry_refuses_redeclaration_like_jax():
    for mod in (registry, j_registry):
        reg = mod.Registry()
        reg.counter("fsdkr_t_x", "x", labelnames=("a",))
        with pytest.raises(ValueError):
            reg.gauge("fsdkr_t_x", "x", labelnames=("a",))
        with pytest.raises(ValueError):
            reg.counter("fsdkr_t_x", "x", labelnames=("b",))
        reg.histogram("fsdkr_t_h", "h", buckets=(1, 2))
        assert reg.histogram("fsdkr_t_h").buckets == (1, 2)
        with pytest.raises(ValueError):
            reg.histogram("fsdkr_t_h", "h", buckets=(1, 3))


def test_flight_ring_is_the_jax_recorders():
    def drive(rec):
        for i in range(100):
            rec.record("fault", "msg_tamper", key=repr((i, 1)), wide=1 << 80)
        rec.record("recovery", "replay_done", dur=0.1234567, terminal=3)
        return [{k: v for k, v in e.items() if k not in ("ts", "thread")}
                for e in rec.snapshot()]

    ours = drive(flight.FlightRecorder(cap=64))
    assert ours == drive(j_flight.FlightRecorder(cap=64))
    assert len(ours) == 64
    assert ours[-1] == {"kind": "recovery", "name": "replay_done", "dur_s": 0.123457,
                        "fields": {"terminal": 3}}
    assert "wide" not in ours[0]["fields"]  # a wide int never lands in the ring


# ---------------------------------------------------------------------------
# the JSON export and the flight recorder's dump

_EXPORTED = [0]


def _drive_global(reg_mod, tag):
    """Record one fixed set of metrics in `reg_mod`'s process registry,
    under names of their own; returns the names."""
    p = f"fsdkr_t_export{tag}_"
    reg_mod.counter(p + "frames", "frames by direction", labelnames=("direction",)).inc(
        3, direction="in")
    reg_mod.counter(p + "frames", labelnames=("direction",)).inc(direction="out")
    reg_mod.gauge(p + "open", "open connections").set(2)
    h = reg_mod.histogram(p + "seconds", "latency", labelnames=("phase",),
                          buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v, phase="total")
    return [p + s for s in ("frames", "open", "seconds")]


def test_export_snapshot_and_dump_match_jax(tmp_path):
    from fsdkr_tpu_torch.telemetry import export

    _EXPORTED[0] += 1
    names = _drive_global(registry, _EXPORTED[0])
    assert names == _drive_global(j_registry, _EXPORTED[0])
    ours, theirs = export.snapshot(), j_export.snapshot()
    assert ours["schema"] == theirs["schema"] == registry.SCHEMA_VERSION
    assert set(ours) == set(theirs) == {"schema", "metrics"}
    assert {n: ours["metrics"][n] for n in names} == {n: theirs["metrics"][n] for n in names}
    assert export.prometheus_text is registry.prometheus_text
    assert export.dump_metrics(tmp_path / "ours.prom") == str(tmp_path / "ours.prom")
    j_export.dump_metrics(str(tmp_path / "theirs.prom"))

    def lines(path):
        return [ln for ln in (tmp_path / path).read_text().splitlines()
                if any(n in ln for n in names)]

    assert lines("ours.prom") == lines("theirs.prom")
    assert len(lines("ours.prom")) == 3 * 2 + 2 + 5 + 2
    assert not list(tmp_path.glob("*.tmp.*"))


def _ring(rec):
    for i in range(70):
        rec.record("fault", "conn_drop", key=repr((i, 1)), wide=1 << 80)
    rec.record("supervisor", "shard_death", shard=1, gen=1)
    rec.record("recovery", "replay_done", dur=0.25, terminal=3)


def test_flight_dump_writes_the_jax_recorders_fields(tmp_path, monkeypatch):
    ours, theirs = flight.FlightRecorder(cap=64), j_flight.FlightRecorder(cap=64)
    _ring(ours)
    _ring(theirs)
    a = json.loads(open(ours.dump(str(tmp_path / "a.json"), reason="heartbeat")).read())
    b = json.loads(open(theirs.dump(str(tmp_path / "b.json"), reason="heartbeat")).read())
    assert set(a) == set(b) == {"schema", "pid", "reason", "started_at", "dumped_at",
                                "events_recorded", "events", "metrics"}

    def strip(doc):
        return [{k: v for k, v in e.items() if k not in ("ts", "thread")} for e in doc["events"]]

    assert strip(a) == strip(b)
    assert (a["schema"], a["reason"], a["events_recorded"]) == (
        b["schema"], b["reason"], b["events_recorded"]) == ("fsdkr-flight/1", "heartbeat", 72)
    assert len(a["events"]) == 64 and all("wide" not in e.get("fields", {}) for e in a["events"])
    assert a["metrics"]["schema"] == registry.SCHEMA_VERSION
    events_only = json.loads(open(ours.dump(str(tmp_path / "c.json"),
                                            include_metrics=False)).read())
    assert events_only["metrics"] is None and events_only["reason"] == "manual"
    monkeypatch.setitem(flight._DEST, "path", None)
    assert flight.dump() is None  # no destination named: no file
    monkeypatch.setitem(flight._DEST, "path", str(tmp_path / "d.json"))
    assert flight.dump(reason="x") == str(tmp_path / "d.json")


@pytest.mark.parametrize("msg", [
    "modulus 123456789012345678901234567890 is not prime",
    "bad ciphertext 0x" + "ab" * 40,
    "short 1234567 and " + "f" * 31,
    "x" * 300,
    "mixed " + "9" * 16 + " and " + "e" * 32,
])
def test_exception_text_is_scrubbed_like_jax(msg):
    assert flight._scrub_detail(msg) == j_flight._scrub_detail(msg)
    assert len(flight._scrub_detail(msg)) <= 120


_CRASH = """
import sys
from {pkg}.telemetry import flight
{install}
flight.record("shard", "ready", shard=0)
raise ValueError("modulus " + "7" * 40 + " rejected")
"""


def test_install_hooks_an_uncaught_exception_like_jax(tmp_path):
    """A process that dies of an uncaught exception leaves the dump at
    install()'s path (the JAX package's at FSDKR_FLIGHT), the scrubbed
    exception its last event, and still dies with its traceback."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = {}
    for pkg, install, env in (
        ("fsdkr_tpu_torch", f"flight.install({str(tmp_path / 'ours.json')!r})", {}),
        ("fsdkr_tpu", "flight.install(force=True)",
         {"FSDKR_FLIGHT": str(tmp_path / "theirs.json"), "JAX_PLATFORMS": "cpu"}),
    ):
        proc = subprocess.run(
            [sys.executable, "-c", _CRASH.format(pkg=pkg, install=install)], cwd=repo,
            capture_output=True, text=True, timeout=120, env={**os.environ, **env})
        assert proc.returncode == 1 and "ValueError" in proc.stderr, proc.stderr
        runs[pkg] = proc
    a = json.loads((tmp_path / "ours.json").read_text())
    b = json.loads((tmp_path / "theirs.json").read_text())
    assert a["reason"] == b["reason"] == "unhandled:ValueError"
    last = [{k: v for k, v in e.items() if k not in ("ts", "thread")} for e in a["events"]]
    assert last[-1] == {"kind": "crash", "name": "ValueError",
                        "fields": {"detail": "modulus <wide-int> rejected"}}
    assert last[-1] == {k: v for k, v in b["events"][-1].items() if k not in ("ts", "thread")}
    assert last[-2] == {"kind": "shard", "name": "ready", "fields": {"shard": 0}}


def test_install_dumps_on_sigterm(tmp_path):
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (f"import time\nfrom fsdkr_tpu_torch.telemetry import flight\n"
            f"flight.install({str(tmp_path / 'term.json')!r})\n"
            f"print('up', flush=True)\ntime.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=repo, stdout=subprocess.PIPE,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "up"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == -signal.SIGTERM
    finally:
        proc.kill()
        proc.wait()
    doc = json.loads((tmp_path / "term.json").read_text())
    assert doc["reason"] == "SIGTERM" and doc["events"][-1]["name"] == "SIGTERM"


# -- the engines' counters on the registry -------------------------------

ENGINE_METRICS = ("fsdkr_rlc_events", "fsdkr_crt_events", "fsdkr_crt_store_entries",
                  "fsdkr_crt_store_hits", "fsdkr_crt_store_misses", "fsdkr_mem_tiles",
                  "fsdkr_mem_bytes_staged", "fsdkr_mem_plans", "fsdkr_mem_plan_rows",
                  "fsdkr_mem_tile_rows", "fsdkr_mem_budget_bytes", "fsdkr_pool_events",
                  "fsdkr_pool_bytes", "fsdkr_primegen_events")


def _touch_engines(rlc, crt, memplan, pools, primes, plan_device):
    """One event of each engine counter; a pool put and take."""
    rlc.count("bisect_fallbacks")
    crt._count(rows=2, legs=4)
    memplan.plan_rows(10, 1000, "pairs", **plan_device)
    memplan.count_tile("pairs")
    memplan.stage(1000)
    memplan.release(1000)
    pools.put("enc", 7, (3, 5))
    pools.take("enc", 7)
    primes.gen_stats_reset()


def test_engine_counters_are_registry_metrics_under_the_jax_names(monkeypatch):
    """Every engine counter of the port lives on its registry with the
    JAX package's name, kind, labels and help; the window views read them
    (stats(), crt_stats(), mem_stats(), precompute_stats()), the serving
    layer's bisection count among them."""
    from fsdkr_tpu.backend import crt as jcrt
    from fsdkr_tpu.backend import memplan as jmemplan
    from fsdkr_tpu.backend import rlc as jrlc
    from fsdkr_tpu.core import primes as jprimes
    from fsdkr_tpu.precompute import pools as jpools

    from fsdkr_tpu_torch.backend import crt, memplan, rlc
    from fsdkr_tpu_torch.core import primes
    from fsdkr_tpu_torch.precompute import pools
    from fsdkr_tpu_torch.serving import metrics

    monkeypatch.setenv("FSDKR_PRECOMPUTE", "1")
    for mod in (rlc, crt, memplan, pools):
        mod.stats_reset()
    bisects = metrics.rlc_bisect_count()
    _touch_engines(rlc, crt, memplan, pools, primes, {"device": "cpu"})
    _touch_engines(jrlc, jcrt, jmemplan, jpools, jprimes, {})
    jmemplan._plan_gauges()
    jmemplan.mem_stats()
    for name in ENGINE_METRICS:
        mine = registry.get_registry().get(name)
        ref = j_registry.get_registry().get(name)
        assert mine is not None and ref is not None, name
        assert (mine.kind, mine.labelnames, mine.help) == (ref.kind, ref.labelnames, ref.help), \
            name
    assert metrics.rlc_bisect_count() == bisects + 1
    assert rlc.stats()["bisect_fallbacks"] == 1
    assert crt.crt_stats()["legs"] == 4
    mem = memplan.mem_stats()
    assert mem["tiles"] == {"pairs": 1} and mem["bytes_staged"] == 1000
    assert mem["tile_rows"] == {"pairs": 10} and mem["plans"] == 1
    st = pools.precompute_stats()
    assert (st["produced"], st["consumed"]) == (1, 1)
