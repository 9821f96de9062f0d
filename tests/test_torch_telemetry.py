"""The port's telemetry (fsdkr_tpu_torch/telemetry) against the JAX
package's: the same sequence of registry operations gives the JAX
registry's snapshot and Prometheus exposition text, byte for byte
(histograms observe fixed values here, so their sums and buckets are
compared too; the serving layer's histograms time phases and stay out
of the cross-package checks); labels refuse operand-wide values in both;
the flight recorder keeps the same ring.
"""

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
