"""The port's span tracer (fsdkr_tpu_torch/telemetry/spans.py), its
phases through distribute, collect and streaming, and the roofline
(fsdkr_tpu_torch/utils/roofline.py), against the JAX package.

- The port's `Tracer` and the JAX package's, driven by the same calls:
  nesting, an exception, the span cap, the attribute allowlist,
  `inherit_phase` across a `run_jobs` pool (the JAX package's at two
  workers; the port runs its thunks on the calling thread) and the
  `prefetch_tiles` worker, a `BackgroundProducer` thread starting its own
  roots, `add_macs` to the innermost phase. `stats()` without seconds,
  the span tree by name and parent, and `chrome_trace()`'s events with
  timestamps, ids and thread ids removed are equal. (The counterparts of
  tests/test_trace.py and tests/test_telemetry.py's span tests.)
- `simulate_keygen(1, 3)` and a refresh: the protocol and family phase
  names with their items are the JAX package's, on the host backends
  (distribute, barrier collect, streaming collect) and on the JAX
  package's TPU backend (XLA:CPU, host engines) against the port's cuda
  backend on the plain versions (distribute and collect). Calls differ
  in one place only: the port runs each range engine's receiver groups
  as one launch set, so `range.u_pow` and `range.comb2` are one span a
  collect where the JAX package opens one a group (FUSED_GROUPS). The
  port lacks no family span of that refresh. chip_smoke.py's
  `collect_spans(n, M, rounds)`, the list its `trace` phase gates a
  traced collect on the card against, gives the JAX package's collect
  spans and items at n=3.
- Every roofline formula equals the JAX package's over a grid of shapes;
  the peak is the H100's.
"""

import copy
import dataclasses
import importlib.util
import threading
from pathlib import Path

import pytest
import torch

from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.telemetry import spans as jspans
from fsdkr_tpu.utils import pipeline as jpipeline
from fsdkr_tpu.utils import roofline as jroof

from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.telemetry import spans as pspans
from fsdkr_tpu_torch.utils import pipeline as ppipeline
from fsdkr_tpu_torch.utils import roofline as proof

# span names whose calls differ: the port fuses the receiver groups
FUSED_GROUPS = {"range.u_pow", "range.comb2"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tracers():
    """Both packages' process tracers, enabled and empty; restored after."""
    pair = (jspans.get_tracer(), pspans.get_tracer())
    before = [t.enabled for t in pair]
    for t in pair:
        t.enable()
        t.reset()
    yield pair
    for t, was in zip(pair, before):
        t.reset()
        t.enabled = was


# -- the tracer, call for call ------------------------------------------


def _nesting(tr, pipe):
    with tr.phase("a", items=2):
        tr.add_macs(5)
        with tr.phase("a.b", items=3):
            tr.add_macs(7)
            with tr.phase("a.b.c"):
                tr.add_macs(11)
        tr.count("a.counted", 4)
    tr.add_macs(13)  # no phase open: "(unphased)"


def _exception(tr, pipe):
    with pytest.raises(KeyError):
        with tr.phase("outer", items=1):
            with tr.phase("inner", items=1):
                tr.add_macs(3)
                raise KeyError("boom")
    with tr.phase("after"):
        pass


def _attrs(tr, pipe):
    with tr.phase("attrs", items=1, n=3, label="ok", ratio=1.5, flag=True,
                  wide=1 << 80, obj=[1, 2], skip=None):
        pass


def _run_jobs(tr, pipe):
    def job(k):
        def run():
            with tr.phase("job", items=k):
                tr.add_macs(100 * k)
            return k
        return run

    with tr.phase("sched", items=3):
        if pipe is jpipeline:
            out = pipe.run_jobs([job(1), job(2), job(3)], workers=2)
        else:
            out = pipe.run_jobs([job(1), job(2), job(3)])
    assert out == [1, 2, 3]


def _prefetch(tr, pipe):
    seen = []

    def prepare(lo, hi):
        with tr.phase("tile.prepare", items=hi - lo):
            tr.add_macs(hi - lo)
        return lo, hi

    def consume(span):
        with tr.phase("tile.consume", items=span[1] - span[0]):
            seen.append(span)

    with tr.phase("stream", items=6):
        pipe.prefetch_tiles([(0, 2), (2, 4), (4, 6)], prepare, consume)
    assert seen == [(0, 2), (2, 4), (4, 6)]


def _producer(tr, pipe):
    done = threading.Event()

    def step():
        if done.is_set():
            return False
        with tr.phase("bg.step", items=1):
            tr.add_macs(9)
        done.set()
        return True

    with tr.phase("kicker"):
        prod = pipe.BackgroundProducer(step)
        prod.kick()
        assert done.wait(10)
    prod.stop()


def _inherit_by_name(tr, pipe):
    out = []

    def worker():
        with tr.inherit_phase("named"):
            tr.add_macs(21)
            with tr.phase("child", items=1):
                pass
        out.append(True)

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert out


SCENARIOS = {
    "nesting": _nesting,
    "exception": _exception,
    "attrs": _attrs,
    "run_jobs": _run_jobs,
    "prefetch_tiles": _prefetch,
    "background_producer": _producer,
    "inherit_by_name": _inherit_by_name,
}


def _stats(tr):
    return {k: (v.calls, v.items, v.macs) for k, v in tr.stats().items()}


def _tree(tr):
    spans = tr.spans()
    names = {sp.span_id: sp.name for sp in spans}
    return sorted(
        (sp.name, names.get(sp.parent_id) if sp.parent_id else None, sp.items, sp.macs,
         tuple(sorted((sp.attrs or {}).items())))
        for sp in spans
    )


def _off_main(tr):
    main = threading.main_thread().ident
    return sorted(sp.name for sp in tr.spans() if sp.tid != main)


def _events(tr):
    trace = tr.chrome_trace()
    names = {ev["args"]["span_id"]: ev["name"] for ev in trace["traceEvents"] if ev["ph"] == "X"}
    out = []
    for ev in trace["traceEvents"]:
        if ev["ph"] != "X":
            continue
        assert ev["dur"] >= 0
        args = dict(ev["args"])
        args.pop("span_id")
        if "parent_id" in args:
            args["parent"] = names[args.pop("parent_id")]
        out.append((ev["name"], ev["cat"], tuple(sorted(args.items()))))
    # thread metadata: one record a thread that recorded a span
    meta = sorted(ev["name"] for ev in trace["traceEvents"] if ev["ph"] == "M")
    other = {k: v for k, v in trace["otherData"].items() if k != "epoch_unix"}
    return sorted(out), meta, other, trace["displayTimeUnit"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tracer_matches_the_jax_packages_call_for_call(tracers, name):
    got, off_main = [], []
    for tr, pipe in zip(tracers, (jpipeline, ppipeline)):
        SCENARIOS[name](tr, pipe)
        events, meta, other, unit = _events(tr)
        got.append((_stats(tr), _tree(tr), events, other, unit, tr.spans_dropped(),
                    tr.attrs_dropped()))
        off_main.append((_off_main(tr), meta))
    assert got[1] == got[0]
    if name == "run_jobs":
        # the JAX package's jobs ran on its pool's two threads, the port's
        # on the calling thread
        assert off_main[0][0] == ["job"] * 3 and off_main[1][0] == []
    else:
        assert off_main[1] == off_main[0]
    stats, tree = got[1][0], got[1][1]
    if name == "nesting":
        assert stats["a.b.c"][2] == 11 and stats["a"][2] == 5 and stats["(unphased)"][2] == 13
    if name in ("run_jobs", "prefetch_tiles"):
        parent = "sched" if name == "run_jobs" else "stream"
        child = "job" if name == "run_jobs" else "tile.prepare"
        assert {p for n, p, *_ in tree if n == child} == {parent}
    if name == "background_producer":
        assert [p for n, p, *_ in tree if n == "bg.step"] == [None]
        assert off_main[1][0] == ["bg.step"]
    if name == "attrs":
        assert got[1][6] == 2


def test_span_cap_drops_the_newest_and_counts_them():
    got = []
    for mod in (jspans, pspans):
        tr = mod.Tracer(enabled=True, max_spans=3)
        for i in range(5):
            with tr.phase(f"p{i}", items=i):
                pass
        got.append(([sp.name for sp in tr.spans()], tr.spans_dropped(), _stats(tr)))
        tr.reset()
        assert tr.spans() == [] and tr.spans_dropped() == 0
    assert got[1] == got[0] == (["p0", "p1", "p2"], 2, got[0][2])
    assert len(got[1][2]) == 5  # the aggregate keeps every phase


def test_children_lie_inside_their_parents_and_reset_keeps_spans(tracers):
    _, tr = tracers
    with tr.phase("outer"):
        for _ in range(20):
            with tr.phase("inner"):
                pass
    by_id = {sp.span_id: sp for sp in tr.spans()}
    for sp in by_id.values():
        if sp.parent_id is not None:
            parent = by_id[sp.parent_id]
            assert parent.t0 <= sp.t0 and sp.t1 <= parent.t1
    tr.reset(keep_spans=True)
    assert tr.stats() == {} and len(tr.spans()) == 21


def test_disabled_tracer_keeps_the_histogram_and_the_flight_ring(tmp_path):
    from fsdkr_tpu_torch.telemetry import flight, registry

    tr = pspans.Tracer()
    assert not tr.enabled
    hist = registry.get_registry().get("fsdkr_phase_seconds")
    before = {tuple(r["labels"].items()): r["count"] for r in hist.snapshot_values()} \
        if hist is not None else {}
    with tr.phase("quiet.phase", items=4):
        pass
    assert tr.stats() == {} and tr.spans() == []
    hist = registry.get_registry().get("fsdkr_phase_seconds")
    counts = {tuple(r["labels"].items()): r["count"] for r in hist.snapshot_values()}
    key = (("phase", "quiet.phase"),)
    assert counts[key] == before.get(key, 0) + 1
    rec = [e for e in flight.get_flight().snapshot() if e.get("name") == "quiet.phase"]
    assert rec and rec[-1]["kind"] == "span" and rec[-1]["fields"]["items"] == 4
    path = tmp_path / "trace.json"
    tr.enable()
    with tr.phase("loud"):
        pass
    assert tr.write_chrome_trace(str(path)) == str(path)
    assert path.read_text().startswith("{")


# -- the refresh's phases against the JAX package's ----------------------


def _phase_items(tr):
    return {k: (v.calls, v.items) for k, v in tr.stats().items()}


@pytest.fixture(scope="module")
def committee():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        keys = jax_keygen(1, 3, JAX_CONFIG)
    return keys


def _refresh(tracers, jax_keys, jax_config, port_config, stream=False):
    """One distribute and receiver 1's collect (barrier, or streamed) on
    each package from the same committee; the two tracers' stats."""
    jt, pt = tracers
    port_keys = from_reference(copy.deepcopy(jax_keys))
    jax_keys = copy.deepcopy(jax_keys)
    out = []
    for tr, keys, refresh, config in ((jt, jax_keys, JaxRefresh, jax_config),
                                      (pt, port_keys, RefreshMessage, port_config)):
        tr.reset()
        res = refresh.distribute_batch([(k.i, k) for k in keys], 3, config)
        msgs = [m for m, _ in res]
        if stream:
            sc = refresh.collect_stream(keys[0], res[0][1], config=config)
            for m in reversed(msgs):
                sc.offer(m)
            sc.finalize()
        else:
            refresh.collect(msgs, keys[0], res[0][1], (), config)
        out.append(_phase_items(tr))
    return out


@pytest.mark.parametrize("stream", [False, True], ids=["barrier", "streaming"])
def test_host_refresh_phases_equal_the_jax_packages(tracers, committee, monkeypatch, stream):
    monkeypatch.setenv("FSDKR_PRECOMPUTE", "0")  # no JAX-package pools or producer
    want, got = _refresh(tracers, committee, dataclasses.replace(JAX_CONFIG, backend="host"),
                         dataclasses.replace(PORT_CONFIG, backend="host"), stream)
    assert got == want
    assert "distribute.stage1.commit_pow" in got and "collect.adopt" in got
    if stream:
        assert got["collect.stream.offer"] == (3, 9)
        assert got["collect.stream.finalize"] == (1, 1)


def test_device_refresh_phases_equal_the_jax_packages(tracers, committee, monkeypatch):
    """The JAX package's TPU backend (XLA:CPU, its host engines) against
    the port's cuda backend on the plain versions: every protocol and
    family phase with its items; calls too, but for FUSED_GROUPS."""
    monkeypatch.setenv("FSDKR_PRECOMPUTE", "0")
    monkeypatch.setenv("FSDKR_DEVICE_POWM", "0")
    monkeypatch.setenv("FSDKR_DEVICE_EC", "0")
    want, got = _refresh(tracers, committee, dataclasses.replace(JAX_CONFIG, backend="tpu"),
                         PORT_CONFIG)
    assert set(got) == set(want)
    assert {k: v[1] for k, v in got.items()} == {k: v[1] for k, v in want.items()}
    assert {k: v for k, v in got.items() if k not in FUSED_GROUPS} == \
        {k: v for k, v in want.items() if k not in FUSED_GROUPS}
    for name in FUSED_GROUPS:
        assert got[name][0] == 1 and want[name][0] == 3  # one group a receiver
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.collect_spans(3, JAX_CONFIG.m_security, JAX_CONFIG.correct_key_rounds) == \
        {k: items for k, (_calls, items) in want.items() if not k.startswith("distribute")}
    families = {k.split(".")[0] for k in got if not k.startswith(("collect", "distribute"))}
    assert families == {"pdl", "range", "pairs", "ringped", "correct_key"}
    # the device phases carry the port's MACs
    stats = tracers[1].stats()
    for name in ("pdl.modexp_columns", "ringped.modexp", "correct_key.modexp",
                 "distribute.commit_points", "collect.validate_feldman"):
        assert stats[name].macs > 0, name


# -- the roofline ---------------------------------------------------------


@pytest.mark.parametrize("k", [1, 16, 48, 128, 130, 256])
def test_roofline_formulas_equal_the_jax_packages(k):
    assert proof.montmul_macs(k) == jroof.montmul_macs(k)
    for rows in (1, 8, 13, 256):
        assert proof.modmul_macs(rows, k) == jroof.modmul_macs(rows, k)
        for exp_bits in (0, 4, 128, 256, 2048, 2050):
            assert proof.generic_modexp_macs(rows, exp_bits, k) == \
                jroof.generic_modexp_macs(rows, exp_bits, k)
        for groups, windows in ((1, 1), (2, 32), (16, 512)):
            assert proof.shared_modexp_macs(groups, rows, windows, k) == \
                jroof.shared_modexp_macs(groups, rows, windows, k)
    for bits in (1, 15, 16, 17, 2048, 4097):
        assert proof.k16(bits) == jroof.k16(bits)


@pytest.mark.parametrize("stamp", ["generic", "shared"])
def test_host_stamps_price_as_the_jax_packages(tracers, stamp):
    for tr, mod in zip(tracers, (jroof, proof)):
        with tr.phase("stamped"):
            if stamp == "generic":
                mod.stamp_generic_host(12, 2048, 2048)
                mod.stamp_generic_host(0, 2048, 2048)
            else:
                mod.stamp_shared_host(2, 9, 1024, 2048)
                mod.stamp_shared_host(1, 0, 1024, 2048)
    assert tracers[1].stats()["stamped"].macs == tracers[0].stats()["stamped"].macs > 0


def test_peak_is_the_h100s():
    assert proof.INT8_OPS_PER_S == 1979e12 and proof.HBM_BYTES_PER_S == 3.35e12
    assert proof.H100_PEAK_MACS == pytest.approx(247.375e12)
    st = pspans.PhaseStats(calls=1, seconds=2.0, macs=proof.H100_PEAK_MACS)
    assert st.mfu(proof.H100_PEAK_MACS) == pytest.approx(0.5)
    tr = pspans.Tracer(enabled=True)
    assert tr.report() == "(no phases recorded)"
    with tr.phase("x"):
        tr.add_macs(1e9)
    assert "mfu%" in tr.report().splitlines()[0]
