"""Hierarchical spans behind the aggregate tracer (an own copy of
fsdkr_tpu/telemetry/spans.py).

The flat name -> (calls, seconds, items, macs) aggregator — the
`get_tracer().phase(...)`, `.report()`, `.stats()` API — where each
`phase()` also records a span: start and end timestamps, thread, parent
span (contextvar-tracked, so nesting survives `with` blocks on any
thread), and allowlisted scalar attributes. The span stream exports as
Chrome-trace/Perfetto JSON (`Tracer.write_chrome_trace(path)`), so a
warm collect() renders as a timeline: the verify families, the RLC
folds, the tiles, and the background producer's fills on their own
thread track.

Cost model:

- tracing DISABLED (the default): two `perf_counter` calls, one
  fixed-bucket histogram observation (`fsdkr_phase_seconds{phase=...}`:
  the per-phase latency percentiles stay live without tracing), and one
  flight-recorder ring append per phase. Phases wrap batch launches,
  not rows, so this is tens of events per collect().
- tracing ENABLED (`Tracer(enabled=True)` or `enable()`): additionally
  the aggregate-stats update and one span record, bounded by
  `max_spans` (250,000 by default; overflow drops the newest and counts
  it — a timeline with a hole beats running out of memory).

Worker threads: `utils.pipeline` captures `current_span()` at submit
and enters `inherit_phase(span)` in the worker, so tile spans and MAC
attribution parent to the submitting phase. Threads NOT primed this way
(the background producer) start their own span roots: their track in
the trace shows what that thread did.

Span attributes go through the same scalar allowlist as metric labels
(registry.check_label_value); a disallowed value (any wide int) is
dropped and counted, never recorded.

Nothing here reads the environment: tracing is switched on by the
caller, and every destination is an explicit path.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

__all__ = [
    "PhaseStats",
    "Span",
    "Tracer",
    "get_tracer",
    "phase",
    "torch_profile",
]

MAX_SPANS = 250_000

_SPAN_IDS = itertools.count(1)  # CPython: count.__next__ is atomic

# perf_counter epoch shared by every span so timelines are comparable
_T0_PERF = time.perf_counter()
_T0_UNIX = time.time()

# stack of (tracer, span-like) tuples; contextvars give each thread its
# own stack by default AND survive into explicitly-propagated contexts
_STACK: ContextVar[tuple] = ContextVar("fsdkr_span_stack", default=())


@dataclass
class PhaseStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0
    macs: float = 0.0  # analytic 16x16-bit MAC count (utils.roofline)

    @property
    def items_per_second(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def mfu(self, peak: float) -> float:
        return self.macs / self.seconds / peak if self.seconds > 0 else 0.0


class Span:
    """One finished (or in-flight) phase instance. Timestamps are
    perf_counter seconds relative to the module epoch."""

    __slots__ = (
        "name", "span_id", "parent_id", "t0", "t1", "tid", "thread_name",
        "items", "macs", "attrs",
    )

    def __init__(self, name: str, parent_id: Optional[int], items: int,
                 attrs: Optional[dict]):
        self.name = name
        self.span_id = next(_SPAN_IDS)
        self.parent_id = parent_id
        self.t0 = time.perf_counter() - _T0_PERF
        self.t1: Optional[float] = None
        th = threading.current_thread()
        self.tid = th.ident or 0
        self.thread_name = th.name
        self.items = items
        self.macs = 0.0
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class _Anchor:
    """Span-like stack entry for `inherit_phase`: carries attribution
    (name, and the parent span id when inherited from a real span)
    without owning any wall-clock."""

    __slots__ = ("name", "span_id", "macs")

    def __init__(self, name: str, span_id: Optional[int]):
        self.name = name
        self.span_id = span_id
        self.macs = 0.0


def _sanitize_attrs(attrs: dict):
    """(allowlisted attrs or None, dropped count)."""
    from .registry import sanitize_fields

    return sanitize_fields(attrs)


# per-phase latency histogram: always on (cheap, bounded memory), the
# registry backbone the serving SLOs read even when span tracing is off
_PHASE_HIST = None
_HIST_LOCK = threading.Lock()


def _phase_hist():
    global _PHASE_HIST
    if _PHASE_HIST is None:
        with _HIST_LOCK:
            if _PHASE_HIST is None:
                from .registry import histogram

                _PHASE_HIST = histogram(
                    "fsdkr_phase_seconds",
                    "wall-clock of each pipeline phase (telemetry.spans)",
                    labelnames=("phase",),
                )
    return _PHASE_HIST


class Tracer:
    """Aggregate stats + span recording, process-global via get_tracer().

    `enabled` gates aggregation and span recording (off unless the
    caller passes enabled=True or calls enable()); the phase latency
    histogram and the flight-recorder ring stay on regardless — they are
    bounded and cheap, and the flight recorder exists for runs nobody
    thought to trace.
    """

    def __init__(self, enabled: bool = False, max_spans: int = MAX_SPANS):
        self.enabled = bool(enabled)
        self._stats: Dict[str, PhaseStats] = {}
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._spans_dropped = 0  # ring overflow only (timeline is lossy)
        self._attrs_dropped = 0  # allowlist-rejected span attributes
        self._max_spans = max(1, int(max_spans))

    # -- lifecycle ------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self, keep_spans: bool = False) -> None:
        """Clear the aggregate stats (a fresh measurement window).
        keep_spans=True preserves the recorded span stream, for one
        timeline across several stats windows."""
        with self._lock:
            self._stats.clear()
            if not keep_spans:
                self._spans.clear()
                self._spans_dropped = 0
                self._attrs_dropped = 0

    # -- the phase context manager --------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0, **attrs) -> Iterator[None]:
        if not self.enabled:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._observe(name, dt, items)
            return
        clean, dropped = _sanitize_attrs(attrs)
        span = Span(name, self._current_span_id(), items, clean)
        if dropped:
            with self._lock:
                self._attrs_dropped += dropped
        tok = _STACK.set(_STACK.get() + ((self, span),))
        t0 = time.perf_counter()
        # re-stamp t0 where the duration clock starts: the constructor
        # stamped it a few us earlier, and t1 = t0 + dt with mismatched
        # origins would end a parent before its child
        span.t0 = t0 - _T0_PERF
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            _STACK.reset(tok)
            span.t1 = span.t0 + dt
            with self._lock:
                st = self._stats.setdefault(name, PhaseStats())
                st.calls += 1
                st.seconds += dt
                st.items += items
                st.macs += span.macs
                if len(self._spans) < self._max_spans:
                    self._spans.append(span)
                else:
                    self._spans_dropped += 1
            self._observe(name, dt, items)

    def _observe(self, name: str, dt: float, items: int) -> None:
        try:
            _phase_hist().observe(dt, phase=name)
        except Exception:
            pass
        from . import flight

        flight.record("span", name, dur=dt, items=items or None)

    # -- context helpers ------------------------------------------------
    def _top(self):
        """Innermost stack entry owned by THIS tracer (None otherwise)."""
        for tracer, entry in reversed(_STACK.get()):
            if tracer is self:
                return entry
        return None

    def _current_span_id(self) -> Optional[int]:
        top = self._top()
        return top.span_id if top is not None else None

    def current_span(self) -> Optional[Span]:
        """Innermost active REAL span of this tracer on this thread
        (anchors from inherit_phase don't count — they have no clock)."""
        for tracer, entry in reversed(_STACK.get()):
            if tracer is self and isinstance(entry, Span):
                return entry
        return None

    def current_phase(self) -> Optional[str]:
        top = self._top()
        return top.name if top is not None else None

    @contextlib.contextmanager
    def inherit_phase(self, parent) -> Iterator[None]:
        """Attribute work on a worker thread to the submitting thread's
        phase WITHOUT timing it (the submitter's enclosing `phase`
        already owns the wall clock; a timed re-entry would double-count
        seconds). `parent` is a Span (child spans then carry the right
        parent_id across the thread hop), a phase-name string, or None
        (no-op). Used by utils.pipeline."""
        if not self.enabled or parent is None:
            yield
            return
        if isinstance(parent, str):
            anchor = _Anchor(parent, None)
        else:
            anchor = _Anchor(parent.name, parent.span_id)
        tok = _STACK.set(_STACK.get() + ((self, anchor),))
        try:
            yield
        finally:
            _STACK.reset(tok)

    # -- MAC / counter attribution --------------------------------------
    def add_macs(self, macs: float) -> None:
        """Attribute analytic work (utils.roofline formulas) to the
        innermost active phase of this thread — the engine layer calls
        this without knowing which protocol phase it serves."""
        if not self.enabled:
            return
        top = self._top()
        if top is not None:
            top.macs += macs
            if isinstance(top, _Anchor):
                # anchors aren't recorded: credit the aggregate directly
                with self._lock:
                    self._stats.setdefault(top.name, PhaseStats()).macs += macs
            return
        with self._lock:
            self._stats.setdefault("(unphased)", PhaseStats()).macs += macs

    def count(self, name: str, items: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._stats.setdefault(name, PhaseStats())
            st.calls += 1
            st.items += items

    # -- reads -----------------------------------------------------------
    def stats(self) -> Dict[str, PhaseStats]:
        with self._lock:
            return {
                k: PhaseStats(v.calls, v.seconds, v.items, v.macs)
                for k, v in self._stats.items()
            }

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def spans_dropped(self) -> int:
        """Spans lost to ring overflow — 0 means the timeline is
        complete (attrs rejected by the allowlist count separately)."""
        return self._spans_dropped

    def attrs_dropped(self) -> int:
        return self._attrs_dropped

    def report(self) -> str:
        """The stats as a table; MFU against the H100's 16x16-bit MAC
        peak (utils.roofline.H100_PEAK_MACS)."""
        from ..utils.roofline import H100_PEAK_MACS

        peak = H100_PEAK_MACS
        rows = sorted(self.stats().items(), key=lambda kv: -kv[1].seconds)
        if not rows:
            return "(no phases recorded)"
        width = max(len(k) for k, _ in rows)
        lines = [
            f"{'phase':{width}s} {'calls':>6s} {'seconds':>9s} {'items':>8s} "
            f"{'items/s':>10s} {'GMACs':>9s} {'mfu%':>7s}"
        ]
        for name, st in rows:
            lines.append(
                f"{name:{width}s} {st.calls:6d} {st.seconds:9.3f} "
                f"{st.items:8d} {st.items_per_second:10.1f} "
                f"{st.macs / 1e9:9.2f} {100 * st.mfu(peak):7.3f}"
            )
        return "\n".join(lines)

    # -- Chrome-trace / Perfetto export ----------------------------------
    def chrome_trace(self) -> dict:
        """The span stream as a Chrome-trace object (catapult JSON array
        format): complete ("X") events in microseconds, thread-name
        metadata so Perfetto labels the producer and worker tracks, and
        span/parent ids in args for programmatic nesting checks."""
        pid = os.getpid()
        events = [
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": "fsdkr-tpu-torch"},
            }
        ]
        seen_threads = {}
        for sp in self.spans():
            if sp.t1 is None:
                continue
            if sp.tid not in seen_threads:
                seen_threads[sp.tid] = sp.thread_name
                events.append(
                    {
                        "name": "thread_name", "ph": "M", "pid": pid,
                        "tid": sp.tid, "args": {"name": sp.thread_name},
                    }
                )
            args = {"span_id": sp.span_id}
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            if sp.items:
                args["items"] = sp.items
            if sp.macs:
                args["gmacs"] = round(sp.macs / 1e9, 3)
            if sp.attrs:
                args.update(sp.attrs)
            events.append(
                {
                    "name": sp.name,
                    "cat": sp.name.split(".", 1)[0],
                    "ph": "X",
                    "ts": round(sp.t0 * 1e6, 1),
                    "dur": round((sp.t1 - sp.t0) * 1e6, 1),
                    "pid": pid,
                    "tid": sp.tid,
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": "fsdkr-chrome-trace/1",
                "epoch_unix": round(_T0_UNIX, 3),
                "spans_dropped": self._spans_dropped,
                "attrs_dropped": self._attrs_dropped,
            },
        }

    def write_chrome_trace(self, path: str) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def phase(name: str, items: int = 0, **attrs):
    """Module-level shorthand for `get_tracer().phase(...)`."""
    return _TRACER.phase(name, items=items, **attrs)


@contextlib.contextmanager
def torch_profile(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over CPU and CUDA activities around a block, its
    Chrome trace written under `log_dir` (view it in Perfetto or
    chrome://tracing). A no-op when log_dir is None; CUDA activity is
    recorded only where torch sees a card."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"torch_trace.{os.getpid()}.json")
    )
