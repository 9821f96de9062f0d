"""One process-global metrics registry: labeled counters, gauges, and
fixed-bucket histograms, and their Prometheus text exposition (an own
copy of fsdkr_tpu/telemetry/registry.py, with `prometheus_text` from
its `export.py`; the JSON export, the peak-RSS gauge and the metrics
dump file are not ported).

Design points:

- **Histograms retain no samples.** Observations land in fixed buckets
  (default: a log-spaced latency ladder 100 us .. 120 s); p50/p95/p99
  are interpolated from the bucket counts at snapshot time.
- **Label values are allowlisted scalars** (short strings, small ints,
  floats, bools). A big integer — a modulus, a share, a pool entry —
  is rejected with ValueError at the call site: telemetry must be
  structurally unable to exfiltrate witness material.
- **Function gauges** let subsystems with their own bounded state (the
  precompute pools, the background producer) expose point-in-time
  readings: the callable is evaluated at snapshot time, and a raising
  callable yields no sample rather than killing the snapshot.
- `reset()` on a metric (or `reset_window()` on the registry) zeroes
  counters/histograms for a fresh measurement window.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "SCHEMA_VERSION",
    "DEFAULT_LATENCY_BUCKETS",
    "check_label_value",
    "sanitize_fields",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "counter",
    "gauge",
    "histogram",
    "prometheus_text",
]

# bumped on any breaking change to the snapshot layout; consumers
# (scripts/digest_results.py, dashboards) key on it
SCHEMA_VERSION = "fsdkr-telemetry/1"

# log-spaced latency ladder: 100 us .. 120 s (the span between one
# modmul launch and a full cold n=256 collect), ~2.5x steps so p99
# interpolation stays within ~the step factor of the true value
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_STR_MAX = 120
_LABEL_INT_MAX = 1 << 63  # a value this wide is operand material, not a label


def check_label_value(v) -> str:
    """Validate one label value against the telemetry secrecy allowlist
    (scalars only, small ints only) and return its string form. Raises
    ValueError on anything that could smuggle operand material."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        if abs(v) >= _LABEL_INT_MAX:
            raise ValueError(
                "label value too wide for telemetry (big ints are operand "
                "material — SECURITY.md 'Telemetry discipline')"
            )
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError("non-finite label value")
        return repr(v)
    if isinstance(v, str):
        if len(v) > _LABEL_STR_MAX:
            raise ValueError("label string too long for telemetry")
        return v
    raise ValueError(
        f"label values must be small scalars, not {type(v).__name__}"
    )


def sanitize_fields(fields: Dict[str, object]):
    """Allowlist-filter an attribute/field dict against the telemetry
    secrecy rule (the ONE enforcement point shared by span attrs and
    flight-recorder fields): None values are skipped, values failing
    `check_label_value` are dropped and counted, keys are stringified
    and truncated. Returns (clean dict or None, dropped count)."""
    if not fields:
        return None, 0
    out = {}
    dropped = 0
    for k, v in fields.items():
        if v is None:
            continue
        try:
            check_label_value(v)
        except ValueError:
            dropped += 1
            continue
        out[str(k)[:64]] = v
    return (out or None), dropped


class _Metric:
    """Shared plumbing: children keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _labelkey(self, kw: Dict[str, object]) -> Tuple[str, ...]:
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(kw)}"
            )
        return tuple(check_label_value(kw[k]) for k in self.labelnames)

    def _child(self, key: Tuple[str, ...]):
        with self._lock:
            ch = self._children.get(key)
            if ch is None:
                ch = self._children[key] = self._new_child()
            return ch

    def _new_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def labels(self, **kw):
        return self._child(self._labelkey(kw))

    def reset(self) -> None:
        with self._lock:
            self._children.clear()

    def snapshot_values(self) -> List[dict]:
        with self._lock:
            items = list(self._children.items())
        out = []
        for key, ch in items:
            rec = {"labels": dict(zip(self.labelnames, key))}
            rec.update(ch.snapshot())  # type: ignore[attr-defined]
            out.append(rec)
        return out


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"value": self._value}


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n: float = 1.0, **labels) -> None:
        self._child(self._labelkey(labels)).inc(n)

    def value(self, **labels) -> float:
        key = self._labelkey(labels)
        with self._lock:
            ch = self._children.get(key)
        return ch.value if ch is not None else 0.0


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"value": self._value}


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._fn: Optional[Callable[[], float]] = None
        self._labeled_fn: Optional[Callable[[], Dict[tuple, float]]] = None

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float, **labels) -> None:
        self._child(self._labelkey(labels)).set(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        self._child(self._labelkey(labels)).inc(n)

    def dec(self, n: float = 1.0, **labels) -> None:
        self._child(self._labelkey(labels)).dec(n)

    def set_function(self, fn: Callable[[], float]) -> "Gauge":
        """Unlabeled gauge evaluated lazily at snapshot time (for
        subsystems that already hold their state — cache sizes, pool
        depths). A raising fn yields no sample, never a dead snapshot."""
        if self.labelnames:
            raise ValueError("set_function is for unlabeled gauges")
        self._fn = fn
        return self

    def set_labeled_function(
        self, fn: Callable[[], Dict[tuple, float]]
    ) -> "Gauge":
        """Labeled variant: fn returns {label-value-tuple: value} with
        tuples matching this gauge's labelnames order."""
        if not self.labelnames:
            raise ValueError("set_labeled_function needs labelnames")
        self._labeled_fn = fn
        return self

    def snapshot_values(self) -> List[dict]:
        if self._fn is not None:
            try:
                return [{"labels": {}, "value": float(self._fn())}]
            except Exception:
                return []
        if self._labeled_fn is not None:
            try:
                vals = self._labeled_fn()
            except Exception:
                return []
            out = []
            for key, v in vals.items():
                key = tuple(check_label_value(k) for k in key)
                out.append(
                    {"labels": dict(zip(self.labelnames, key)),
                     "value": float(v)}
                )
            return out
        return super().snapshot_values()


class _HistogramChild:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: Tuple[float, ...]):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def _percentile_from(self, counts: List[int], total: int, q: float) -> float:
        """q in (0, 1) over an already-copied bucket state: linear
        interpolation inside the bucket that crosses the q-quantile
        rank. No samples -> 0.0; ranks landing in the +inf bucket clamp
        to the last finite bound (the histogram's honest resolution
        limit)."""
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo_cum = cum
            cum += c
            if cum >= rank:
                if i >= len(self._bounds):  # +inf bucket
                    return self._bounds[-1]
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i]
                frac = (rank - lo_cum) / c
                return lo + (hi - lo) * frac
        return self._bounds[-1]

    def snapshot(self) -> dict:
        # ONE copy under the lock: buckets, count, sum, and all three
        # percentiles describe the same instant — a concurrent observe()
        # must not make the exported record internally inconsistent
        # (percentiles must be reproducible from the embedded buckets)
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        cum = 0
        buckets = []
        for bound, c in zip(self._bounds, counts):
            cum += c
            buckets.append([bound, cum])
        return {
            "count": n,
            "sum": round(s, 9),
            "buckets": buckets,  # cumulative, +inf bucket implied by count
            "p50": round(self._percentile_from(counts, n, 0.50), 9),
            "p95": round(self._percentile_from(counts, n, 0.95), 9),
            "p99": round(self._percentile_from(counts, n, 0.99), 9),
        }


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS))
        if not bounds or any(
            b <= a for a, b in zip(bounds, bounds[1:])
        ):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bounds

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, **labels) -> None:
        self._child(self._labelkey(labels)).observe(v)


class Registry:
    """Process-global named-metric store. `counter`/`gauge`/`histogram`
    are get-or-create (re-registering with a different type, label set,
    or explicit bucket ladder is a programming error and raises;
    `buckets=None` means "no opinion" and fetches the existing histogram
    whatever its ladder — the accessor idiom)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type/labels"
                    )
                b = kw.get("buckets")
                if b is not None and tuple(sorted(b)) != m.buckets:
                    raise ValueError(
                        f"metric {name!r} re-registered with different "
                        f"buckets"
                    )
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """The one structured read: every metric's labeled samples under
        a schema version (histograms with cumulative buckets and
        interpolated p50/p95/p99)."""
        out: Dict[str, dict] = {}
        for m in self.metrics():
            out[m.name] = {
                "type": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "values": m.snapshot_values(),
            }
        return {"schema": SCHEMA_VERSION, "metrics": out}

    def reset_window(self, names: Optional[Iterable[str]] = None) -> None:
        """Zero counters and histograms (all, or just `names`) for a
        fresh measurement window. Gauges keep their readings — they are
        point-in-time state, not window accumulation."""
        for m in self.metrics():
            if names is not None and m.name not in names:
                continue
            if m.kind in ("counter", "histogram"):
                m.reset()


_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def counter(name, help="", labelnames=()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def _fmt_labels(labels: dict, extra: Optional[tuple] = None) -> str:
    parts = [
        f'{k}="{_escape(str(v))}"' for k, v in labels.items()
    ]
    if extra is not None:
        parts.append(f'{extra[0]}="{_escape(str(extra[1]))}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def prometheus_text(snap: Optional[dict] = None) -> str:
    """Render a snapshot (default: the live registry's) as Prometheus
    text exposition v0.0.4: counters get a `_total`-suffixed sample when
    the name does not already carry one, histograms emit cumulative
    `_bucket{le=...}` samples plus `_sum` and `_count`, and function
    gauges are evaluated now."""
    snap = snap or _REGISTRY.snapshot()
    lines = [f"# fsdkr telemetry schema {snap.get('schema', '?')}"]
    for name, m in sorted(snap.get("metrics", {}).items()):
        kind = m.get("type", "untyped")
        sample_name = name
        if kind == "counter" and not name.endswith("_total"):
            sample_name = name + "_total"
        if m.get("help"):
            lines.append(f"# HELP {sample_name} {_escape(m['help'])}")
        lines.append(f"# TYPE {sample_name} {kind}")
        for rec in m.get("values", []):
            labels = rec.get("labels", {})
            if kind == "histogram":
                cum = 0
                for le, cum in rec.get("buckets", []):
                    lines.append(
                        f"{name}_bucket{_fmt_labels(labels, ('le', le))} "
                        f"{_fmt_value(cum)}"
                    )
                lines.append(
                    f"{name}_bucket{_fmt_labels(labels, ('le', '+Inf'))} "
                    f"{_fmt_value(rec.get('count', 0))}"
                )
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(rec.get('sum', 0.0))}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} "
                    f"{_fmt_value(rec.get('count', 0))}"
                )
            else:
                lines.append(
                    f"{sample_name}{_fmt_labels(labels)} "
                    f"{_fmt_value(rec.get('value', 0.0))}"
                )
    return "\n".join(lines) + "\n"
