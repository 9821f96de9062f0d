"""Always-on flight recorder: a bounded ring buffer of the last events
(injected faults, recovery decisions, journal failures, shard deaths),
each with its wall time and thread, written to a file on demand, on an
unhandled exception or on SIGTERM (an own copy of
fsdkr_tpu/telemetry/flight.py).

The recorder costs one deque append per event (a deque with maxlen —
appends are atomic under the GIL, no lock on the hot path), so it stays
on. The dump's destination is always explicit: `dump(path)` writes
there; `install(path)` names the destination of the crash hooks and of
`dump()` without a path (the JAX package reads FSDKR_FLIGHT for it; the
port reads no environment). `install` chains `sys.excepthook` and the
SIGTERM handler: both write the dump and then defer to the previous
handler / default behavior, so the process still dies the way it would
have — it just leaves a postmortem. A shard of the supervisor dumps on
every heartbeat, since SIGKILL is uncatchable.

Events never carry operand material: the payload is the same
allowlisted scalars the metric layer accepts
(`registry.sanitize_fields`), and an exception's text is scrubbed of
wide decimal and hex runs before it is recorded.
"""

from __future__ import annotations

import json
import os
import re
import signal
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import sanitize_fields

__all__ = [
    "FlightRecorder",
    "get_flight",
    "record",
    "dump",
    "install",
    "handle_exception",
    "FLIGHT_SCHEMA",
    "FLIGHT_EVENTS",
]

FLIGHT_SCHEMA = "fsdkr-flight/1"
FLIGHT_EVENTS = 4096  # ring length (the JAX package's default)


def _sanitize(fields: Dict[str, object]) -> Optional[Dict[str, object]]:
    """Allowlisted scalars only; a disallowed value is dropped silently —
    the recorder must never raise on the hot path, and a wide int is
    exactly what must not land in a postmortem."""
    return sanitize_fields(fields)[0]


class FlightRecorder:
    def __init__(self, cap: int = FLIGHT_EVENTS):
        self._events: deque = deque(maxlen=max(64, cap))
        self._recorded = 0  # lifetime count (the ring keeps the tail)
        self._t0 = time.time()

    def record(
        self,
        kind: str,
        name: str,
        dur: Optional[float] = None,
        **fields,
    ) -> None:
        th = threading.current_thread()
        self._recorded += 1  # benign race: a diagnostic counter
        self._events.append(
            (
                time.time(),
                th.name,
                kind,
                name,
                None if dur is None else round(dur, 6),
                _sanitize(fields),
            )
        )

    def snapshot(self) -> List[dict]:
        out = []
        for ts, thread, kind, name, dur, fields in list(self._events):
            rec = {
                "ts": round(ts, 6),
                "thread": thread,
                "kind": kind,
                "name": name,
            }
            if dur is not None:
                rec["dur_s"] = dur
            if fields:
                rec["fields"] = fields
            out.append(rec)
        return out

    def clear(self) -> None:
        self._events.clear()
        self._recorded = 0

    def dump(
        self,
        path: str,
        reason: str = "manual",
        include_metrics: bool = True,
    ) -> str:
        """Write the ring (plus a current metrics snapshot — a postmortem
        wants the counter state too) to `path`, atomically; returns the
        path. include_metrics=False skips the registry snapshot — the
        events-only fallback for contexts where metric locks may be
        unavailable (see _dump_on_signal)."""
        metrics = None
        if include_metrics:
            try:
                from .registry import get_registry

                metrics = get_registry().snapshot()
            except Exception:
                metrics = None
        doc = {
            "schema": FLIGHT_SCHEMA,
            "pid": os.getpid(),
            "reason": reason,
            "started_at": round(self._t0, 3),
            "dumped_at": round(time.time(), 3),
            "events_recorded": self._recorded,
            "events": self.snapshot(),
            "metrics": metrics,
        }
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=None, separators=(",", ":"))
        os.replace(tmp, path)
        return str(path)


_RECORDER = FlightRecorder()
_DEST: Dict[str, Optional[str]] = {"path": None}  # install()'s destination


def get_flight() -> FlightRecorder:
    return _RECORDER


def record(kind: str, name: str, dur: Optional[float] = None, **fields) -> None:
    _RECORDER.record(kind, name, dur=dur, **fields)


def dump(path: Optional[str] = None, reason: str = "manual") -> Optional[str]:
    """Dump to `path`, or to install()'s destination; None when neither
    names one."""
    path = path or _DEST["path"]
    if not path:
        return None
    return _RECORDER.dump(str(path), reason=reason)


def _dump_on_signal(reason: str, timeout: float = 2.0) -> None:
    """Dump from a signal handler without risking a deadlock. The
    handler interrupts the main thread between bytecodes — possibly
    INSIDE a registry critical section (metric locks are plain
    non-reentrant Locks, and function gauges call into subsystems with
    their own locks), so a direct dump() could block forever on a lock
    the interrupted frame itself holds. Run the full dump on a watchdog
    thread; if it cannot finish within `timeout`, write an events-only
    dump instead — the ring is a plain deque and needs no locks."""
    path = _DEST["path"]
    if not path:
        return

    def work():
        try:
            _RECORDER.dump(path, reason=reason)
        except Exception:
            pass

    t = threading.Thread(target=work, daemon=True, name="fsdkr-flight-dump")
    t.start()
    t.join(timeout)
    if t.is_alive():
        _RECORDER.dump(path, reason=f"{reason}:events-only", include_metrics=False)


_INSTALL_LOCK = threading.Lock()
_INSTALLED = False


_WIDE_DEC = re.compile(r"\d{16,}")
_WIDE_HEX = re.compile(r"(?:0x)?[0-9a-fA-F]{32,}")


def _scrub_detail(msg: str) -> str:
    """Exception messages are free text and can interpolate operand
    material (a library ValueError embedding its argument); wide
    decimal/hex runs ARE operand material in this codebase, so redact
    them before the message reaches a persisted postmortem — same
    threshold philosophy as the int allowlist (2^63 ~ 19 digits)."""
    msg = _WIDE_DEC.sub("<wide-int>", msg)
    msg = _WIDE_HEX.sub("<wide-hex>", msg)
    return msg[:120]


def handle_exception(exc_type, exc, tb) -> None:
    """The excepthook body, callable directly (tests simulate a crash by
    invoking it): record the exception as the final event and dump to
    install()'s destination; the hook then defers to the previous
    excepthook."""
    try:
        _RECORDER.record(
            "crash", exc_type.__name__, detail=_scrub_detail(str(exc))
        )
        dump(reason=f"unhandled:{exc_type.__name__}")
    except Exception:
        pass


def install(path) -> bool:
    """Make `path` the crash dump's destination and chain the excepthook
    and SIGTERM handler (the hooks once a process; a later call only
    moves the destination). Returns True."""
    global _INSTALLED
    with _INSTALL_LOCK:
        _DEST["path"] = str(path)
        if _INSTALLED:
            return True

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            handle_exception(exc_type, exc, tb)
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook

        try:
            prev_sig = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                try:
                    _RECORDER.record("signal", "SIGTERM")
                    _dump_on_signal(reason="SIGTERM")
                except Exception:
                    pass
                if callable(prev_sig):
                    prev_sig(signum, frame)
                elif prev_sig is signal.SIG_IGN:
                    # the process had SIGTERM ignored (possibly
                    # inherited across exec) — dump but stay alive
                    return
                else:
                    # restore the default disposition and re-raise so the
                    # process still dies with the standard SIGTERM status
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            pass  # not the main thread: excepthook coverage only
        _INSTALLED = True
        return True
