"""Always-on flight recorder: a bounded ring buffer of the last events
(injected faults, recovery decisions, journal failures), each with its
wall time and thread (an own copy of fsdkr_tpu/telemetry/flight.py,
cut to the ring: `record` and `snapshot`; its dump to a file on an
unhandled exception or SIGTERM belongs to the shard supervisor and is
not ported).

The recorder costs one deque append per event (a deque with maxlen —
appends are atomic under the GIL, no lock on the hot path), so it stays
on. Events never carry operand material: the payload is the same
allowlisted scalars the metric layer accepts
(`registry.sanitize_fields`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import sanitize_fields

__all__ = ["FlightRecorder", "get_flight", "record", "FLIGHT_SCHEMA", "FLIGHT_EVENTS"]

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

    def record(
        self,
        kind: str,
        name: str,
        dur: Optional[float] = None,
        **fields,
    ) -> None:
        th = threading.current_thread()
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


_RECORDER = FlightRecorder()


def get_flight() -> FlightRecorder:
    return _RECORDER


def record(kind: str, name: str, dur: Optional[float] = None, **fields) -> None:
    _RECORDER.record(kind, name, dur=dur, **fields)
