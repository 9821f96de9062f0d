"""The kernel wrappers' launch counters, safe under concurrent callers.

Each wrapper adds one launch where it launches its kernel and nowhere
else (`count`). The serving layer launches from several threads at once
(its workers, its launcher, the background producer), so a count takes a
lock. A thread inside `apart(label)` counts its launches under that
label instead of the wrapper's own counters: the background producer
runs inside `apart("producer")`, so a session's launch table is the
counters' difference around it, whatever the producer does meanwhile.

While the span tracer is enabled (telemetry.spans), each launch is also
counted under the innermost phase of the launching thread (`by_phase`):
which phases launched kernels, for the roofline's check that each of
them carries MACs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

__all__ = ["count", "apart", "read", "shapes", "reset", "by_phase", "reset_phases"]

_LOCK = threading.Lock()
_LOCAL = threading.local()
# label -> {wrapper: [launches, {shape: launches}]}
_APART: Dict[str, Dict[object, list]] = {}
# phase name -> launches, while the tracer is enabled
_BY_PHASE: Dict[str, int] = {}


def _traced_phase() -> Optional[str]:
    from ..telemetry.spans import get_tracer

    tracer = get_tracer()
    return tracer.current_phase() if tracer.enabled else None


def count(fn, shape) -> None:
    """One launch of wrapper `fn` at `shape`."""
    label = getattr(_LOCAL, "label", None)
    phase = _traced_phase()
    with _LOCK:
        if phase is not None:
            _BY_PHASE[phase] = _BY_PHASE.get(phase, 0) + 1
        if label is None:
            fn.launches += 1
            fn.shapes[shape] = fn.shapes.get(shape, 0) + 1
        else:
            ent = _APART.setdefault(label, {}).setdefault(fn, [0, {}])
            ent[0] += 1
            ent[1][shape] = ent[1].get(shape, 0) + 1


@contextlib.contextmanager
def apart(label: str):
    """This thread's launches inside the block count under `label`."""
    prev = getattr(_LOCAL, "label", None)
    _LOCAL.label = label
    try:
        yield
    finally:
        _LOCAL.label = prev


def read(fn, label: Optional[str] = None) -> int:
    """`fn`'s launches: its own counter, or those counted under `label`."""
    with _LOCK:
        if label is None:
            return fn.launches
        return _APART.get(label, {}).get(fn, [0])[0]


def shapes(fn, label: Optional[str] = None) -> Dict:
    """`fn`'s launches by shape: its own, or those counted under `label`."""
    with _LOCK:
        if label is None:
            return dict(fn.shapes)
        return dict(_APART.get(label, {}).get(fn, [0, {}])[1])


def by_phase() -> Dict[str, int]:
    """Launches by the innermost traced phase that made them."""
    with _LOCK:
        return dict(_BY_PHASE)


def reset_phases() -> None:
    with _LOCK:
        _BY_PHASE.clear()


def reset(fns) -> None:
    """Zero `fns`' counters, their shapes and their launches apart."""
    with _LOCK:
        for fn in fns:
            fn.launches = 0
            fn.shapes = {}
            for by_fn in _APART.values():
                by_fn.pop(fn, None)
