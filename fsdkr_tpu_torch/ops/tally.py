"""The kernel wrappers' launch counters, safe under concurrent callers.

Each wrapper adds one launch where it launches its kernel and nowhere
else (`count`). The serving layer launches from several threads at once
(its workers, its launcher, the background producer), so a count takes a
lock. A thread inside `apart(label)` counts its launches under that
label instead of the wrapper's own counters: the background producer
runs inside `apart("producer")`, so a session's launch table is the
counters' difference around it, whatever the producer does meanwhile.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

__all__ = ["count", "apart", "read", "shapes", "reset"]

_LOCK = threading.Lock()
_LOCAL = threading.local()
# label -> {wrapper: [launches, {shape: launches}]}
_APART: Dict[str, Dict[object, list]] = {}


def count(fn, shape) -> None:
    """One launch of wrapper `fn` at `shape`."""
    label = getattr(_LOCAL, "label", None)
    with _LOCK:
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


def reset(fns) -> None:
    """Zero `fns`' counters, their shapes and their launches apart."""
    with _LOCK:
        for fn in fns:
            fn.launches = 0
            fn.shapes = {}
            for by_fn in _APART.values():
                by_fn.pop(fn, None)
