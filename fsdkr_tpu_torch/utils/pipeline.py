"""The verifier's schedulers and the precompute pools' producer thread
(the JAX package's utils/pipeline.py, cut to `run_jobs`,
`prefetch_tiles` and `BackgroundProducer`).

The JAX package runs independent launch sets (the RANGEOPT range
engines beside the PDL columns) as thunks on a small thread pool; at one
worker it runs them in order. The port runs them in order: every thunk
writes only its own result slots, so the results are the same in any
order, and each of the port's thunks already puts all of its groups
into one launch per kernel.

`prefetch_tiles` double-buffers the memory plan's tiles
(backend.memplan): tile k+1's host staging runs on one background thread
while tile k's launches run on the calling thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

__all__ = ["run_jobs", "prefetch_tiles", "BackgroundProducer"]


def run_jobs(jobs: Sequence[Callable]) -> List:
    """Run independent thunks one after another; their results in
    submission order."""
    return [job() for job in jobs]


def prefetch_tiles(spans, prepare: Callable, consume: Callable) -> None:
    """consume(prepare(*span)) for each span, in span order, with the next
    span's `prepare` (host-only staging: domain gates, Fiat-Shamir hashing;
    read-only over shared state) running on one background thread while
    the current span's `consume` (its launches and accumulator updates)
    runs on the calling thread. At most two tiles' prepared state is live
    at once, the plan's in-flight factor. `consume` always runs on the
    calling thread in span order, so the result is the sequential loop's.
    An exception propagates from the first span, in order, that raised."""
    spans = list(spans)
    if len(spans) <= 1:
        for s in spans:
            consume(prepare(*s))
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(prepare, *spans[0])
        for i in range(len(spans)):
            prep = fut.result()
            if i + 1 < len(spans):
                fut = ex.submit(prepare, *spans[i + 1])
            consume(prep)


class BackgroundProducer:
    """One daemon thread pulling work off a `step` callable: the producer
    half of the precompute offline/online split (`precompute.producer`
    builds `step` from the pool targets).

    `step()` performs one bounded unit of production and returns True if
    it did work; the thread loops while steps report work, then parks
    until `kick()`. An exception in `step` is counted (`errors`) and
    parks the thread, as in the JAX package; unlike there it is not
    forgotten: the first one is kept and `stop()` raises it (`error()`
    reads it). On the card a step launches kernels, and a kernel that
    fails to build or launch there must not turn every later distribute
    quietly inline.
    """

    def __init__(self, step: Callable[[], bool], name: str = "fsdkr-precompute"):
        self._step = step
        self._name = name
        self._wake = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._thread_stop: Optional[threading.Event] = None
        self._error: Optional[BaseException] = None
        self.errors = 0
        # occupancy accounting: productive seconds against wall since the
        # first start. Single writer (the producer thread).
        self.busy_seconds = 0.0
        self.steps = 0
        self.started_at: Optional[float] = None

    def _loop(self, stop: threading.Event) -> None:
        if self.started_at is None:
            self.started_at = time.monotonic()
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                worked = self._step()
            except Exception as e:  # noqa: BLE001 - kept, raised by stop()
                self.errors += 1
                if self._error is None:
                    self._error = e
                worked = False
            if worked:
                self.busy_seconds += time.monotonic() - t0
                self.steps += 1
            else:
                self._wake.wait(timeout=60.0)
                self._wake.clear()

    def occupancy(self) -> float:
        """Fraction of wall time (since first start) spent producing."""
        if self.started_at is None:
            return 0.0
        wall = time.monotonic() - self.started_at
        return self.busy_seconds / wall if wall > 0 else 0.0

    def kick(self) -> None:
        """Start the thread if needed and wake it (idempotent, cheap)."""
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                # each thread gets its OWN stop event: a stop() racing this
                # kick() signals the old thread's event only, so two loops
                # never run side by side
                self._thread_stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._loop, args=(self._thread_stop,),
                    name=self._name, daemon=True,
                )
                self._thread.start()
        self._wake.set()

    def error(self) -> Optional[BaseException]:
        """The first exception a step raised, or None."""
        return self._error

    def stop(self, timeout: float = 5.0) -> None:
        """Stop and join the thread; then raise the first exception a
        step raised, if any (it is cleared, with the error count kept)."""
        with self._lock:
            t = self._thread
            stop = self._thread_stop
            self._thread = None
            self._thread_stop = None
            if stop is not None:
                stop.set()
        if t is not None:
            self._wake.set()
            t.join(timeout=timeout)
        err, self._error = self._error, None
        if err is not None:
            raise err

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()
