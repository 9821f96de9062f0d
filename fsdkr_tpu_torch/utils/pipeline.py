"""The verifier's schedulers (the JAX package's utils/pipeline.py, cut to
`run_jobs` and `prefetch_tiles`).

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

from typing import Callable, List, Sequence

__all__ = ["run_jobs", "prefetch_tiles"]


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
