"""The verifier's column scheduler (the JAX package's utils/pipeline.py,
cut to `run_jobs`).

The JAX package runs independent launch sets (the RANGEOPT range
engines beside the PDL columns) as thunks on a small thread pool; at one
worker it runs them in order. The port runs them in order: every thunk
writes only its own result slots, so the results are the same in any
order, and each of the port's thunks already puts all of its groups
into one launch per kernel.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

__all__ = ["run_jobs"]


def run_jobs(jobs: Sequence[Callable]) -> List:
    """Run independent thunks one after another; their results in
    submission order."""
    return [job() for job in jobs]
