"""Offline/online split for distribute(): input-independent precompute
pools, filled by `prefill` for one committee and taken by that
committee's next distribute.

`pools` holds the bounded single-use secret store and its hygiene rules;
`producer` the per-kind constructors, `prefill` and the bookkeeping of
prefilled committees. An own copy of fsdkr_tpu/precompute/, without its
background producer.
"""

from .pools import (  # noqa: F401
    PoolEntry,
    PrecomputeStore,
    clear_pools,
    get_store,
    precompute_stats,
    put,
    secret_values,
    stats_reset,
    take,
)
from . import producer  # noqa: F401
from .producer import (  # noqa: F401
    claim,
    clear_committees,
    committee_owner,
    committee_targets,
    invalidate_owner,
    prefill,
    produce_enc,
    produce_for,
    produce_keys,
    release,
)
