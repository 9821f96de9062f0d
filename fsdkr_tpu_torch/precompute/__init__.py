"""Offline/online split for distribute(): input-independent precompute
pools, filled by `prefill` for one committee and taken by that
committee's next distribute.

`pools` holds the bounded single-use secret store and its hygiene rules;
`producer` the per-kind constructors, the target registry, `prefill` and
the background producer thread that the serving layer starts. An own
copy of fsdkr_tpu/precompute/.
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
    KEYS_POOL_OWNER,
    claim,
    clear_targets,
    committee_owner,
    committee_targets,
    current_registration_owner,
    deficit_total,
    invalidate_owner,
    invalidate_targets,
    kick,
    owner_scope,
    prefill,
    produce_batch,
    produce_enc,
    produce_for,
    produce_keys,
    producer_error,
    producer_running,
    register_committee,
    register_targets,
    release,
    replace_targets,
    retarget_committee,
    stop_background,
    suspend_targets,
    target_keys,
)
