"""Process-wide helpers: the bytes-budgeted precompute cache (`lru`)."""
