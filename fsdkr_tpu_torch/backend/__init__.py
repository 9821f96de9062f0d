"""Verification backends.

The reference verifies every proof serially inside `collect`'s O(n^2) loop
(`src/refresh_message.rs:330-350`). Here all proof instances of a collect
are gathered into per-family batches and dispatched to a backend:

- "host": the pure-Python oracle — verifies each instance with the proofs
  module.
- "cuda": batched multi-modulus modexp / modmul columns and the EC
  checks as MSMs through the device kernels on `ProtocolConfig.device`
  (backend.cuda_verifier).

Both return *per-instance verdicts* (never early-exit), so identifiable
abort attribution is preserved exactly (`src/error.rs` semantics).
"""

from .batch_verifier import BatchVerifier, HostBatchVerifier, TracedVerifier, get_backend

__all__ = ["BatchVerifier", "HostBatchVerifier", "TracedVerifier", "get_backend"]
