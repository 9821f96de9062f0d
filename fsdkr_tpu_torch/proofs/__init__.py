"""Zero-knowledge proof layer: the five proof systems a refresh round
proves and verifies.

- alice_range: Paillier ciphertext encrypts a value < q^3 (slack range)
  — reference `src/range_proofs.rs` AliceProof.
- pdl_slack: ciphertext and EC point hide the same x — reference
  `src/zk_pdl_with_slack.rs`.
- ring_pedersen: well-formedness of ring-Pedersen parameters (S = T^lambda)
  — reference `src/ring_pedersen_proof.rs`.
- composite_dlog: discrete log over Z_N-tilde^* (zk-paillier
  CompositeDLogProof equivalent).
- correct_key: Paillier key correctness via N-th roots (zk-paillier
  NiCorrectKeyProof equivalent).

Every verifier here is the host oracle; the batched verifier in
`backend.cuda_verifier` evaluates the same equations on the device.
"""

from .composite_dlog import DLogStatement, CompositeDLogProof
from .alice_range import AliceProof
from .pdl_slack import PDLwSlackStatement, PDLwSlackWitness, PDLwSlackProof
from .ring_pedersen import RingPedersenStatement, RingPedersenWitness, RingPedersenProof
from .correct_key import NiCorrectKeyProof, SALT_STRING

__all__ = [
    "DLogStatement",
    "CompositeDLogProof",
    "AliceProof",
    "PDLwSlackStatement",
    "PDLwSlackWitness",
    "PDLwSlackProof",
    "RingPedersenStatement",
    "RingPedersenWitness",
    "RingPedersenProof",
    "NiCorrectKeyProof",
    "SALT_STRING",
]
