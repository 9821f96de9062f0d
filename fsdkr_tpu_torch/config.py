"""Protocol configuration.

The reference fixes its parameters at compile time (`src/lib.rs:26-27`:
PAILLIER_KEY_SIZE=2048, M_SECURITY=256). Here the same knobs are a
runtime config object, plus the port's execution choices: the verifier
backend and the torch device every tensor lives on.

There is no automatic routing: `device="cuda"` on a machine without a
CUDA device raises at the first entry point that needs the device, it
never quietly runs on the host. Tests ask for `device="cpu"` explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProtocolConfig:
    """All security / execution parameters of the refresh protocol.

    paillier_bits: modulus size of every Paillier key and every ring-Pedersen
        / h1-h2-N-tilde modulus (reference: PAILLIER_KEY_SIZE=2048,
        `src/lib.rs:26`). The moduli acceptance gate admits
        [paillier_bits-1, paillier_bits] bit moduli
        (`src/refresh_message.rs:385-391`).
    m_security: number of binary-challenge rounds of the ring-Pedersen
        parameter proof (reference: M_SECURITY=256, `src/lib.rs:27`).
    correct_key_rounds: number of Fiat-Shamir challenges of the Paillier
        correct-key proof (zk-paillier uses 11).
    backend: "cuda" (batched verification and the protocol's batched EC
        through the device kernels, the default) or "host" (the
        pure-Python oracle).
    device: torch device of the batched columns: "cuda" (default) or "cpu"
        (the kernels' plain PyTorch versions; what the CPU tests use).
    hash_alg: Fiat-Shamir digest, any name in core.transcript._HASHES.
    curve: only "secp256k1".
    """

    paillier_bits: int = 2048
    m_security: int = 256
    correct_key_rounds: int = 11
    backend: str = "cuda"
    device: str = "cuda"
    hash_alg: str = "sha256"
    curve: str = "secp256k1"

    def __post_init__(self):
        # Share recovery is only exact when the Lagrange-weighted plaintext
        # sum (t+1 terms, each < q^2 ~ 2^512 for secp256k1) cannot wrap mod
        # the Paillier modulus; 640 bits leaves 128 bits of committee-size
        # headroom. collect() additionally checks the recovered share
        # against the Feldman commitments.
        if self.paillier_bits < 640:
            raise ValueError("paillier_bits must be >= 640 for exact share recovery")
        if self.paillier_bits % 2:
            raise ValueError("paillier_bits must be even")
        from .core.transcript import digest_bytes

        if not 0 < self.m_security <= 8 * digest_bytes(self.hash_alg):
            raise ValueError(
                f"m_security must be in (0, {8 * digest_bytes(self.hash_alg)}] "
                f"for hash_alg={self.hash_alg}"
            )
        if self.curve != "secp256k1":
            raise ValueError("the protocol layer is specialized to secp256k1")
        if self.backend not in ("cuda", "host"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}")

    def torch_device(self):
        """The torch.device of the batched columns. Raises when
        device="cuda" and no CUDA device is present: the port has no
        host fallback."""
        import torch

        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ProtocolConfig(device='cuda') but torch finds no CUDA "
                "device; pass device='cpu' to run the plain versions"
            )
        return torch.device(self.device)

    @property
    def prime_bits(self) -> int:
        return self.paillier_bits // 2

    @property
    def key_material_pool_key(self) -> tuple:
        """Pool key of the precompute key-material pool: everything a
        pooled (ek, dk, correct-key proof, ring-Pedersen statement and
        proof) bundle depends on, so sessions with other parameters never
        take each other's key material. The device is not part of it: the
        bundle's values are the same on any device."""
        return (
            self.paillier_bits,
            self.m_security,
            self.correct_key_rounds,
            self.hash_alg,
        )


DEFAULT_CONFIG = ProtocolConfig()

# Small-parameter config for fast tests: 768-bit Paillier moduli are the
# smallest size at which share recovery is still exact while keeping the
# CPU runs fast. Production remains 2048/256.
TEST_CONFIG = ProtocolConfig(
    paillier_bits=768, m_security=32, correct_key_rounds=3, device="cpu"
)
