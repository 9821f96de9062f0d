"""The reference's four protocol scenarios (`src/test.rs`, the JAX
package's tests/test_protocol.py) on the port alone, at TEST_CONFIG's
parameters (768-bit Paillier, M=32, 3 correct-key rounds), sized down:

- reconstruct-equality at (t, n) = (1, 3), with the pk_vec length pin;
- sign -> rotate -> sign at (1, 3), quorums [1, 2], [2, 3], [1, 3];
- remove -> sign -> rotate -> sign at (1, 4), removing [1], then [1, 2];
- add-party-with-permute at (1, 5): parties 2 and 5 leave, the survivors
  are remapped {1: 4, 3: 1, 4: 3}, two joiners take indices 2 and 5, the
  secret survives, and a quorum holding both joiners signs.

The first three run on the port's host backend, as the JAX package runs
them on its host backend: a collect on the plain versions costs about
20 s at this size, and the device route of distribute and collect is
held against the JAX package in tests/test_torch_refresh.py. The
add-party scenario, which this slice adds, also runs on TEST_CONFIG
itself (the cuda backend's plain versions, RLC on). One case holds the
port's ecdsa_verify against the JAX package's on the same signatures.
"""

import dataclasses

import pytest
import torch

from fsdkr_tpu_torch import TEST_CONFIG
from fsdkr_tpu_torch.core import vss
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, Scalar
from fsdkr_tpu_torch.protocol import (
    JoinMessage,
    RefreshMessage,
    ecdsa_verify,
    simulate_dkr,
    simulate_dkr_removal,
    simulate_keygen,
    simulate_offline_stage,
    simulate_signing,
)
from fsdkr_tpu_torch.protocol.signing import SignManual, message_scalar

HOST = dataclasses.replace(TEST_CONFIG, backend="host")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reconstruct_from(keys, t, n, count):
    params = vss.ShamirSecretSharing(t, n)
    shares = [k.keys_linear.x_i for k in keys[:count]]
    return vss.reconstruct(params, list(range(count)), shares)


def test_reconstruct_equality():
    """Same secret, new shares (reference src/test.rs:34-67); pk_vec
    stays exactly n long and matches x_i * G per party (quirk 1's pin)."""
    t, n = 1, 3
    keys = simulate_keygen(t, n, HOST)
    old_x = [k.keys_linear.x_i for k in keys]
    old_secret = reconstruct_from(keys, t, n, t + 1)

    simulate_dkr(keys, HOST)

    assert reconstruct_from(keys, t, n, t + 1).v == old_secret.v
    assert [s.v for s in old_x] != [k.keys_linear.x_i.v for k in keys]
    for k in keys:
        assert len(k.pk_vec) == n
        assert k.pk_vec == keys[0].pk_vec
        assert k.pk_vec[k.i - 1] == GENERATOR * k.keys_linear.x_i


def test_sign_rotate_sign():
    """(reference src/test.rs:69-80)"""
    keys = simulate_keygen(1, 3, HOST)
    simulate_signing(simulate_offline_stage(keys, [1, 2]), b"ZenGo")
    simulate_dkr(keys, HOST)
    simulate_signing(simulate_offline_stage(keys, [2, 3]), b"ZenGo")
    simulate_dkr(keys, HOST)
    simulate_signing(simulate_offline_stage(keys, [1, 3]), b"ZenGo")


def test_remove_sign_rotate_sign():
    """(reference src/test.rs:82-93): removed parties fail their collect
    (simulate_dkr_removal asserts it); the survivors' collect succeeds on
    clones, so the keys still sign."""
    keys = simulate_keygen(1, 4, HOST)
    simulate_signing(simulate_offline_stage(keys, [1, 2]), b"ZenGo")
    simulate_dkr_removal(keys, [1], HOST)
    simulate_signing(simulate_offline_stage(keys, [2, 3]), b"ZenGo")
    simulate_dkr_removal(keys, [1, 2], HOST)
    simulate_signing(simulate_offline_stage(keys, [3, 4]), b"ZenGo")


@pytest.mark.parametrize("config", [HOST, TEST_CONFIG], ids=["host", "cuda-plain"])
def test_add_party_with_permute(config):
    """Remove parties 2 and 5 of a (1, 5) committee, permute survivors, add
    two fresh parties at indices 2 and 5, rotate, then sign with a quorum
    holding both fresh parties (reference src/test.rs:95-224)."""
    t, n = 1, 5
    all_keys = simulate_keygen(t, n, config)
    old_secret = reconstruct_from(all_keys, t, n, t + 1)

    keys = [k for k in all_keys if k.i not in (2, 5)]
    old_to_new_map = {1: 4, 3: 1, 4: 3}

    join_messages, new_pairs = [], []
    for idx in (2, 5):
        jm, pair = JoinMessage.distribute(config)
        jm.set_party_index(idx)
        join_messages.append(jm)
        new_pairs.append(pair)

    refresh_messages, dks = [], []
    for key in keys:
        m, dk = RefreshMessage.replace(join_messages, key, old_to_new_map, n, config)
        refresh_messages.append(m)
        dks.append(dk)

    new_keys = []
    for key, dk in zip(keys, dks):
        RefreshMessage.collect(refresh_messages, key, dk, join_messages, config)
        new_keys.append(key)
    for jm, pair in zip(join_messages, new_pairs):
        new_keys.append(jm.collect(refresh_messages, pair, join_messages, t, n, config))

    keys = sorted(new_keys, key=lambda k: k.i)
    assert [k.i for k in keys] == list(range(1, n + 1))
    assert all(k.n == n and k.pk_vec == keys[0].pk_vec for k in keys)
    assert all(k.pk_vec[k.i - 1] == GENERATOR * k.keys_linear.x_i for k in keys)
    assert reconstruct_from(keys, t, n, t + 1).v == old_secret.v
    params = vss.ShamirSecretSharing(t, n)
    joined = vss.reconstruct(params, [1, 4], [keys[1].keys_linear.x_i,
                                              keys[4].keys_linear.x_i])
    assert joined.v == old_secret.v

    simulate_signing(simulate_offline_stage(keys, [2, 5]), b"ZenGo")


def test_ecdsa_verify_agrees_with_reference():
    """The port's ecdsa_verify and the JAX package's give the same verdict
    on the same signatures: a threshold signature from each package's
    signing harness, and each with s + 1 and with another message."""
    from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
    from fsdkr_tpu.core import secp256k1 as jsecp
    from fsdkr_tpu.protocol import ecdsa_verify as jax_verify
    from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
    from fsdkr_tpu.protocol import simulate_offline_stage as jax_offline
    from fsdkr_tpu.protocol.signing import SignManual as JaxSignManual

    def signature(offline, manual, msg):
        parties = [manual(msg, o) for o in offline]
        return parties[0].complete([p.local_sig for p in parties[1:]])

    port_keys = simulate_keygen(1, 3, HOST)
    msg = message_scalar(b"ZenGo")
    port_sig = signature(simulate_offline_stage(port_keys, [1, 3]), SignManual, msg)
    jax_keys = jax_keygen(1, 3, JAX_CONFIG)
    jmsg = jsecp.Scalar.from_int(msg.v)
    jax_sig = signature(jax_offline(jax_keys, [2, 3]), JaxSignManual, jmsg)

    cases = []
    for (r, s), pk in ((port_sig, port_keys[0].y_sum_s),
                       ((Scalar.from_int(jax_sig[0].v), Scalar.from_int(jax_sig[1].v)),
                        jax_keys[0].y_sum_s)):
        pk = type(port_keys[0].y_sum_s)(pk.x, pk.y)
        other = message_scalar(b"not ZenGo")
        cases += [((r, s), pk, msg), ((r, s + Scalar.from_int(1)), pk, msg),
                  ((r, s), pk, other)]
    got, want = [], []
    for (r, s), pk, m in cases:
        got.append(ecdsa_verify((r, s), pk, m))
        want.append(jax_verify((jsecp.Scalar.from_int(r.v), jsecp.Scalar.from_int(s.v)),
                               jsecp.Point(pk.x, pk.y), jsecp.Scalar.from_int(m.v)))
    assert got == want == [True, False, False] * 2
