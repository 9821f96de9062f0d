"""The port's join path (JoinMessage, RefreshMessage.replace, collect with
joins, generate_dlog_statement_proofs) against the JAX package's, at
TEST_CONFIG-sized parameters (768-bit Paillier, M=32, 3 correct-key
rounds): a t=1, n=3 committee admits one new party at index 4, with the
port on device="cpu" (its kernels' plain versions) and the JAX package on
its host backend.

- A JoinMessage carries across both ways (carry.from_reference,
  carry.to_fields / from_fields).
- Composite-dlog proofs made by either package verify under the other's
  verifier, in both base directions.
- The port's replace leaves the same paillier_key_vec, h1_h2_n_tilde_vec,
  i and n as the JAX replace on a copy of the same key and map.
- On JAX-made messages, an existing party's collect with the join adopts
  the JAX collect's LocalKey field for field, and the joiner's
  JoinMessage.collect derives the JAX one's (its own fresh VSS scheme
  aside, which both draw at random).
- Port-made replace and join messages pass the JAX collect and the JAX
  JoinMessage.collect, with the same keys as the port's.
- A joiner's tampered broadcast (the JAX package's join tamper matrix)
  raises the same error class naming the same party in the port, at the
  default (FSDKRC_RLC on), and the ring-Pedersen case at FSDKRC_RLC=0 too.
"""

import copy
import dataclasses

import pytest
import torch

from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.core import paillier as jpaillier
from fsdkr_tpu.core import secp256k1 as jsecp
from fsdkr_tpu.core import vss as jvss
from fsdkr_tpu.errors import FsDkrError as JaxFsDkrError
from fsdkr_tpu.proofs import alice_range as jalice
from fsdkr_tpu.proofs import composite_dlog as jdlog
from fsdkr_tpu.proofs import correct_key as jck
from fsdkr_tpu.proofs import pdl_slack as jpdl
from fsdkr_tpu.proofs import ring_pedersen as jrp
from fsdkr_tpu.protocol import JoinMessage as JaxJoin
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import local_key as jlk
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.backend import get_backend, rlc
from fsdkr_tpu_torch.carry import from_fields, from_reference, to_fields
from fsdkr_tpu_torch.core import vss
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
from fsdkr_tpu_torch.errors import FsDkrError, NewPartyUnassignedIndexError
from fsdkr_tpu_torch.proofs.composite_dlog import DLogStatement
from fsdkr_tpu_torch.protocol import (
    JoinMessage,
    RefreshMessage,
    generate_dlog_statement_proofs,
)

T, N = 1, 3
JOINER, NEW_N = 4, 4
IDENTITY = {1: 1, 2: 2, 3: 3}
PERMUTED = {1: 2, 2: 3, 3: 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op thread
    pool only spins there, and under pytest-xdist it would take cores
    from the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JAX_CLASSES = {
    cls.__name__: cls
    for cls in (
        jsecp.Point, jsecp.Scalar, jpaillier.EncryptionKey,
        jpaillier.DecryptionKey, jvss.ShamirSecretSharing, jvss.VerifiableSS,
        jdlog.DLogStatement, jdlog.CompositeDLogProof,
        jck.NiCorrectKeyProof, jpdl.PDLwSlackProof, jalice.AliceProof,
        jrp.RingPedersenStatement, jrp.RingPedersenProof, jlk.SharedKeys,
        jlk.PaillierKeyPair, jlk.LocalKey, JaxRefresh, JaxJoin,
    )
}


def to_reference(obj):
    return from_fields(to_fields(obj), JAX_CLASSES)


def key_fields(key, skip=()):
    """A LocalKey of either package as plain fields, in the port's shape
    (the JAX VSS scheme's unset delegate certificate dropped), without
    the fields named in `skip`."""
    if type(key).__module__.startswith("fsdkr_tpu."):
        key = from_reference(key)
    return {k: v for k, v in to_fields(key).items() if k not in skip}


SURGERY = ("paillier_key_vec", "h1_h2_n_tilde_vec", "i", "n")


def _key_surgery(key):
    fields = key_fields(key)
    return {k: fields[k] for k in SURGERY}


@pytest.fixture(scope="module")
def reference_round():
    """The JAX package's round: (the keys before replace, after replace,
    the replace messages, their new dks, the join message at index 4,
    the joiner's Paillier pair). Consumers deep-copy before mutating."""
    keys = jax_keygen(T, N, JAX_CONFIG)
    pre = copy.deepcopy(keys)
    join, pair = JaxJoin.distribute(JAX_CONFIG)
    join.set_party_index(JOINER)
    out = [JaxRefresh.replace([join], k, IDENTITY, NEW_N, JAX_CONFIG) for k in keys]
    return pre, keys, [m for m, _ in out], [dk for _, dk in out], join, pair


@pytest.fixture(scope="module")
def port_round(reference_round):
    """The port's round from the same pre-replace keys, survivors
    permuted (PERMUTED) and a port-made join at index 4: (the port's keys
    after replace, the JAX keys after the JAX replace with the same map
    and join, the port's messages, dks, join message and pair)."""
    pre = reference_round[0]
    join, pair = JoinMessage.distribute(PORT_CONFIG)
    join.set_party_index(JOINER)
    keys = from_reference(pre)
    out = [RefreshMessage.replace([join], k, PERMUTED, NEW_N, PORT_CONFIG) for k in keys]
    jax_keys = copy.deepcopy(pre)
    for k in jax_keys:
        JaxRefresh.replace([to_reference(join)], k, PERMUTED, NEW_N, JAX_CONFIG)
    return keys, jax_keys, [m for m, _ in out], [dk for _, dk in out], join, pair


def test_join_message_carries_both_ways(reference_round):
    join = reference_round[4]
    port = from_reference(join)
    assert type(port) is JoinMessage and port.get_party_index() == JOINER
    back = to_reference(port)
    assert type(back) is JaxJoin
    assert to_fields(back) == to_fields(join)
    unassigned = copy.deepcopy(join)
    unassigned.party_index = None
    port = from_reference(unassigned)
    assert port.party_index is None
    with pytest.raises(NewPartyUnassignedIndexError):
        port.get_party_index()


def test_dlog_statement_proofs_verify_across_packages(reference_round):
    """The port's proofs under the JAX verifier and the JAX join's under
    the port's proof verify and batch verifier (on the plain versions);
    a proof checked against the other base direction fails in both."""
    st, p_h1, p_h2 = generate_dlog_statement_proofs(PORT_CONFIG)
    inv = DLogStatement(N=st.N, g=st.ni, ni=st.g)
    jst, jp_h1, jp_h2, jinv = to_reference([st, p_h1, p_h2, inv])
    alg = JAX_CONFIG.hash_alg
    assert [jp_h1.verify(jst, alg), jp_h2.verify(jinv, alg), jp_h1.verify(jinv, alg)] == [
        True, True, False]

    join = from_reference(reference_round[4])
    jst2 = join.dlog_statement
    items = [
        (join.composite_dlog_proof_base_h1, jst2),
        (join.composite_dlog_proof_base_h2, DLogStatement(N=jst2.N, g=jst2.ni, ni=jst2.g)),
        (p_h1, st), (p_h2, inv), (p_h2, st),
    ]
    want = [True, True, True, True, False]
    assert [p.verify(s, PORT_CONFIG.hash_alg) for p, s in items] == want
    assert get_backend(PORT_CONFIG).verify_composite_dlog(items) == want


def test_replace_surgery_matches_reference(port_round):
    keys, jax_keys, msgs, _dks, join, _pair = port_round
    for key, jax_key in zip(keys, jax_keys):
        assert _key_surgery(key) == _key_surgery(jax_key)
        assert key.paillier_key_vec[JOINER - 1] == join.ek
    assert sorted(k.i for k in keys) == [1, 2, 3]
    assert [m.old_party_index for m in msgs] == [1, 2, 3]
    assert [m.party_index for m in msgs] == [PERMUTED[i] for i in (1, 2, 3)]
    # a slot covered by neither the map nor a join raises in both
    port_key = copy.deepcopy(keys[0])
    with pytest.raises(NewPartyUnassignedIndexError):
        RefreshMessage.replace([join], port_key, {1: 1, 2: 2, 3: 3}, NEW_N + 1, PORT_CONFIG)
    jax_key = to_reference(copy.deepcopy(keys[0]))
    with pytest.raises(JaxFsDkrError) as err:
        JaxRefresh.replace([to_reference(join)], jax_key, {1: 1, 2: 2, 3: 3}, NEW_N + 1,
                           JAX_CONFIG)
    assert type(err.value).__name__ == "NewPartyUnassignedIndexError"


def test_existing_party_collect_matches_reference(reference_round):
    """JAX-made messages and join carried across: the port's collect (RLC
    on, the default) adopts the JAX collect's LocalKey, field for field."""
    _pre, keys, msgs, dks, join, _pair = reference_round
    party = 1
    jax_key = copy.deepcopy(keys[party])
    JaxRefresh.collect(copy.deepcopy(msgs), jax_key, copy.deepcopy(dks[party]),
                       (copy.deepcopy(join),), JAX_CONFIG)
    port_key = from_reference(keys[party])
    rlc.stats_reset()
    RefreshMessage.collect(from_reference(msgs), port_key, from_reference(dks[party]),
                           [from_reference(join)], config=PORT_CONFIG)
    assert key_fields(port_key) == key_fields(jax_key)
    assert port_key.paillier_key_vec[JOINER - 1] == from_reference(join.ek)
    assert len(port_key.pk_vec) == NEW_N
    # the default collect took the RLC arms: PDL (2 groups a receiver),
    # ring-Pedersen and correct-key over the 3 senders and the joiner
    assert rlc.stats()["rlc_groups"] == 2 * NEW_N + NEW_N + NEW_N


def _check_joiner_key(port_new, jax_new, pair_ek):
    assert key_fields(port_new, skip=("vss_scheme",)) == key_fields(
        jax_new, skip=("vss_scheme",))
    assert port_new.i == JOINER and port_new.n == NEW_N
    assert port_new.paillier_key_vec[JOINER - 1] == pair_ek
    assert GENERATOR * port_new.keys_linear.x_i == port_new.pk_vec[JOINER - 1]
    assert port_new.vss_scheme.commitments[0] == port_new.keys_linear.y


def test_joiner_collect_matches_reference(reference_round):
    _pre, _keys, msgs, _dks, join, pair = reference_round
    jax_join = copy.deepcopy(join)
    jax_new = jax_join.collect(copy.deepcopy(msgs), copy.deepcopy(pair), (jax_join,), T,
                               NEW_N, JAX_CONFIG)
    port_join = from_reference(join)
    port_new = port_join.collect(from_reference(msgs), from_reference(pair), [port_join], T,
                                 NEW_N, PORT_CONFIG)
    _check_joiner_key(port_new, jax_new, port_join.ek)


def test_port_made_round_passes_reference_collect(reference_round, port_round):
    """Port-made replace and join messages, rebuilt as JAX objects: every
    existing party's JAX collect and the joiner's JAX JoinMessage.collect
    accept them; the committee keeps its secret; one party's port
    collect and the port's JoinMessage.collect adopt the JAX keys."""
    keys, _jax_keys, msgs, dks, join, pair = port_round
    old_secret = jvss.reconstruct(
        jvss.ShamirSecretSharing(T, N), [0, 1],
        [k.keys_linear.x_i for k in reference_round[0][:2]])
    jax_msgs, jax_join = to_reference(msgs), to_reference(join)
    jax_new = []
    for key, dk in zip(keys, dks):
        jax_key = to_reference(key)
        JaxRefresh.collect(copy.deepcopy(jax_msgs), jax_key, to_reference(dk),
                           (copy.deepcopy(jax_join),), JAX_CONFIG)
        jax_new.append(jax_key)
    jax_new.append(copy.deepcopy(jax_join).collect(
        copy.deepcopy(jax_msgs), to_reference(pair), (jax_join,), T, NEW_N, JAX_CONFIG))
    jax_new.sort(key=lambda k: k.i)
    assert [k.i for k in jax_new] == [1, 2, 3, 4]
    assert all(k.pk_vec == jax_new[0].pk_vec for k in jax_new)
    for idx in ([0, 1], [1, 3], [2, 3]):
        secret = jvss.reconstruct(jvss.ShamirSecretSharing(T, NEW_N), idx,
                                  [jax_new[i].keys_linear.x_i for i in idx])
        assert secret.v == old_secret.v

    port_key = copy.deepcopy(keys[0])
    RefreshMessage.collect(msgs, port_key, copy.deepcopy(dks[0]), [join],
                           config=PORT_CONFIG)
    assert key_fields(port_key) == key_fields(jax_new[port_key.i - 1])
    port_new = copy.deepcopy(join).collect(msgs, copy.deepcopy(pair), [join], T, NEW_N,
                                           PORT_CONFIG)
    _check_joiner_key(port_new, jax_new[JOINER - 1], join.ek)
    secret = vss.reconstruct(vss.ShamirSecretSharing(T, NEW_N), [port_key.i - 1, JOINER - 1],
                             [port_key.keys_linear.x_i, port_new.keys_linear.x_i])
    assert secret.v == old_secret.v


def _bump_sigma(j):
    p = j.dk_correctness_proof
    j.dk_correctness_proof = dataclasses.replace(
        p, sigma_vec=[p.sigma_vec[0] + 1] + list(p.sigma_vec[1:]))


def _bump_dlog_y(j):
    p = j.composite_dlog_proof_base_h1
    j.composite_dlog_proof_base_h1 = dataclasses.replace(p, y=p.y + 1)


def _swap_dlog(j):
    j.composite_dlog_proof_base_h1, j.composite_dlog_proof_base_h2 = (
        j.composite_dlog_proof_base_h2, j.composite_dlog_proof_base_h1)


def _small_ek(j):
    j.ek = type(j.ek).from_n((1 << 520) + 21)


def _bump_rp_z(j):
    p = j.ring_pedersen_proof
    j.ring_pedersen_proof = dataclasses.replace(p, Z=[p.Z[0] + 1] + list(p.Z[1:]))


# tests/test_join_tamper.py's matrix: (case, mutation of the JAX join
# message, the error classes the JAX collect may raise)
TAMPERS = {
    "correct_key_sigma": (_bump_sigma, ("PaillierVerificationError",)),
    "composite_dlog_y": (_bump_dlog_y, ("DLogProofValidation",)),
    "composite_dlog_swapped": (_swap_dlog, ("DLogProofValidation",)),
    "ek_too_small": (_small_ek, ("PaillierVerificationError", "ModuliTooSmall")),
    "ring_pedersen_Z": (_bump_rp_z, ("RingPedersenProofError",)),
}
CASES = [(name, "1") for name in TAMPERS] + [("ring_pedersen_Z", "0")]


@pytest.mark.parametrize("name,rlc_on", CASES, ids=[f"{n}-rlc{r}" for n, r in CASES])
def test_tampered_join_raises_like_reference(reference_round, name, rlc_on, monkeypatch):
    """An existing party's collect with a tampered join: the port raises
    the JAX collect's error class, naming the same party (the joiner,
    where the class names one)."""
    monkeypatch.setenv("FSDKRC_RLC", rlc_on)
    _pre, keys, msgs, dks, join, _pair = reference_round
    mutate, classes = TAMPERS[name]
    evil = copy.deepcopy(join)
    mutate(evil)
    with pytest.raises(JaxFsDkrError) as jax_err:
        JaxRefresh.collect(copy.deepcopy(msgs), copy.deepcopy(keys[0]),
                           copy.deepcopy(dks[0]), (evil,), JAX_CONFIG)
    rlc.stats_reset()
    with pytest.raises(FsDkrError) as port_err:
        RefreshMessage.collect(from_reference(msgs), from_reference(keys[0]),
                               from_reference(dks[0]), [from_reference(evil)],
                               config=PORT_CONFIG)
    e, j = port_err.value, jax_err.value
    assert type(j).__name__ in classes
    assert (type(e).__name__, getattr(e, "party_index", None)) == (
        type(j).__name__, getattr(j, "party_index", None))
    if hasattr(e, "party_index"):
        assert e.party_index == JOINER
    assert (rlc.stats()["rlc_groups"] > 0) == (rlc_on == "1")
