"""The port's streaming collect (`RefreshMessage.collect_stream`,
`StreamingCollect`, `finalize_streams`, `stream_rows`) against the JAX
package's on the same carried messages, and against the port's own
barrier `collect`, at TEST_CONFIG sizes (768-bit Paillier, M=32, 3
correct-key rounds), t=1, n=3.

Each case compares the offer statuses, the verdict (exception class and
fields, or None), the adopted LocalKey (`carry.to_fields`) and the
`backend.rlc.stats()` counters of the whole stream (offers and
finalize) with the JAX package's. The port's cuda backend runs its
kernels' plain versions on device="cpu", against the JAX package's
TpuBatchVerifier on host engines (both fold with RLC); the cheap cases
run both packages' host backends, whose folds count nothing.

- Honest shuffled arrival with a duplicate, an unexpected sender and late
  offers; an idempotent second finalize.
- finalize short of quorum (the session stays open), and `close`.
- The JAX package's tamper matrix (tests/test_streaming.py TAMPERS), one
  parametrised test; ring-Pedersen also on the cuda backend, where the
  eager one-proof RLC group bisects.
- A fused `finalize_streams` of two sessions, one tampered, on the cuda
  backend: the pair rows dedup across them, the failing group bisects and
  only the tampered session is blamed.
- A stream with a join message, one whose expected senders leave out a
  removed party, and an eager backend exception replayed in barrier
  order.
- `stream_rows()` over open, closed and finalized sessions.
"""

import copy
import dataclasses
import random

import pytest
import torch

from fsdkr_tpu.backend import rlc as jrlc
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import JoinMessage as JaxJoin
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import finalize_streams as jax_finalize_streams
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.backend import rlc
from fsdkr_tpu_torch.backend.batch_verifier import HostBatchVerifier
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.protocol import RefreshMessage, finalize_streams, stream_rows

N, T = 3, 1
COUNTERS = ("rlc_groups", "rows_folded", "fullwidth_ladders", "bisect_fallbacks",
            "session_bisects", "xsession_rows_deduped", "stream_tiles")
PORT_HOST = dataclasses.replace(PORT_CONFIG, backend="host")
JAX_KNOBS = (("FSDKR_DEVICE_POWM", "0"), ("FSDKR_DEVICE_EC", "0"), ("FSDKR_RLC", "1"),
             ("FSDKR_XSESSION_DEDUP", "1"), ("FSDKR_MEM_PLAN", "1"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    for knob in ("FSDKRC_RLC", "FSDKRC_MULTIEXP", "FSDKRC_RANGEOPT", "FSDKRC_MEM_BUDGET_MB",
                 "FSDKRC_DELEGATE"):
        monkeypatch.delenv(knob, raising=False)


def _jax_env():
    mp = pytest.MonkeyPatch()
    for knob, value in JAX_KNOBS:
        mp.setenv(knob, value)
    mp.delenv("FSDKR_MEM_BUDGET_MB", raising=False)
    mp.delenv("FSDKR_DELEGATE", raising=False)
    return mp


@pytest.fixture(scope="module")
def reference_round():
    """One honest JAX-package round: (keys after distribute, messages, new
    dks)."""
    mp = _jax_env()
    try:
        keys = jax_keygen(T, N, JAX_CONFIG)
        out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], N, JAX_CONFIG)
    finally:
        mp.undo()
    return keys, [m for m, _ in out], [dk for _, dk in out]


@pytest.fixture(scope="module")
def join_round():
    """A JAX-package join round: a joiner at index N + 1, every party's
    replace with its own index: (keys after replace, messages, new dks,
    the join message)."""
    mp = _jax_env()
    try:
        keys = jax_keygen(T, N, JAX_CONFIG)
        join, _pair = JaxJoin.distribute(JAX_CONFIG)
        join.set_party_index(N + 1)
        ident = {k.i: k.i for k in keys}
        out = [JaxRefresh.replace([join], k, ident, N + 1, JAX_CONFIG) for k in keys]
    finally:
        mp.undo()
    return keys, [m for m, _ in out], [dk for _, dk in out], join


@pytest.fixture(scope="module")
def removal_round():
    """Party N leaves: the other parties replace with their own indices
    onto N - 1 seats and broadcast; party N broadcasts a stale message of
    the old layout. (survivors' keys after replace, their messages, new
    dks, the removed party's message)."""
    mp = _jax_env()
    try:
        keys = jax_keygen(T, N, JAX_CONFIG)
        removed = keys[-1]
        stale, _ = JaxRefresh.distribute_batch([(removed.i, copy.deepcopy(removed))], N,
                                               JAX_CONFIG)[0]
        survivors = keys[:-1]
        ident = {k.i: k.i for k in survivors}
        out = [JaxRefresh.replace([], k, ident, N - 1, JAX_CONFIG) for k in survivors]
    finally:
        mp.undo()
    return survivors, [m for m, _ in out], [dk for _, dk in out], stale


def _err(e):
    """An exception as its class name and fields (the blamed party, the
    PDL equation bits), or its text where it has no fields."""
    if e is None:
        return None
    return type(e).__name__, sorted(vars(e).items()) or str(e)


def _jax_view(result):
    """A port stream's result as the JAX package reports it: the port's
    PDL error also names the sender (`party_index`), which the JAX
    package's leaves out; the port's barrier comparisons keep it."""
    statuses, err, key, counters = result
    if err is not None and err[0] == "PDLwSlackProofError":
        err = (err[0], [(k, v) for k, v in err[1] if k != "party_index"])
    return statuses, err, key, counters


def _key_fields(key):
    if type(key).__module__.startswith("fsdkr_tpu."):
        key = from_reference(key)
    return to_fields(key)


def _stream(pkg, arrivals, key, dk, expected=None, joins=(), backend="cuda", late=()):
    """One streaming session of package `pkg` ("port" or "jax") on deep
    copies of the JAX-package objects given (the port's carried): every
    message of `arrivals` offered in order, then finalize, then `late`
    offered. Returns (statuses, verdict, adopted key's fields, counters)."""
    shared = {}
    arrivals, late = copy.deepcopy(arrivals, shared), copy.deepcopy(late, shared)
    key, dk, joins = copy.deepcopy(key), copy.deepcopy(dk), copy.deepcopy(joins, shared)
    if pkg == "port":
        arrivals, late, key, dk, joins = (from_reference(x) for x in (arrivals, late, key, dk,
                                                                       joins))
        config = PORT_CONFIG if backend == "cuda" else PORT_HOST
        stats, reset, collect_stream = rlc.stats, rlc.stats_reset, RefreshMessage.collect_stream
        mp = None
    else:
        config = JAX_CONFIG.with_backend("tpu") if backend == "cuda" else JAX_CONFIG
        stats, reset = jrlc.stats, jrlc.stats_reset
        collect_stream = JaxRefresh.collect_stream
        mp = _jax_env()
    try:
        reset()
        st = collect_stream(key, dk, expected, joins, config)
        statuses = [st.offer(m) for m in arrivals]
        try:
            st.finalize()
            err = None
        except Exception as e:  # noqa: BLE001 - the verdict under test
            err = e
        statuses += [st.offer(m) for m in late]
        counters = {k: stats()[k] for k in COUNTERS}
    finally:
        if mp is not None:
            mp.undo()
    return statuses, _err(err), _key_fields(key), counters


def _barrier(msgs, key, dk, joins=()):
    """The port's barrier collect (host backend) on carried copies:
    (verdict, adopted key's fields)."""
    key = from_reference(key)
    try:
        RefreshMessage.collect(from_reference(msgs), key, from_reference(dk),
                               from_reference(list(joins)), PORT_HOST)
        err = None
    except Exception as e:  # noqa: BLE001
        err = e
    return _err(err), _key_fields(key)


def _shuffled(msgs, seed):
    order = list(msgs)
    random.Random(seed).shuffle(order)
    return order


def test_honest_shuffled_stream_matches_reference_and_barrier(reference_round):
    """Shuffled arrival with a duplicate and an unexpected sender, late
    offers after finalize: the JAX package's statuses, key and counters,
    and the port's barrier collect's key."""
    keys, msgs, dks = reference_round
    order = _shuffled(msgs, 11)
    bogus = copy.deepcopy(msgs[0])
    bogus.party_index = 99
    arrivals = order[:1] + order[:1] + [bogus] + order[1:]
    late = [msgs[0], bogus]
    got = _stream("port", arrivals, keys[0], dks[0], late=late)
    want = _stream("jax", arrivals, keys[0], dks[0], late=late)
    assert got == want
    statuses, err, key, counters = got
    assert statuses == ["accepted", "duplicate", "unexpected", "accepted", "accepted",
                        "late", "late"]
    assert err is None
    # a group a proof for ring-Pedersen and correct-key (one a message,
    # folded at its offer), then the receivers' 2N pair groups at quorum
    assert counters["rlc_groups"] == 2 * N + 2 * N
    assert counters["bisect_fallbacks"] == 0
    assert (None, key) == _barrier(msgs, keys[0], dks[0])


def test_finalize_is_idempotent_and_short_of_quorum_stays_open(reference_round):
    keys, msgs, dks = reference_round
    key, dk = from_reference(keys[1]), from_reference(dks[1])
    pmsgs = from_reference(msgs)
    st = RefreshMessage.collect_stream(key, dk, None, (), PORT_HOST)
    assert st.offer(pmsgs[2]) == "accepted"
    assert not st.ready and st.missing() == [1, 2] and st.arrived == 1
    with pytest.raises(ValueError, match="quorum"):
        st.finalize()
    assert not st.done and st.error is None
    for m in pmsgs[:2]:
        assert st.offer(m) == "accepted"
    assert st.ready and st.canonical_msgs() == pmsgs
    st.finalize()
    assert st.done and st.error is None and not st.ready
    adopted = _key_fields(key)
    st.finalize()  # replays the stored verdict: no second adoption
    assert _key_fields(key) == adopted == _barrier(msgs, keys[1], dks[1])[1]
    # the JAX package's session walks the same way
    want = _stream("jax", msgs[2:] + msgs[:2], keys[1], dks[1], backend="host")
    assert want[1] is None and want[2] == adopted


@pytest.mark.parametrize("error", [None, "reaped"])
def test_close_ends_without_adoption(reference_round, error):
    """`close` before quorum: later offers are late, finalize and a fused
    finalize_streams replay the stored verdict, the key stays as it was;
    a second close is refused. As the JAX package's session does."""
    keys, msgs, dks = reference_round
    results = []
    for pkg, collect_stream, fin, cfg in (
            ("port", RefreshMessage.collect_stream, finalize_streams, PORT_HOST),
            ("jax", JaxRefresh.collect_stream, jax_finalize_streams, JAX_CONFIG)):
        key, dk, ms = copy.deepcopy(keys[0]), copy.deepcopy(dks[0]), copy.deepcopy(msgs)
        if pkg == "port":
            key, dk, ms = from_reference(key), from_reference(dk), from_reference(ms)
        before = _key_fields(key)
        st = collect_stream(key, dk, None, (), cfg)
        statuses = [st.offer(ms[0])]
        exc = None if error is None else RuntimeError(error)
        closed = (st.close(exc), st.close(RuntimeError("again")))
        statuses += [st.offer(m) for m in ms[1:]]
        replay = fin([st], cfg)
        assert replay[0] is exc and st.error is exc and st.done
        assert _key_fields(key) == before
        results.append((statuses, closed, _err(replay[0])))
    assert results[0] == results[1]
    assert results[0][:2] == (["accepted", "late", "late"], (True, False))


# the JAX package's tamper matrix (tests/test_streaming.py TAMPERS): each
# lands on another family or phase, so the replayed barrier order is
# exercised end to end
TAMPERS = {
    "pdl_s1": lambda msgs: msgs[1].pdl_proof_vec.__setitem__(
        0, dataclasses.replace(msgs[1].pdl_proof_vec[0], s1=msgs[1].pdl_proof_vec[0].s1 + 1)),
    "range_s": lambda msgs: msgs[1].range_proofs.__setitem__(
        0, dataclasses.replace(msgs[1].range_proofs[0], s=msgs[1].range_proofs[0].s + 1)),
    "ring_pedersen_Z": lambda msgs: msgs[2].ring_pedersen_proof.Z.__setitem__(
        0, msgs[2].ring_pedersen_proof.Z[0] + 1),
    "short_vector": lambda msgs: msgs[2].points_encrypted_vec.pop(),
}
EXPECTED = {"pdl_s1": "PDLwSlackProofError", "range_s": "RangeProofError",
            "ring_pedersen_Z": "RingPedersenProofError", "short_vector": "SizeMismatchError"}


@pytest.mark.parametrize("name,backend", [(name, "host") for name in TAMPERS]
                         + [("ring_pedersen_Z", "cuda")],
                         ids=[f"{name}-host" for name in TAMPERS] + ["ring_pedersen_Z-cuda"])
def test_tamper_matrix_blames_as_reference_and_barrier(reference_round, name, backend):
    keys, msgs, dks = reference_round
    bad = copy.deepcopy(msgs)
    TAMPERS[name](bad)
    arrivals = _shuffled(bad, 5)
    got = _stream("port", arrivals, keys[0], dks[0], backend=backend)
    want = _stream("jax", arrivals, keys[0], dks[0], backend=backend)
    assert _jax_view(got) == want
    assert got[1][0] == EXPECTED[name]
    barrier_err, barrier_key = _barrier(bad, keys[0], dks[0])
    assert got[1] == barrier_err
    assert got[2] == barrier_key == _key_fields(keys[0])  # nothing adopted
    if backend == "cuda":
        # the tampered proof's one-proof group bisected at its offer
        assert got[3]["bisect_fallbacks"] == 1


def test_fused_finalize_streams_isolates_a_tampered_session(reference_round):
    """Two sessions in one finalize_streams call on the cuda backend, the
    second over a broadcast with one bad PDL row: its rows dedup against
    the first's but the tampered one, whose RLC group fails and bisects;
    the tampered session alone is blamed, the other adopts. The JAX package's finalize_streams
    gives the same verdicts, keys and counters."""
    keys, msgs, dks = reference_round
    bad = copy.deepcopy(msgs)
    TAMPERS["pdl_s1"](bad)
    outs = []
    for pkg in ("port", "jax"):
        shared = {}
        plan = [(copy.deepcopy(msgs, shared), copy.deepcopy(keys[0]), copy.deepcopy(dks[0]), 3),
                (copy.deepcopy(bad, shared), copy.deepcopy(keys[1]), copy.deepcopy(dks[1]), 4)]
        if pkg == "port":
            plan = [tuple(from_reference(x) for x in p[:3]) + p[3:] for p in plan]
            collect_stream, fin, cfg = RefreshMessage.collect_stream, finalize_streams, PORT_CONFIG
            stats, reset, mp = rlc.stats, rlc.stats_reset, None
        else:
            collect_stream, fin = JaxRefresh.collect_stream, jax_finalize_streams
            cfg, stats, reset, mp = JAX_CONFIG.with_backend("tpu"), jrlc.stats, jrlc.stats_reset, \
                _jax_env()
        try:
            reset()
            streams, statuses = [], []
            for ms, key, dk, seed in plan:
                st = collect_stream(key, dk, None, (), cfg)
                statuses += [st.offer(m) for m in _shuffled(ms, seed)]
                streams.append(st)
            errs = fin(streams, cfg)
            counters = {k: stats()[k] for k in COUNTERS}
        finally:
            if mp is not None:
                mp.undo()
        assert [st.error for st in streams] == errs
        outs.append((statuses, [_err(e) for e in errs], [_key_fields(p[1]) for p in plan],
                     counters))
    statuses, errs, adopted, counters = outs[0]
    assert (statuses, [_jax_view((0, e, 0, 0))[1] for e in errs], adopted, counters) == outs[1]
    assert errs[0] is None and errs[1][0] == "PDLwSlackProofError"
    assert errs[1] == _barrier(bad, keys[1], dks[1])[0]
    assert adopted[0] == _barrier(msgs, keys[0], dks[0])[1]
    assert adopted[1] == _key_fields(keys[1])
    # 18 pair rows, 10 distinct: the 9 honest ones and the tampered one
    assert counters["xsession_rows_deduped"] == 2 * N * N - (N * N + 1)
    assert counters["bisect_fallbacks"] >= 1, counters


def test_stream_with_a_join(join_round):
    """A survivor's stream of the replace messages with the joiner's
    JoinMessage: the expected senders are the survivors (the joiner sends
    no RefreshMessage), and the joiner's proofs fold at finalize."""
    keys, msgs, dks, join = join_round
    expected = [m.party_index for m in msgs]
    arrivals = _shuffled(msgs, 7)
    got = _stream("port", arrivals, keys[0], dks[0], expected, [join], backend="host")
    want = _stream("jax", arrivals, keys[0], dks[0], expected, [join], backend="host")
    assert got == want and got[1] is None
    assert got[2] == _barrier(msgs, keys[0], dks[0], [join])[1]
    # a tampered joiner raises what the barrier raises
    bad = copy.deepcopy(join)
    bad.dk_correctness_proof.sigma_vec[0] += 1
    got = _stream("port", arrivals, keys[0], dks[0], expected, [bad], backend="host")
    want = _stream("jax", arrivals, keys[0], dks[0], expected, [bad], backend="host")
    assert got == want and got[1][0] == "PaillierVerificationError"
    assert got[1] == _barrier(msgs, keys[0], dks[0], [bad])[0]


def test_stream_without_a_removed_sender(removal_round):
    """The survivors' stream names them as its expected senders: the
    removed party's stale broadcast is "unexpected" and changes nothing."""
    keys, msgs, dks, stale = removal_round
    expected = [m.party_index for m in msgs]
    arrivals = [msgs[1], stale, msgs[0]]
    got = _stream("port", arrivals, keys[1], dks[1], expected, backend="host")
    want = _stream("jax", arrivals, keys[1], dks[1], expected, backend="host")
    assert got == want
    assert got[0] == ["accepted", "unexpected", "accepted"] and got[1] is None
    assert got[2] == _barrier(msgs, keys[1], dks[1])[1]


def test_eager_backend_exception_is_replayed_in_barrier_order(reference_round, monkeypatch):
    """A correct-key call that raises at an offer is recorded, not raised;
    finalize raises it after the earlier phases pass, and nothing is
    adopted. A failing Feldman row of the same stream comes first in the
    barrier's order and wins."""
    keys, msgs, dks = reference_round
    boom = RuntimeError("launch failed")
    raw = HostBatchVerifier.verify_correct_key

    def flaky(self, items, rounds):
        if items[0][1].n == from_reference(msgs[1].ek).n:
            raise boom
        return raw(self, items, rounds)

    monkeypatch.setattr(HostBatchVerifier, "verify_correct_key", flaky)
    key = from_reference(keys[2])
    before = _key_fields(key)
    st = RefreshMessage.collect_stream(key, from_reference(dks[2]), None, (), PORT_HOST)
    assert [st.offer(m) for m in from_reference(msgs)] == ["accepted"] * N
    with pytest.raises(RuntimeError) as raised:
        st.finalize()
    assert raised.value is boom and st.error is boom
    assert _key_fields(key) == before

    bad = from_reference(msgs)
    bad[0].points_committed_vec[1] = bad[0].points_committed_vec[2]
    st = RefreshMessage.collect_stream(from_reference(keys[2]), from_reference(dks[2]), None,
                                       (), PORT_HOST)
    for m in bad:
        st.offer(m)
    errs = finalize_streams([st], PORT_HOST)
    assert _err(errs[0]) == _barrier(bad, keys[2], dks[2])[0]
    assert errs[0] is not boom and _err(errs[0])[0] == "PublicShareValidationError"


def test_stream_rows_counts_open_sessions(reference_round):
    """Pair rows staged over open sessions: n a message that arrived,
    released by close and by finalize."""
    keys, msgs, dks = reference_round
    pmsgs = from_reference(msgs)
    base = stream_rows()
    a = RefreshMessage.collect_stream(from_reference(keys[0]), from_reference(dks[0]), None, (),
                                      PORT_HOST)
    b = RefreshMessage.collect_stream(from_reference(keys[1]), from_reference(dks[1]), None, (),
                                      PORT_HOST)
    a.offer(pmsgs[0])
    a.offer(pmsgs[1])
    b.offer(pmsgs[2])
    assert stream_rows() - base == 3 * N
    assert a.close() and stream_rows() - base == N
    b.offer(pmsgs[0])
    b.offer(pmsgs[1])
    assert stream_rows() - base == 3 * N
    b.finalize()
    assert stream_rows() == base
