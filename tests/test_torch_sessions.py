"""The port's fused multi-session collect (`RefreshMessage.collect_sessions`,
`fused_isolated`, cross-session dedup, always on in a fused call, and
session-first blame through `rlc.bisect_sessions`) on device="cpu",
against the JAX package's `collect_sessions` (its TpuBatchVerifier on host
engines, FSDKR_XSESSION_DEDUP on and off) on the same carried messages,
n=3, t=1, TEST_CONFIG sizes.

- Four same-committee sessions, fused: the JAX package's errors, adopted
  LocalKeys and fold counters, and the key the port's own `collect` of
  the session adopts.
- One tampered PDL row in one session of four: the guilty session gets
  the exception type and per-equation bits of the JAX package's call with
  dedup on and with dedup off, naming the sender; the other three adopt
  the JAX package's keys.
- Two sessions of one receiver over two distributes of its committee
  (no row equal, every RLC group merged across them), one tampered: the
  merged groups bisect session-first, as the JAX package's do.
- Two distinct committees fused: each session adopts what its own JAX
  collect adopts.
- A malformed session that makes the fused batch raise gets the JAX
  package's error; the other session adopts.
- `fused_isolated` and `bisect_sessions` on synthetic calls walk as the
  JAX package's do.
- The pair-row types are frozen and hashed by value, which dedup relies on.

Every comparison is exact.
"""

import copy
import dataclasses

import pytest
import torch

from fsdkr_tpu.backend import rlc as jrlc
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import refresh as jrefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.backend import rlc
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.core.paillier import EncryptionKey
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, Point
from fsdkr_tpu_torch.errors import PDLwSlackProofError
from fsdkr_tpu_torch.proofs.alice_range import AliceProof
from fsdkr_tpu_torch.proofs.composite_dlog import DLogStatement
from fsdkr_tpu_torch.proofs.pdl_slack import PDLwSlackProof, PDLwSlackStatement
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.protocol import refresh

N, T = 3, 1
COUNTERS = ("rlc_groups", "rows_folded", "fullwidth_ladders", "bisect_fallbacks",
            "session_bisects", "xsession_rows_deduped", "stream_tiles")
BAD_SENDER = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    _defaults(monkeypatch)


def _defaults(mp):
    for knob in ("FSDKRC_RLC", "FSDKRC_MULTIEXP", "FSDKRC_RANGEOPT", "FSDKRC_MEM_BUDGET_MB"):
        mp.delenv(knob, raising=False)


def _jax_round(keygen):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        keys = keygen(T, N, JAX_CONFIG)
        out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], N, JAX_CONFIG)
    return keys, [m for m, _ in out], [dk for _, dk in out]


@pytest.fixture(scope="module")
def reference_round():
    """One honest JAX-package round: (keys after distribute, messages, new
    dks)."""
    return _jax_round(jax_keygen)


@pytest.fixture(scope="module")
def second_distribute(reference_round):
    """A second distribute of the reference committee, from copies of its
    keys: (messages, new dks). Its pair rows differ from the round's, but a
    receiver's rows of both fold into that receiver's RLC groups."""
    keys, _, _ = reference_round
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        out = JaxRefresh.distribute_batch([(k.i, copy.deepcopy(k)) for k in keys], N,
                                          JAX_CONFIG)
    return [m for m, _ in out], [dk for _, dk in out]


@pytest.fixture(scope="module")
def second_round():
    """A round of another committee (fresh moduli)."""
    return _jax_round(getattr(jax_keygen, "uncached", jax_keygen))


def key_fields(key):
    if type(key).__module__.startswith("fsdkr_tpu."):
        key = from_reference(key)
    return to_fields(key)


def _jax_sessions(sessions, dedup="1"):
    """The JAX package's collect_sessions on deep copies of `sessions`
    (messages, key, dk, joins), a key and a dk of their own for every
    session: (errors, adopted keys, fold counters)."""
    shared = {}
    sessions = [(copy.deepcopy(m, shared), copy.deepcopy(k), copy.deepcopy(d),
                 copy.deepcopy(j, shared)) for m, k, d, j in sessions]
    with pytest.MonkeyPatch.context() as mp:
        for knob, value in (("FSDKR_DEVICE_POWM", "0"), ("FSDKR_DEVICE_EC", "0"),
                            ("FSDKR_RLC", "1"), ("FSDKR_XSESSION_DEDUP", dedup),
                            ("FSDKR_MEM_PLAN", "1")):
            mp.setenv(knob, value)
        mp.delenv("FSDKR_MEM_BUDGET_MB", raising=False)
        jrlc.stats_reset()
        errs = JaxRefresh.collect_sessions(sessions, JAX_CONFIG.with_backend("tpu"))
        stats = {k: jrlc.stats()[k] for k in COUNTERS}
    return errs, [key for _, key, _, _ in sessions], stats


def _port_sessions(sessions):
    """The port's collect_sessions on carried copies: (errors, adopted
    keys, fold counters)."""
    sessions = [(from_reference(m), from_reference(k), from_reference(d), from_reference(j))
                for m, k, d, j in sessions]
    rlc.stats_reset()
    errs = RefreshMessage.collect_sessions(sessions, PORT_CONFIG)
    return errs, [key for _, key, _, _ in sessions], {k: rlc.stats()[k] for k in COUNTERS}


def _verdict(err):
    if err is None:
        return None
    return (type(err).__name__,
            tuple(getattr(err, f, None) for f in ("is_u1_eq", "is_u2_eq", "is_u3_eq")))


def _tampered(msgs):
    """A copy of the broadcast whose sender BAD_SENDER's PDL proof to
    receiver 1 has u2 + 1: it fails in the pair family's RLC groups, the
    groups that merge across sessions."""
    bad = copy.deepcopy(msgs)
    p = bad[BAD_SENDER].pdl_proof_vec[0]
    bad[BAD_SENDER].pdl_proof_vec[0] = dataclasses.replace(p, u2=p.u2 + 1)
    return bad


def test_fused_same_committee_matches_reference_and_own_collect(reference_round):
    keys, msgs, dks = reference_round
    receivers = [0, 1, 2, 0]
    sessions = [(msgs, keys[r], dks[r], ()) for r in receivers]
    want_errs, want_keys, want_stats = _jax_sessions(sessions)
    errs, got_keys, stats = _port_sessions(sessions)
    assert errs == want_errs == [None] * 4
    assert [key_fields(k) for k in got_keys] == [key_fields(k) for k in want_keys]
    assert stats == want_stats
    # every session's 9 pair rows are value-identical: one session's kept
    assert stats["xsession_rows_deduped"] == 3 * N * N
    assert stats["fullwidth_ladders"] == stats["rlc_groups"]
    assert stats["session_bisects"] == stats["stream_tiles"] == 0

    own = from_reference(keys[0])
    RefreshMessage.collect(from_reference(msgs), own, from_reference(dks[0]), config=PORT_CONFIG)
    assert key_fields(own) == key_fields(got_keys[0]) == key_fields(got_keys[3])


@pytest.fixture(scope="module")
def tampered_of_four(reference_round):
    """Four sessions of receiver 1, the third over a tampered broadcast,
    and the port's fused call of them (once a module: the port's fused
    call always dedups)."""
    keys, msgs, dks = reference_round
    bad = _tampered(msgs)
    sessions = [(bad if s == 2 else msgs, keys[0], dks[0], ()) for s in range(4)]
    with pytest.MonkeyPatch.context() as mp:
        _defaults(mp)
        return sessions, _port_sessions(sessions)


@pytest.mark.parametrize("dedup", ["1", "0"])
def test_one_tampered_session_of_four_is_blamed_alone(reference_round, tampered_of_four, dedup):
    """The port's fused call against the JAX package's with
    FSDKR_XSESSION_DEDUP `dedup`: the same verdicts and keys either way,
    and the fold counters of the JAX package's call with dedup on."""
    _, msgs, _ = reference_round
    sessions, (errs, got_keys, stats) = tampered_of_four
    want_errs, want_keys, want_stats = _jax_sessions(sessions, dedup)
    # the guilty session's own collect raises what the fused call returns
    (own_err,), _, _ = _jax_sessions(sessions[2:3], dedup)
    assert _verdict(want_errs[2]) == _verdict(own_err)

    assert [e is None for e in errs] == [True, True, False, True]
    assert isinstance(errs[2], PDLwSlackProofError)
    assert _verdict(errs[2]) == _verdict(want_errs[2])
    assert errs[2].party_index == msgs[BAD_SENDER].party_index
    for s in (0, 1, 3):
        assert key_fields(got_keys[s]) == key_fields(want_keys[s])
    # 36 rows, 10 distinct: the 9 honest ones and the tampered one
    assert stats["xsession_rows_deduped"] == 4 * N * N - (N * N + 1)
    if dedup == "1":
        assert stats == want_stats
    else:
        # the JAX package verifies every row; its failing groups merge the
        # four sessions' rows and bisect session-first
        assert want_stats["xsession_rows_deduped"] == 0
        assert want_stats["session_bisects"] > 0


def test_merged_groups_bisect_session_first(reference_round, second_distribute):
    """Receiver 1's sessions over the round and over a second distribute
    of its committee, the second tampered: no row dedups, the failing
    groups hold both sessions' rows and bisect session-first; the honest
    session adopts and the tampered one gets the JAX package's error."""
    keys, msgs, dks = reference_round
    msgs2, dks2 = second_distribute
    sessions = [(msgs, keys[0], dks[0], ()), (_tampered(msgs2), keys[0], dks2[0], ())]
    want_errs, want_keys, want_stats = _jax_sessions(sessions)
    errs, got_keys, stats = _port_sessions(sessions)
    assert want_errs[0] is None and errs[0] is None
    assert isinstance(errs[1], PDLwSlackProofError)
    assert _verdict(errs[1]) == _verdict(want_errs[1])
    assert errs[1].party_index == msgs2[BAD_SENDER].party_index
    assert key_fields(got_keys[0]) == key_fields(want_keys[0])
    assert stats == want_stats
    assert stats["xsession_rows_deduped"] == 0 and stats["session_bisects"] > 0


def test_two_committees_fused_equal_their_own_collects(reference_round, second_round):
    keys, msgs, dks = reference_round
    keys2, msgs2, dks2 = second_round
    assert keys[0].paillier_key_vec[0].n != keys2[0].paillier_key_vec[0].n
    sessions = [(msgs, keys[1], dks[1], ()), (msgs2, keys2[2], dks2[2], ())]
    errs, got_keys, stats = _port_sessions(sessions)
    want_errs, _, want_stats = _jax_sessions(sessions)
    assert errs == want_errs == [None, None]
    assert stats == want_stats
    assert stats["xsession_rows_deduped"] == 0
    for session, got in zip(sessions, got_keys):
        (own_err,), (own_key,), _ = _jax_sessions([session])
        assert own_err is None
        assert key_fields(got) == key_fields(own_key)


def test_malformed_session_is_isolated(reference_round):
    """A PDL proof whose z is not an integer makes the fused pair batch
    raise while it stages; each session is retried alone, so the malformed
    one gets the error and the other adopts."""
    keys, msgs, dks = reference_round
    bad = copy.deepcopy(msgs)
    p = bad[BAD_SENDER].pdl_proof_vec[0]
    bad[BAD_SENDER].pdl_proof_vec[0] = dataclasses.replace(p, z=None)
    sessions = [(bad, keys[0], dks[0], ()), (msgs, keys[1], dks[1], ())]
    want_errs, want_keys, _ = _jax_sessions(sessions)
    errs, got_keys, _ = _port_sessions(sessions)
    assert want_errs[1] is None and errs[1] is None
    assert type(errs[0]) is type(want_errs[0]) is TypeError
    assert key_fields(got_keys[1]) == key_fields(want_keys[1])
    # the malformed session was not adopted
    assert key_fields(got_keys[0]) == key_fields(keys[0])


def _synthetic_call(bad_rows):
    """A fused call over two parallel lists that raises when its slice
    holds a row of `bad_rows`, else gives (x * 2, x + 1) a row."""
    def call(a, b):
        if any(x in bad_rows for x in a):
            raise ValueError(f"bad rows {sorted(set(a) & bad_rows)}")
        return [x * 2 for x in a], [y + 1 for y in b]
    return call


@pytest.mark.parametrize("bad_rows", [set(), {4}, {0, 9}, set(range(10))],
                         ids=["clean", "one", "two", "all"])
def test_fused_isolated_walks_as_the_reference(bad_rows):
    lists = (list(range(10)), list(range(100, 110)))
    spans = {0: (0, 3), 1: (3, 6), 2: (6, 10)}
    outs = []
    for impl in (refresh.fused_isolated, jrefresh.fused_isolated):
        errors = [None, None, None]
        res = impl(_synthetic_call(bad_rows), lists, spans, errors)
        outs.append((tuple(map(list, res)), [str(e) if e else None for e in errors]))
    assert outs[0] == outs[1]
    _, errs = outs[0]
    assert [e is not None for e in errs] == [
        any(r in bad_rows for r in range(lo, hi)) for lo, hi in spans.values()]


@pytest.mark.parametrize("bad", [(), (5,), (1, 17), (0, 8, 9, 20)])
def test_bisect_sessions_walks_as_the_reference(bad):
    """The same sub-checks in the same order and the same verdicts as the
    JAX package's bisect_sessions, over 24 rows of three sessions whose
    rows interleave."""
    owner = [i % 3 for i in range(24)]
    walks = []
    for impl in (rlc, jrlc):
        calls = []

        def combined(sub, calls=calls):
            calls.append(("c", tuple(sub)))
            return not set(sub) & set(bad)

        def exact(i, calls=calls):
            calls.append(("r", i))
            return i not in bad

        before = impl.stats()["session_bisects"]
        verdicts = impl.bisect_sessions(list(range(24)), owner.__getitem__, combined, exact)
        walks.append((verdicts, calls, impl.stats()["session_bisects"] - before))
    assert walks[0] == walks[1]
    verdicts, _, session_bisects = walks[0]
    assert session_bisects == 3
    assert [i for i, ok in sorted(verdicts.items()) if not ok] == sorted(bad)


def _pair_row(msgs, key, sender, receiver):
    msg = msgs[sender]
    dlog = key.h1_h2_n_tilde_vec[receiver]
    st = PDLwSlackStatement(
        ciphertext=msg.points_encrypted_vec[receiver], ek=key.paillier_key_vec[receiver],
        Q=msg.points_committed_vec[receiver], G=GENERATOR, h1=dlog.g, h2=dlog.ni,
        N_tilde=dlog.N)
    return ((msg.pdl_proof_vec[receiver], st),
            (msg.range_proofs[receiver], msg.points_encrypted_vec[receiver],
             key.paillier_key_vec[receiver], dlog))


@pytest.mark.parametrize("cls", [PDLwSlackProof, PDLwSlackStatement, AliceProof, EncryptionKey,
                                 DLogStatement, Point])
def test_pair_row_types_hash_by_value(reference_round, cls):
    """Dedup keys rows by value: each component type is a frozen dataclass
    (Point: hashed by its coordinates), and a deep copy of a row hashes and compares equal to it, while another row
    does not."""
    keys, msgs, _ = reference_round
    port_msgs, port_key = from_reference(msgs), from_reference(keys[0])
    row = _pair_row(port_msgs, port_key, 1, 2)
    twin = _pair_row(copy.deepcopy(port_msgs), copy.deepcopy(port_key), 1, 2)
    other = _pair_row(port_msgs, port_key, 2, 2)

    def parts(r):
        (proof, st), (rproof, _, ek, dlog) = r
        return [x for x in (proof, st, rproof, ek, dlog, st.Q) if type(x) is cls]

    (a,), (b,), (c,) = parts(row), parts(twin), parts(other)
    assert a is not b and a == b and hash(a) == hash(b)
    if cls is not EncryptionKey and cls is not DLogStatement:
        assert a != c  # (another sender to the same receiver shares its keys)
    if dataclasses.is_dataclass(cls):
        assert cls.__dataclass_params__.frozen
    else:  # Point: immutable by convention, hashed by its coordinates
        assert hash(Point(a.x, a.y)) == hash(a)
    assert hash(row) == hash(twin) and row == twin and row != other
