"""Streaming collect: verify refresh broadcast messages incrementally as
they arrive instead of at the all-messages barrier.

The barrier path (`RefreshMessage.collect` / `collect_sessions`) gathers
every message first, then runs each verification family as one fused
batch. In a serving loop that wastes the arrival window: by the time the
last committee member's broadcast lands, nothing has been checked. Here
a `StreamingCollect` session does the per-message work EAGERLY on each
`offer` (wire-shape and broadcast-public-key gates, the message's Feldman
rows, its ring-Pedersen and Paillier correct-key proofs) and stages the
O(n) pair rows (PDL-with-slack + Alice range), whose RLC fold runs once
at quorum in `finalize` / `finalize_streams` (fused across every
quorum-ready session a caller batches, exactly the batch shape
`collect_sessions` uses).

## Equivalence contract

Verdicts, identifiable-abort blame, and LocalKey mutation are identical
to barrier `collect` on the canonical message list (the arrived messages
in `expected_senders` order). The mechanism is structural: every check
order, error construction and mutation point lives in the shared
per-session stages of `protocol.refresh` (check_structure / pair_blame /
share_recovery_check / adopt_session), and `finalize` replays the
barrier's phase order over the eagerly computed verdicts. Eager results
are per-message and order-independent, so arrival order, duplicates
(first arrival wins) and late messages (after finalize) cannot change
the outcome. An exception of an eager backend call (on the card: a
failed launch) is recorded as that message's result and replayed at its
phase's place in the barrier order; it is never retried on the host.

## Secrecy

Streaming partial state holds broadcast messages, boolean verdicts and
staged (proof, statement) rows, all broadcast-public. The receiver's
secrets (paillier_dk, the new dk) are only touched inside the shared
`adopt_session` at finalize, as on the barrier path.

## Memory

A session's staged pair rows are REFERENCES into the broadcast messages,
O(n) per arrived message (`stream_rows()` sums them over the open
sessions); the wide staged operands only materialize at finalize, which
runs `verify_pairs` and so inherits the memory plan's tiles
(backend.memplan, FSDKRC_MEM_BUDGET_MB).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

from ..backend import get_backend
from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..core.paillier import DecryptionKey
from ..core.secp256k1 import GENERATOR
from ..errors import PublicShareValidationError, RingPedersenProofError
from ..proofs.pdl_slack import PDLwSlackStatement
from ..proofs.composite_dlog import DLogStatement
from ..telemetry.spans import phase
from .local_key import LocalKey
from .refresh import (
    RefreshMessage,
    adopt_session,
    check_structure,
    fused_isolated,
    pair_blame,
    share_recovery_check,
)

__all__ = ["StreamingCollect", "finalize_streams", "stream_rows"]


class StreamingCollect:
    """One receiver's incremental collect session.

    Lifecycle: construct (expected sender set fixed) -> `offer` each
    arriving RefreshMessage (any order; duplicates ignored) -> once
    `ready`, `finalize()`, or batch it with other sessions into one fused
    `finalize_streams` call. `offer` and `finalize` must not race each
    other (the caller serializes them; they may run on different
    threads).
    """

    def __init__(
        self,
        local_key: LocalKey,
        new_dk: DecryptionKey,
        expected_senders: Optional[Sequence[int]] = None,
        join_messages: Sequence = (),
        config: ProtocolConfig = DEFAULT_CONFIG,
    ):
        if expected_senders is None:
            expected_senders = range(1, local_key.n + 1)
        self.expected: Tuple[int, ...] = tuple(expected_senders)
        if len(set(self.expected)) != len(self.expected):
            raise ValueError("expected_senders must be distinct")
        self.joins = tuple(join_messages)
        self.new_n = len(self.expected) + len(self.joins)
        self.local_key = local_key
        self.new_dk = new_dk
        self.config = config
        self._backend = get_backend(config)
        self._lock = threading.Lock()
        # per-arrived-message state, keyed by party index; values are
        # verdict lists/bools or the Exception the eager backend call
        # raised (finalize replays them in canonical order)
        self._msgs: Dict[int, RefreshMessage] = {}
        self._feld: Dict[int, object] = {}
        self._rp: Dict[int, object] = {}
        self._ck: Dict[int, object] = {}
        self._pairs: Dict[int, Tuple[list, list]] = {}
        self._done = False
        self._result: Optional[Exception] = None

    # -- arrival --------------------------------------------------------
    def offer(self, msg: RefreshMessage) -> str:
        """Accept one broadcast message and run its eager checks.
        Returns "accepted", "duplicate" (party already arrived — first
        arrival wins), "late" (session already finalized), or
        "unexpected" (party not in the expected sender set)."""
        with self._lock:
            if self._done:
                return "late"
            pid = msg.party_index
            if pid not in self.expected:
                return "unexpected"
            if pid in self._msgs:
                return "duplicate"
            self._msgs[pid] = msg
        self._eager(pid, msg)
        return "accepted"

    def _eager(self, pid: int, msg: RefreshMessage) -> None:
        """Per-message eager work: structural gate, Feldman rows,
        ring-Pedersen, correct-key, pair-row staging. Backend exceptions
        are recorded, not raised — finalize surfaces them with barrier
        ordering. Every verdict here is order-independent (a function of
        this message + the receiver's pre-adopt key vectors alone)."""
        with phase("collect.stream.offer", items=self.new_n):
            self._eager_checks(pid, msg)

    def _eager_checks(self, pid: int, msg: RefreshMessage) -> None:
        key = self.local_key
        lens = (
            len(msg.pdl_proof_vec),
            len(msg.points_committed_vec),
            len(msg.points_encrypted_vec),
        )
        ok = (
            all(l == self.new_n for l in lens)
            and len(msg.range_proofs) == self.new_n
            and msg.public_key == key.y_sum_s
        )
        if not ok:
            # finalize's check_structure raises the barrier-ordered
            # error; eager verification of a malformed message could
            # only crash the codecs the barrier never reaches
            return
        try:
            self._feld[pid] = list(
                self._backend.validate_feldman(
                    [
                        (
                            msg.coefficients_committed_vec,
                            msg.points_committed_vec[i],
                            i + 1,
                        )
                        for i in range(self.new_n)
                    ]
                )
            )
        except Exception as e:
            self._feld[pid] = e
        try:
            self._rp[pid] = list(
                self._backend.verify_ring_pedersen(
                    [(msg.ring_pedersen_proof, msg.ring_pedersen_statement)],
                    self.config.m_security,
                )
            )[0]
        except Exception as e:
            self._rp[pid] = e
        try:
            self._ck[pid] = list(
                self._backend.verify_correct_key(
                    [(msg.dk_correctness_proof, msg.ek)],
                    self.config.correct_key_rounds,
                )
            )[0]
        except Exception as e:
            self._ck[pid] = e
        # stage the pair rows; their fold is the quorum-time launch
        pdl_rows, range_rows = [], []
        for i in range(self.new_n):
            st = PDLwSlackStatement(
                ciphertext=msg.points_encrypted_vec[i],
                ek=key.paillier_key_vec[i],
                Q=msg.points_committed_vec[i],
                G=GENERATOR,
                h1=key.h1_h2_n_tilde_vec[i].g,
                h2=key.h1_h2_n_tilde_vec[i].ni,
                N_tilde=key.h1_h2_n_tilde_vec[i].N,
            )
            pdl_rows.append((msg.pdl_proof_vec[i], st))
            range_rows.append(
                (
                    msg.range_proofs[i],
                    msg.points_encrypted_vec[i],
                    key.paillier_key_vec[i],
                    key.h1_h2_n_tilde_vec[i],
                )
            )
        self._pairs[pid] = (pdl_rows, range_rows)
        _track_session(self)

    # -- introspection --------------------------------------------------
    @property
    def arrived(self) -> int:
        return len(self._msgs)

    @property
    def ready(self) -> bool:
        """Quorum: every expected sender's message has arrived."""
        return not self._done and len(self._msgs) == len(self.expected)

    @property
    def done(self) -> bool:
        return self._done

    @property
    def error(self) -> Optional[Exception]:
        """The finalize verdict (None = success); None before finalize."""
        return self._result

    def missing(self) -> List[int]:
        return [pid for pid in self.expected if pid not in self._msgs]

    def canonical_msgs(self) -> List[RefreshMessage]:
        """The arrived messages in expected-sender order — the exact
        list barrier `collect` would be called with."""
        return [self._msgs[pid] for pid in self.expected]

    def close(self, error: Optional[Exception] = None) -> bool:
        """Terminate this session WITHOUT adoption — the deadline
        reaper's entry point and a teardown hygiene hook.
        Marks the session done with `error` as its stored verdict and
        releases the staged pair-row references now; afterwards `offer`
        returns "late" and any finalize (including a fused launch
        already holding this session) replays the stored verdict
        instead of verifying or mutating the LocalKey. Returns False
        (no-op) when the session already finished — a completed verdict
        is never overwritten."""
        with self._lock:
            if self._done:
                return False
            self._done = True
            self._result = error
            self._pairs.clear()
            return True

    # -- completion -----------------------------------------------------
    def finalize(self) -> None:
        """Finish this session alone: quorum-time pair fold + the
        barrier-ordered verdict replay + adoption. Raises exactly what
        barrier `collect` would; idempotent (a second finalize re-raises
        the stored verdict without re-verifying or re-adopting)."""
        err = finalize_streams([self], self.config)[0]
        if err is not None:
            raise err


def finalize_streams(
    streams: Sequence[StreamingCollect],
    config: ProtocolConfig = DEFAULT_CONFIG,
) -> List[Optional[Exception]]:
    """Finish many quorum-ready streaming sessions with the pair-family
    fold fused across all of them (row layout as `collect_sessions`'s:
    cross-session dedup and session-first blame included). All
    sessions must share `config`. Returns one entry per session — None
    on success or the exception barrier `collect` would have raised; a
    failing session never blocks the others. Already-finalized sessions
    replay their stored verdict; sessions short of quorum get a
    ValueError entry and stay open."""
    S = len(streams)
    errors: List[Optional[Exception]] = [None] * S
    with phase("collect.stream.finalize", items=S, sessions=S):
        return _finalize_impl(streams, errors, config)


def _finalize_impl(streams, errors, config):
    backend = get_backend(config)
    # (the JAX package wakes its background pool producer here; in the
    # port the serving layer, which starts the producer, kicks it)
    S = len(streams)
    msgs_l: List[Optional[list]] = [None] * S
    replayed = set()
    for s, st in enumerate(streams):
        if st._done:
            errors[s] = st._result
            replayed.add(s)
            continue
        missing = st.missing()
        if missing:
            errors[s] = ValueError(
                f"streaming session short of quorum: missing senders {missing}"
            )
            replayed.add(s)  # stays open: do not mark done below
            continue
        msgs_l[s] = st.canonical_msgs()

    def alive():
        return [
            s for s in range(S) if errors[s] is None and msgs_l[s] is not None
        ]

    # ---- 1. structure, canonical order (shared helper) ----------------
    for s in alive():
        try:
            check_structure(msgs_l[s], streams[s].local_key, streams[s].new_n)
        except Exception as e:
            errors[s] = e

    # ---- 2. Feldman replay --------------------------------------------
    for s in alive():
        st = streams[s]
        verdicts: List[bool] = []
        exc = None
        for pid in st.expected:
            r = st._feld.get(pid)
            if isinstance(r, Exception):
                exc = r
                break
            verdicts.extend(r)
        if exc is not None:
            errors[s] = exc
        elif not all(verdicts):
            errors[s] = PublicShareValidationError()

    # ---- 3. pair fold at quorum, fused across sessions ----------------
    pdl_items: list = []
    range_items: list = []
    pair_spans: Dict[int, Tuple[int, int]] = {}
    for s in alive():
        st = streams[s]
        lo = len(pdl_items)
        for pid in st.expected:
            p_rows, r_rows = st._pairs[pid]
            pdl_items.extend(p_rows)
            range_items.extend(r_rows)
        pair_spans[s] = (lo, len(pdl_items))
    if pdl_items:
        # spans ride only on the full fused call (cross-session dedup +
        # session-first blame in CudaBatchVerifier.verify_pairs); per-session
        # retry slices are single-session, where spans would be stale
        def _pairs_call(p_slice, r_slice):
            if len(p_slice) == len(pdl_items):
                return backend.verify_pairs(
                    p_slice, r_slice, session_spans=pair_spans
                )
            return backend.verify_pairs(p_slice, r_slice)

        pdl_verdicts, range_verdicts = fused_isolated(
            _pairs_call, (pdl_items, range_items), pair_spans, errors
        )
        for s, (lo, _hi) in pair_spans.items():
            if errors[s] is not None:
                continue
            try:
                pair_blame(
                    msgs_l[s], streams[s].new_n,
                    pdl_verdicts, range_verdicts, lo,
                )
            except Exception as e:
                errors[s] = e

    # ---- 4. ring-Pedersen: eager verdicts + the joins' rows -----------
    jrp_items: list = []
    jrp_spans: Dict[int, Tuple[int, int]] = {}
    for s in alive():
        lo = len(jrp_items)
        jrp_items += [
            (j.ring_pedersen_proof, j.ring_pedersen_statement)
            for j in streams[s].joins
        ]
        jrp_spans[s] = (lo, len(jrp_items))
    jrp_verdicts = (
        fused_isolated(
            lambda items: (
                backend.verify_ring_pedersen(items, config.m_security),
            ),
            (jrp_items,),
            jrp_spans,
            errors,
        )[0]
        if jrp_items
        else []
    )
    for s in alive():
        st = streams[s]
        verdicts, exc = [], None
        for pid in st.expected:
            r = st._rp.get(pid)
            if isinstance(r, Exception):
                exc = r
                break
            verdicts.append(r)
        if exc is not None:
            errors[s] = exc
            continue
        lo, hi = jrp_spans[s]
        if not (all(verdicts) and all(jrp_verdicts[lo:hi])):
            errors[s] = RingPedersenProofError()

    # ---- 5. share recovery (host) -------------------------------------
    sums: Dict[int, tuple] = {}
    with phase("collect.share_recovery", items=len(alive())):
        for s in alive():
            try:
                sums[s] = share_recovery_check(msgs_l[s], streams[s].local_key)
            except Exception as e:
                errors[s] = e

    # ---- 6. correct-key: eager verdicts + the joins' rows + dlog ------
    jck_items: list = []
    jck_spans: Dict[int, Tuple[int, int]] = {}
    dlog_items: list = []
    dlog_spans: Dict[int, Tuple[int, int]] = {}
    for s in alive():
        st = streams[s]
        lo = len(jck_items)
        jck_items += [(j.dk_correctness_proof, j.ek) for j in st.joins]
        jck_spans[s] = (lo, len(jck_items))
        dlo = len(dlog_items)
        for join in st.joins:
            inverse_st = DLogStatement(
                N=join.dlog_statement.N,
                g=join.dlog_statement.ni,
                ni=join.dlog_statement.g,
            )
            dlog_items.append(
                (join.composite_dlog_proof_base_h1, join.dlog_statement)
            )
            dlog_items.append((join.composite_dlog_proof_base_h2, inverse_st))
        dlog_spans[s] = (dlo, len(dlog_items))
    jck_verdicts = (
        fused_isolated(
            lambda items: (
                backend.verify_correct_key(items, config.correct_key_rounds),
            ),
            (jck_items,),
            jck_spans,
            errors,
        )[0]
        if jck_items
        else []
    )
    dlog_verdicts = (
        fused_isolated(
            lambda items: (backend.verify_composite_dlog(items),),
            (dlog_items,),
            dlog_spans,
            errors,
        )[0]
        if dlog_items
        else []
    )
    # an eager correct-key backend exception surfaces here — after share
    # recovery, before adoption: the barrier's fused-ck phase position
    ck_lists: Dict[int, list] = {}
    for s in alive():
        st = streams[s]
        verdicts, exc = [], None
        for pid in st.expected:
            r = st._ck.get(pid)
            if isinstance(r, Exception):
                exc = r
                break
            verdicts.append(r)
        if exc is not None:
            errors[s] = exc
            continue
        lo, hi = jck_spans[s]
        ck_lists[s] = verdicts + list(jck_verdicts[lo:hi])

    # ---- 7. adoption (shared helper; mutating phase) ------------------
    with phase("collect.adopt", items=len(alive())):
        for s in alive():
            st = streams[s]
            dlo, dhi = dlog_spans[s]
            try:
                adopt_session(
                    msgs_l[s], st.local_key, st.new_dk, st.joins,
                    ck_lists[s], dlog_verdicts[dlo:dhi], sums[s],
                    st.new_n, config,
                )
            except Exception as e:
                errors[s] = e

    for s, st in enumerate(streams):
        if s in replayed:
            continue
        st._done = True
        st._result = errors[s]
        # staged pair-row references retire with the session (the wide
        # staged operands already died tile-by-tile inside verify_pairs)
        st._pairs.clear()
    return errors


# Live staged pair-row accounting across open streaming sessions (module
# docstring "Memory"). A WeakSet summed on demand, not inc/dec counters: a
# caller can drop a StreamingCollect without ever reaching finalize, and a
# decrement-based count would leak upward in exactly the degraded cases it
# exists to watch. Garbage-collected sessions simply fall out of the sum.
_OPEN_SESSIONS: "weakref.WeakSet[StreamingCollect]" = weakref.WeakSet()


def stream_rows() -> int:
    """Pair rows staged across the open streaming sessions (references
    into broadcast messages): the JAX package's `fsdkr_mem_stream_rows`
    gauge, read as `backend.rlc.stats()` and `memplan.mem_stats()` are."""
    return sum(len(st._pairs) * st.new_n for st in list(_OPEN_SESSIONS))


def _track_session(st: "StreamingCollect") -> None:
    _OPEN_SESSIONS.add(st)
