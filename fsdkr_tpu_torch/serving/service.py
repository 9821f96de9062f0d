"""RefreshService: the long-running multi-committee serving loop (an own
copy of fsdkr_tpu/serving/service.py, bound to the port's
`distribute_batch`, `StreamingCollect`, `finalize_streams` and JSON
wire).

fs-dkr's refresh is ONE broadcast round, so served throughput is a
scheduling problem: keep the verify/prove engines busy while many
committees cycle through admit -> distribute -> collect. This service
composes `distribute_batch`'s fused prover columns, the precompute pools
with their background producer, streaming collect
(`protocol.streaming`) and the fused quorum-time finalize into a
scheduler:

- `admit(committee_id, keys, ...)` registers a committee and hands its
  SLO to the CapacityPlanner (pool depth targets under the committee's
  serving owner tag).
- `start()` starts the worker, launcher and reaper threads and the
  precompute producer, which fills the planner's targets; `stop()` joins
  them all and stops the producer (raising what a producer step raised).
- `submit(committee_id)` enqueues one refresh session. The admission
  queue holds PUBLIC metadata only (ids, timestamps); key material stays
  in the per-committee table and is touched only by the protocol calls.
- Worker threads run the prover side (`distribute_batch` under the
  committee's owner scope, so it claims the planner's pools) and feed
  the broadcast messages into per-party `StreamingCollect` sessions —
  eager per-message verification happens here, spread over the arrival
  window.
- A launcher thread coalesces quorum-ready sessions into fused
  `finalize_streams` launches sized by the BatchPolicy (size-or-linger),
  then rotates committee state and retargets the planner (the eks just
  rotated, so the pool targets must follow) and kicks the producer.

Lifecycle per session: admitted -> pooled (queued) -> distributing ->
collecting -> ready -> finalizing -> done | aborted | timed_out, each
transition stamped and exported through the `fsdkr_serving_*` metrics
(serving.metrics). A submission can also be REJECTED at admission
(overload / bisection-storm shedding, `ServeRejected` with a
retry-after hint) — a rejection never becomes a session.

## Failure semantics

Every submitted session reaches exactly one terminal state:

- **done** — verified and adopted; the committee's epoch advanced.
- **aborted** — a protocol verdict (`FsDkrError`: identifiable-abort
  blame; never retried — the transcript is the evidence) or a transient
  infrastructure failure that exhausted its retries (`sess.blame` is
  False there: infrastructure exhaustion must never read as blame).
- **timed_out** — the `deadline_s` deadline passed (monotonic reaper).
  The error names the missing senders when the session was collecting.
- **rejected** — shed at admission; `submit` raised ServeRejected with
  a retry-after hint and no session exists.

Transient failures (anything that is NOT an FsDkrError: a dying worker
thread, a failed finalize launch, injected chaos) retry with jittered
exponential backoff up to `retries`. Retries are SAFE: distribute
restarts from scratch before any key mutation, and collect is a pure
function of the staged public messages until adoption. A worker thread
killed mid-session settles only its own session and is respawned by its
trampoline; the admission queue is never wedged.

The JAX package's FSDKR_SERVE=0 arm (submit runs `distribute_batch` +
`collect_sessions` synchronously) is not ported: a caller that wants
the single-shot path calls those two directly.

## Threads on one card

The worker, launcher, reaper and producer threads all launch kernels.
The wrappers launch on the calling thread's current stream, the legacy
default stream here, so launches from different threads serialize on
the card in the order they are issued; each launch's inputs and outputs
are its own tensors. The pool store, the precompute cache, the launch
counters (`ops.tally`) and the verifier's statistics take locks.

Concurrency rules: at most one in-flight session per committee (a
refresh mutates the committee's LocalKeys; sessions for one committee
serialize through the busy flag while other committees proceed), and
`offer`/`finalize` for one streaming session never race (offers happen
on the worker or the reaper before the session is published to the
ready list; the launcher finalizes only published sessions, and marks
them `finalizing` under the service lock — the reaper never touches a
`finalizing` session).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import precompute
from ..config import ProtocolConfig, DEFAULT_CONFIG
from ..errors import FsDkrError
from ..protocol.refresh import RefreshMessage
from ..protocol.serialization import refresh_message_from_json, refresh_message_to_json
from ..protocol.streaming import finalize_streams
from ..telemetry import flight
from . import faults, metrics
from .journal import Journal
from .planner import SLO, CapacityPlanner, serve_owner
from .policy import BatchPolicy, BisectGuard, OverloadPolicy

__all__ = [
    "RefreshService",
    "ServeSession",
    "ServeRejected",
    "SessionTimeout",
]

# terminal session states: _finish is idempotent against them, so a
# worker, the reaper, and the launcher can settle the same session
# concurrently and exactly one transition wins
TERMINAL = ("done", "aborted", "timed_out")


def _device_count(device: str) -> int:
    """Devices the fused finalize could spread over, for the BatchPolicy's
    batch alignment: the cards torch sees for a cuda service, 1 for a
    cpu one."""
    if device != "cuda":
        return 1
    import torch

    return max(1, torch.cuda.device_count())


class ServeRejected(RuntimeError):
    """submit() shed this request at admission (overload or
    bisection-storm budget). Carries an honest retry-after hint; the
    request never became a session, so nothing was spent on it —
    clients retry with `retry_after_s` the way they would honor a
    429/Retry-After."""

    def __init__(self, committee_id, retry_after_s: float, reason: str):
        self.committee_id = committee_id
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        super().__init__(
            f"admission rejected for committee {committee_id!r} "
            f"({reason}); retry after {self.retry_after_s:.2f}s"
        )


class SessionTimeout(RuntimeError):
    """A session crossed its deadline (`RefreshService(deadline_s=)`). When the
    session was collecting, `missing` names the senders whose broadcast
    never arrived — the quorum gap is identifiable, mirroring abort
    blame (a timed-out session is never confused with a verdict)."""

    def __init__(self, state: str, missing: Sequence[int], waited_s: float):
        self.state = state
        self.missing = list(missing)
        self.waited_s = waited_s
        detail = f"; missing senders {self.missing}" if self.missing else ""
        super().__init__(
            f"session deadline exceeded after {waited_s:.2f}s in state "
            f"{state!r}{detail}"
        )


@dataclass
class ServeSession:
    """Public per-session record. Queue/state fields are broadcast-safe
    metadata; the streaming collectors (which hold broadcast messages
    and verdicts) hang off the internal `_streams` and never enter the
    admission queue. `faults` lists the injected-fault sites that hit
    this session (site names + sender indices only — chaos-run
    accounting, never key material)."""

    session_id: int
    committee_id: object
    state: str = "admitted"
    epoch: Optional[int] = None
    submitted_at: float = 0.0
    started_at: float = 0.0
    quorum_at: float = 0.0
    finalized_at: float = 0.0
    deadline: float = 0.0
    retries: int = 0
    blame: bool = False
    error: Optional[str] = None
    faults: List[str] = field(default_factory=list)
    # network-fed session: the worker runs distribute and
    # parks the wire-serialized broadcasts in `_wire_msgs` instead of
    # self-feeding the collectors; the ingress hands them to the client
    # (the broadcast channel) and routes the returned broadcasts back
    # through `offer_external`. Broadcasts are public by definition —
    # `_wire_msgs` holds exactly what any party would see on the wire.
    external: bool = False
    _wire_msgs: List[Tuple[int, str]] = field(
        default_factory=list, repr=False
    )
    _not_before: float = 0.0
    _pending: List[Tuple[float, object]] = field(
        default_factory=list, repr=False
    )
    _streams: list = field(default_factory=list, repr=False)
    _config: Optional[ProtocolConfig] = field(default=None, repr=False)
    _done_evt: threading.Event = field(
        default_factory=threading.Event, repr=False
    )
    # set once distribute finished for an external session (wire
    # broadcasts available) — or at terminal, whichever comes first
    _dist_evt: threading.Event = field(
        default_factory=threading.Event, repr=False
    )


@dataclass
class _Committee:
    keys: list
    config: ProtocolConfig
    slo: SLO
    # session id currently holding the one-in-flight-per-committee
    # slot, or None. Ownership matters: only the holder's settle path
    # may free it — a reaper timing out a QUEUED sibling must not
    # release a slot some other live session owns (two concurrent
    # refreshes would adopt into the same LocalKeys)
    busy: Optional[int] = None
    epochs: int = 0


class RefreshService:
    """See module docstring. Construct, `admit` committees, `start()`,
    then `submit`/`wait`/`drain`; `stop()` joins the threads."""

    def __init__(
        self,
        policy: Optional[BatchPolicy] = None,
        planner: Optional[CapacityPlanner] = None,
        workers: int = 1,
        overload: Optional[OverloadPolicy] = None,
        guard: Optional[BisectGuard] = None,
        deadline_s: float = 0.0,
        retries: int = 2,
        backoff_s: float = 0.05,
        journal=None,
        keystore=None,
        history: int = 65536,
        device: str = "cuda",
    ):
        """Every knob is an argument at the JAX package's default (there
        the FSDKR_SERVE_* variables): `workers` (FSDKR_SERVE_WORKERS),
        `deadline_s` (FSDKR_SERVE_DEADLINE_S, 0 = no reaper timeouts),
        `retries` (FSDKR_SERVE_RETRIES: transient-failure requeues and
        finalize relaunches), `backoff_s` (FSDKR_SERVE_BACKOFF_MS / 1000),
        `history` (FSDKR_SERVE_HISTORY: finished sessions retained).

        `journal` is a serving.journal.Journal or a directory path; when
        set, every session's public facts (admission, accepted broadcasts
        via the wire codec, terminal verdicts) are write-ahead logged so
        serving.recovery can replay them after process death. `keystore`
        holds the SECRET side (committee LocalKeys, per-session new dks)
        in process memory only — defaulted so an in-process restart
        recovers fully.

        `device` is the torch device of every admitted committee's
        config and of every committee recovery re-admits. A "cuda"
        service raises here when torch finds no card: there is no host
        fallback."""
        if device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {device!r}")
        if device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "RefreshService(device='cuda') but torch finds no CUDA "
                    "device; pass device='cpu' to serve on the plain versions"
                )
        self.device = device
        if isinstance(journal, (str, os.PathLike)):
            journal = Journal(journal)
        self.journal = journal
        if keystore is None and journal is not None:
            from .recovery import MemoryKeystore

            keystore = MemoryKeystore()
        self.keystore = keystore
        self.policy = policy or BatchPolicy(devices=_device_count(device))
        self.planner = planner or CapacityPlanner()
        self.overload = overload or OverloadPolicy()
        self.guard = guard or BisectGuard()
        self.workers = max(1, workers)
        self.deadline_s = deadline_s
        self.retries = max(0, retries)
        self.backoff_s = max(0.0, backoff_s)
        self._committees: Dict[object, _Committee] = {}
        # ACTIVE sessions only; finished ones move to the bounded
        # history below so a long-running service cannot grow without
        # bound (and stats() never scans more than inflight + history)
        self._sessions: Dict[int, ServeSession] = {}
        self._finished: "OrderedDict[int, ServeSession]" = OrderedDict()
        self._history = max(1, history)
        self._queue: deque = deque()  # session ids, FIFO (public metadata)
        self._ready: List[int] = []  # quorum-ready session ids
        # failed finalize launches awaiting their backoff: (not-before,
        # attempt, batch) — requeued, NEVER slept out on the launcher
        # thread (other committees' ready sessions must not wait behind
        # one batch's backoff)
        self._retry_batches: List[Tuple[float, int, List[ServeSession]]] = []
        # client-retry idempotency: (committee_id, epoch) -> session id
        self._epoch_index: Dict[Tuple[object, int], int] = {}
        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)
        self._ready_cv = threading.Condition(self._lock)
        self._reap_cv = threading.Condition(self._lock)
        self._idle_cv = threading.Condition(self._lock)
        self._next_id = 0
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._inflight = 0
        self.sessions_done = 0
        self.sessions_aborted = 0
        self.sessions_timed_out = 0
        self.sessions_rejected = 0
        self.sessions_replayed = 0
        self.workers_respawned = 0
        # windowed end-to-end latencies for THIS service's overload
        # gate (not the cumulative histogram, which never forgets a
        # storm; not process-global state, which a sibling service
        # would pollute). The ring turns over with traffic, so the
        # gate reads the current regime — timeouts included
        # deliberately: persistent overload producing timeouts is
        # exactly what should shed. Guarded by self._lock.
        self._recent_totals: deque = deque(maxlen=256)

    # -- journal plumbing ------------------------------------------------
    def _jappend(self, rec: dict) -> None:
        """Append one record when journaling is on. Raises on IO
        failure — an admission or broadcast that cannot be made durable
        must fail loudly (the worker retry path treats it as any other
        transient infrastructure failure)."""
        if self.journal is not None:
            self.journal.append(rec)

    def _jappend_safe(self, rec: dict) -> None:
        """Best-effort append for the TERMINAL path: a dying journal
        must never leave a finished session's waiters hanging. A
        swallowed failure means the record is missing from the log, so
        replay sees the session in-flight and settles it retryably —
        degraded durability, never a wrong verdict."""
        try:
            self._jappend(rec)
        except Exception:
            flight.record("journal", "terminal_append_failed")

    def _deposit_dks(self, sess: ServeSession, dks: Sequence) -> None:
        """Park the session's new decryption keys (party order) in the
        in-memory keystore so an in-process recovery can resume the
        session; dropped at terminal. Never serialized, never on
        disk."""
        if self.keystore is not None and self.journal is not None:
            self.keystore.put_session_dks(
                sess.committee_id, sess.session_id, dks
            )

    def _offer_all(self, sess: ServeSession, streams, msg, wire=None) -> str:
        """Offer one broadcast message to every collector of a session
        and journal it IFF it was accepted (first arrival wins: the
        accepted copy — tampered or honest — is what replay must
        re-offer). `wire` lets recovery re-journal the exact bytes it
        replayed instead of re-serializing."""
        res = None
        for st in streams:
            r = st.offer(msg)
            res = r if res is None else res
        if res == "accepted" and self.journal is not None:
            self._jappend(
                {
                    "t": "broadcast",
                    "sid": sess.session_id,
                    "sender": msg.party_index,
                    "wire": wire or refresh_message_to_json(msg),
                }
            )
        return res or "unexpected"

    # -- committee membership -------------------------------------------
    def admit(
        self,
        committee_id,
        keys: Sequence,
        config: ProtocolConfig = DEFAULT_CONFIG,
        slo: SLO = SLO(),
    ) -> None:
        """Register a committee (its parties' LocalKeys, in index order)
        and install its SLO-derived pool targets. The config's device
        must be the service's."""
        if config.device != self.device:
            raise ValueError(
                f"committee {committee_id!r} runs on {config.device!r}, the "
                f"service on {self.device!r}"
            )
        if self.journal is not None:
            # the id must survive the wire ROUND-TRIP, not just encode:
            # a tuple id serializes fine but decodes as an unhashable
            # list, which would abort the entire replay at recovery —
            # far too late to discover it
            try:
                ok = json.loads(json.dumps(committee_id)) == committee_id
            except TypeError:
                ok = False
            if not ok:
                raise TypeError(
                    "journaled committee ids must round-trip through "
                    "JSON (use str/int ids; got "
                    f"{type(committee_id).__name__})"
                )
            # WAL the committee record BEFORE any in-memory state: a
            # failed append must leave nothing half-admitted (the
            # caller can simply retry admit). A duplicate-admit that
            # fails below leaves a redundant record; replay keys
            # committees by id, so last-wins is harmless.
            from .recovery import config_record

            self._jappend(
                {
                    "t": "committee",
                    "cid": committee_id,
                    "n": len(keys),
                    "tt": keys[0].t,
                    "config": config_record(config),
                }
            )
        with self._lock:
            if committee_id in self._committees:
                raise ValueError(f"committee {committee_id!r} already admitted")
            self._committees[committee_id] = _Committee(
                keys=list(keys), config=config, slo=slo
            )
            metrics.committees_gauge().set(len(self._committees))
        if self.keystore is not None:
            self.keystore.put_committee(committee_id, keys)
        self.planner.register(committee_id, keys[0], len(keys), config, slo)

    def evict(self, committee_id) -> None:
        """Remove a committee; its pool targets are invalidated and the
        pooled single-use secrets wiped now (churn discipline). Its
        idempotency entries die with it — a committee re-admitted under
        the same id is a NEW incarnation whose epochs must actually
        run, not replay a dead predecessor's finished sessions."""
        with self._lock:
            com = self._committees.pop(committee_id, None)
            metrics.committees_gauge().set(len(self._committees))
            for key in [
                k for k in self._epoch_index if k[0] == committee_id
            ]:
                del self._epoch_index[key]
        if com is not None:
            self.planner.invalidate(committee_id)
        if self.keystore is not None:
            self.keystore.drop_committee(committee_id)

    def _measured_p99_s(self) -> float:
        """Exact p99 over this service's last 256 finished sessions
        (the overload gate's load signal; 0.0 before any finish).
        Caller holds self._lock."""
        if not self._recent_totals:
            return 0.0
        vals = sorted(self._recent_totals)
        return vals[min(len(vals) - 1, int(round(0.99 * (len(vals) - 1))))]

    # -- session intake -------------------------------------------------
    def submit(
        self,
        committee_id,
        epoch: Optional[int] = None,
        external: bool = False,
    ) -> int:
        """Enqueue one refresh session for the committee; returns the
        session id.

        `epoch` makes the submission IDEMPOTENT: a resubmission with
        the same (committee fingerprint, epoch) returns the EXISTING
        session id — in flight or already finished — instead of
        enqueuing a double-spend of pooled key bundles. This is the
        client-retry contract a real ingress needs: retry the same
        logical refresh freely, observe one session. A FAILED epoch
        (aborted/timed_out) becomes retryable again — the next submit
        creates a fresh session. Retention bound: a completed epoch's
        dedupe entry lives as long as its session stays in the bounded
        history (`history` finishes, like an idempotency-key TTL) — a
        retry arriving later than that re-runs the refresh. Without
        `epoch` every call is a new session.

        `external=True` makes this a NETWORK-FED session:
        the worker still runs distribute (the service holds the
        committee's keys), but instead of simulating the broadcast
        channel in-process it parks the wire-serialized broadcasts for
        the client to fetch (`wait_broadcasts`) and re-deliver
        (`offer_external`) — the messages actually transit the network.
        An external session can only terminate via delivered broadcasts
        or the deadline reaper, so the service MUST have a deadline
        (an abandoned client must not wedge its committee forever).

        Raises `ServeRejected` (with a retry-after hint) when the
        overload policy or the committee's bisection-storm budget sheds
        the request at admission."""
        if external and self.deadline_s <= 0:
            raise ValueError(
                "external sessions require a session deadline "
                "(deadline_s > 0): an abandoned client would wedge its "
                "committee forever"
            )
        now = time.monotonic()
        with self._lock:
            com = self._committees.get(committee_id)
            if com is None:
                raise KeyError(f"committee {committee_id!r} not admitted")
            if epoch is not None:
                sid = self._epoch_index.get((committee_id, epoch))
                if sid is not None:
                    return sid
            hint, reason = None, ""
            b = self.guard.blocked(committee_id, now)
            if b is not None:
                hint, reason = b, "bisection budget exhausted"
            if hint is None and self.overload.engaged():
                h = self.overload.check(
                    len(self._queue),
                    self._measured_p99_s(),
                    com.slo.p99_budget_s,
                )
                if h is not None:
                    hint, reason = h, "overload"
            if hint is not None:
                self.sessions_rejected += 1
                metrics.record_outcome("rejected", 0.0)
                raise ServeRejected(committee_id, hint, reason)
            self._next_id += 1
            sess = ServeSession(
                session_id=self._next_id,
                committee_id=committee_id,
                epoch=epoch,
                submitted_at=now,
                external=external,
            )
            if self.deadline_s > 0:
                sess.deadline = now + self.deadline_s
            # register fully (dedup index, session table, inflight) but
            # do NOT make it runnable yet — concurrent duplicate
            # submits dedupe to it and wait() finds it while we journal
            if epoch is not None:
                self._epoch_index[(committee_id, epoch)] = sess.session_id
            self._sessions[sess.session_id] = sess
            self._inflight += 1
            metrics.inflight_gauge().set(self._inflight)
        # WAL the admission OUTSIDE the lock (sync=always fsyncs here —
        # that must stall only this submitter, not every worker). The
        # session is not queued yet, so `admitted` still precedes any
        # `collecting` a worker could journal for it.
        try:
            self._jappend(
                {
                    "t": "admitted",
                    "sid": sess.session_id,
                    "cid": committee_id,
                    "epoch": epoch,
                }
            )
        except Exception as e:
            # a session that never became durable never runs — but a
            # concurrent duplicate submit may already hold its sid (the
            # dedup index was live while we journaled), so SETTLE it
            # (_finish: aborted without blame, epoch entry dropped,
            # waiters woken) instead of vanishing it, then surface the
            # journal failure to this submitter
            self._finish(sess, e, time.monotonic())
            raise
        with self._lock:
            sess.state = "pooled"
            self._queue.append(sess.session_id)
            metrics.queue_gauge().set(len(self._queue))
            self._work_cv.notify()
            if sess.deadline:
                self._reap_cv.notify()
            return sess.session_id

    def wait(self, session_id: int, timeout: Optional[float] = None) -> ServeSession:
        """Block until the session reaches a terminal state and return
        it. Raises `TimeoutError` when `timeout` elapses first — a
        timeout is DISTINGUISHABLE from completion; this never hands
        back a possibly-unfinished session."""
        with self._lock:
            sess = self._sessions.get(session_id) or self._finished.get(
                session_id
            )
        if sess is None:
            raise KeyError(
                f"session {session_id} unknown (finished sessions are "
                f"retained up to history={self._history})"
            )
        if not sess._done_evt.wait(timeout):
            raise TimeoutError(
                f"session {session_id} still {sess.state!r} after "
                f"{timeout}s"
            )
        return sess

    # -- network-fed sessions (the TCP ingress's surface; the ingress is
    # not ported yet) ---------------------------------------------------
    def wait_broadcasts(
        self, session_id: int, timeout: Optional[float] = None
    ) -> Tuple[str, List[Tuple[int, str]]]:
        """Block until an external session's distribute outputs exist
        (or the session went terminal first) and return
        ``(state, [(sender, wire_json), ...])``. The wire list is empty
        once terminal — the caller reads the state instead. Raises
        `TimeoutError` when `timeout` elapses, `KeyError` for unknown
        sessions (same retention contract as `wait`)."""
        with self._lock:
            sess = self._sessions.get(session_id) or self._finished.get(
                session_id
            )
        if sess is None:
            raise KeyError(f"session {session_id} unknown")
        if not sess._dist_evt.wait(timeout):
            raise TimeoutError(
                f"session {session_id} still {sess.state!r} after "
                f"{timeout}s (no broadcasts yet)"
            )
        with self._lock:
            return sess.state, list(sess._wire_msgs)

    def offer_external(self, session_id: int, wire: str) -> str:
        """Deliver one broadcast (wire JSON) into an external session's
        collectors through the SAME offer path every other arrival
        uses — journaled iff accepted, first arrival wins. Returns
        "accepted" / "duplicate" / "unexpected" (wrong sender, or the
        session is not network-fed) / "late" (already terminal or past
        quorum) / "unknown" (no such session) / "pending" (distribute
        still running — a protocol-violating client broadcasting before
        it ever received the session's broadcast set). Raises whatever
        the wire codec raises on an undecodable payload — the ingress
        translates that into its malformed-frame policy. Thread-safe:
        concurrent offers from many connections interleave freely
        (arrival-order independence is pinned), and quorum publishes
        exactly once via the state transition under the lock."""
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None:
                return (
                    "late" if session_id in self._finished else "unknown"
                )
            if not sess.external:
                return "unexpected"
            if sess.state in TERMINAL or sess.state in (
                "ready", "finalizing",
            ):
                return "late"
            streams = list(sess._streams)
            if not streams:
                return "pending"
        msg = refresh_message_from_json(wire)  # codec outside the lock
        res = self._offer_all(sess, streams, msg, wire=wire)
        if res == "accepted":
            with self._lock:
                if (
                    sess.state == "collecting"
                    and sess._streams
                    and all(st.ready for st in sess._streams)
                ):
                    # exactly-one publish: the state transition is the
                    # guard (a racing offer sees "ready" and stops)
                    sess.state = "ready"
                    sess.quorum_at = time.monotonic()
                    self._ready.append(sess.session_id)
                    self._ready_cv.notify()
        return res

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every submitted session finished (True) or the
        timeout elapsed (False). Condition-variable wait — wakes on the
        final _finish, not on a poll tick."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle_cv.wait(timeout=remaining)
            return True

    # -- service threads ------------------------------------------------
    def start(self) -> None:
        """Start the service threads and the precompute producer, which
        fills the planner's pool targets."""
        if self._threads:
            return
        self._stop.clear()
        for w in range(self.workers):
            t = threading.Thread(
                target=self._worker_trampoline, args=(w,),
                name=f"fsdkr-serve-worker-{w}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        for target, name in (
            (self._launcher_loop, "fsdkr-serve-launcher"),
            (self._reaper_loop, "fsdkr-serve-reaper"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        precompute.kick()

    def stop(self, timeout: float = 10.0) -> None:
        """Join the service threads, close the journal and stop the
        precompute producer; raises the first exception a producer step
        raised (`precompute.stop_background`)."""
        self._stop.set()
        with self._lock:
            self._work_cv.notify_all()
            self._ready_cv.notify_all()
            self._reap_cv.notify_all()
            self._idle_cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads.clear()
        if self.journal is not None:
            self.journal.close()
        precompute.stop_background(timeout=timeout)

    # -- internals: prover/stream side ----------------------------------
    def _pop_work(self, now: float):
        """Under the lock: the first queued session whose committee is
        idle and whose retry backoff has elapsed (FIFO per committee;
        other committees' sessions overtake a busy one). Returns
        (session, None) or (None, seconds-until-next-backoff-expiry)."""
        next_wake: Optional[float] = None
        for idx, sid in enumerate(self._queue):
            sess = self._sessions.get(sid)
            if sess is None or sess.state in TERMINAL:
                del self._queue[idx]  # reaped while queued
                return None, 0.0  # rescan immediately
            com = self._committees.get(sess.committee_id)
            if com is None:
                # evicted mid-queue: abort below, outside the scan
                del self._queue[idx]
                return sess, None
            if sess._not_before > now:
                dt = sess._not_before - now
                next_wake = dt if next_wake is None else min(next_wake, dt)
                continue
            if com.busy is None:
                com.busy = sess.session_id
                del self._queue[idx]
                return sess, None
        return None, next_wake

    def _worker_trampoline(self, w: int) -> None:
        """Crash isolation: a worker whose loop dies (an injected
        worker crash, or any bug escaping the per-session handler) is
        respawned here — the failing session was already settled by
        `_session_failed`, the committee freed, and the admission queue
        keeps draining. One crash costs one session attempt, never the
        service."""
        while not self._stop.is_set():
            try:
                self._worker_loop()
                return  # clean stop
            except Exception:
                self.workers_respawned += 1

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                if self._stop.is_set():
                    return
                sess, wake = self._pop_work(time.monotonic())
                if sess is None:
                    if wake != 0.0:
                        self._work_cv.wait(timeout=wake)
                    continue
                metrics.queue_gauge().set(len(self._queue))
                com = self._committees.get(sess.committee_id)
            if com is None:
                self._finish(
                    sess, RuntimeError("committee evicted"), time.monotonic()
                )
                continue
            try:
                self._run_session(sess, com)
            except Exception as e:  # distribute/offer/injected failures
                self._session_failed(sess, com, e)
                if isinstance(e, faults.InjectedWorkerCrash):
                    raise  # the thread dies; the trampoline respawns it

    def _session_failed(self, sess: ServeSession, com, e: Exception) -> None:
        """Settle a failed worker attempt: protocol verdicts abort with
        blame immediately; transient failures requeue with jittered
        exponential backoff until `retries` is spent."""
        now = time.monotonic()
        requeue = False
        with self._lock:
            if com is not None and com.busy == sess.session_id:
                com.busy = None
                self._work_cv.notify()
            if sess.state in TERMINAL:
                return  # the reaper settled it first
            transient = not isinstance(e, FsDkrError)
            # external sessions never requeue: a retried attempt would
            # re-run distribute with FRESH randomness, and the client
            # may already hold (and re-deliver) the failed attempt's
            # broadcasts — pairing one attempt's messages with
            # another's secrets is exactly the replay shape recovery
            # forbids. The failed epoch drops its dedupe entry at
            # _finish, so the client's resubmit starts a clean session
            # under a NEW sid (stale broadcasts to the old sid are
            # "late", never mixed in).
            if transient and sess.retries < self.retries and not sess.external:
                sess.retries += 1
                backoff = self.backoff_s * (2 ** (sess.retries - 1))
                backoff *= 1.0 + random.random()  # jitter: decorrelate herds
                sess._not_before = now + backoff
                sess.state = "pooled"
                sess._streams = []
                requeue = True
        if not requeue:
            self._finish(sess, e, now)
            return
        # WAL the attempt boundary OUTSIDE the service lock (the
        # journal fsyncs under its own lock, as in submit's admission
        # append): the retried attempt re-runs distribute with fresh
        # randomness, so the
        # failed attempt's journaled broadcasts (and deposited dks) are
        # stale — a replay mixing attempts would pair one attempt's
        # messages with another's secrets. The reset record makes
        # replay start from the latest attempt only; ordering is safe
        # because the session is not queued yet, so the next attempt
        # cannot journal anything before the reset lands.
        self._jappend_safe({"t": "reset", "sid": sess.session_id})
        if self.keystore is not None:
            self.keystore.drop_session(sess.committee_id, sess.session_id)
        with self._lock:
            if sess.state != "pooled":
                return  # the reaper timed it out while we journaled
            self._queue.append(sess.session_id)
            metrics.queue_gauge().set(len(self._queue))
            metrics.retries_counter().inc(stage="worker")
            self._work_cv.notify()

    def _advance(self, sess: ServeSession, state: str) -> bool:
        """Move a session to a non-terminal lifecycle state, under the
        lock, UNLESS it already reached a terminal state (the reaper
        can settle a session while a worker is mid-flight on it; a
        plain write here would resurrect it and double-finish). False
        = the session is already settled, the caller must discard its
        attempt."""
        with self._lock:
            if sess.state in TERMINAL:
                return False
            sess.state = state
            return True

    def _run_session(self, sess: ServeSession, com: _Committee) -> None:
        plan = faults.active()
        now = time.monotonic()
        metrics.record_phase("queue", now - sess.submitted_at)
        sess.started_at = now
        if not self._advance(sess, "distributing"):
            return  # reaped while queued; _finish already freed busy
        if plan and plan.fire("worker_crash", (sess.session_id, sess.retries)):
            sess.faults.append("worker_crash")
            raise faults.InjectedWorkerCrash(
                f"injected worker crash (session {sess.session_id}, "
                f"attempt {sess.retries})"
            )
        keys, config = com.keys, com.config
        new_n = len(keys)
        # roll EVERY broadcast-fault decision up front — decisions are
        # pure functions of (seed, session, sender index), so they need
        # no message content — and stamp sess.faults BEFORE distribute:
        # a deadline firing at any later point can already name the
        # full dropped-sender set (precedence per message: drop >
        # tamper > delay > dup)
        actions: Dict[int, Optional[str]] = {}
        if plan is not None and not sess.external:
            # external sessions skip the in-process arrival simulation
            # entirely — their chaos is the NETWORK's (conn_drop /
            # frame_truncate / net_* fire at the ingress, and the client
            # is free to drop/duplicate/tamper what it re-broadcasts)
            for k in keys:
                pid = k.i
                for site in ("msg_drop", "msg_tamper", "msg_delay",
                             "msg_dup"):
                    if plan.fire(site, (sess.session_id, pid)):
                        actions[pid] = site
                        sess.faults.append(f"{site}:{pid}")
                        break
        owner = serve_owner(sess.committee_id)
        with precompute.owner_scope(owner):
            results = RefreshMessage.distribute_batch(
                [(k.i, k) for k in keys], new_n, config
            )
        # the distribute drained pools other targets share (the key
        # material): wake the producer
        precompute.kick()
        t_dist = time.monotonic()
        metrics.record_phase("distribute", t_dist - now)

        msgs = [m for m, _ in results]
        if not self._advance(sess, "collecting"):
            return  # reaped while distributing; attempt discarded
        expected = [k.i for k in keys]
        # secrets to the keystore (memory only), public facts to the WAL
        self._deposit_dks(sess, [dk for _m, dk in results])
        self._jappend(
            {"t": "collecting", "sid": sess.session_id, "expected": expected}
        )
        streams = [
            RefreshMessage.collect_stream(k, results[idx][1], expected, (), config)
            for idx, k in enumerate(keys)
        ]
        if sess.external:
            # network-fed: serialize the broadcasts ONCE (public wire
            # encoding), park them for the client, and hand the session
            # to the collecting state — every delivery from here on
            # comes through offer_external (ingress) or dies at the
            # deadline, which names the senders the network lost
            wire_msgs = [
                (m.party_index, refresh_message_to_json(m)) for m in msgs
            ]
            with self._lock:
                if sess.state in TERMINAL:
                    for st in streams:
                        st.close(RuntimeError("session already settled"))
                    return
                sess._streams = streams
                sess._config = config
                sess._wire_msgs = wire_msgs
                sess.state = "collecting"
                self._reap_cv.notify()
            sess._dist_evt.set()
            return
        # simulated broadcast arrival: each message lands at every
        # collector before the next arrives; order is session-seeded so
        # reordering is exercised continuously in production-like runs.
        # Under a fault plan a message may instead be dropped, tampered
        # (tampered copy first, honest copy as the corrected duplicate —
        # first arrival wins), delayed (delivered by the reaper after
        # delay_s), or duplicated.
        order = list(msgs)
        random.Random(sess.session_id).shuffle(order)
        pending: List[Tuple[float, object]] = []
        for m in order:
            if sess.state in TERMINAL:
                break  # reaped mid-arrival: stop burning verify time
            act = actions.get(m.party_index)
            if act == "msg_drop":
                continue
            if act == "msg_tamper":
                bad = faults.tamper_message(m)
                # the TAMPERED copy is what gets accepted (and hence
                # journaled — replay must reproduce the blame); the
                # honest copy lands as the corrected duplicate
                self._offer_all(sess, streams, bad)
                self._offer_all(sess, streams, m)
                continue
            if act == "msg_delay":
                pending.append((time.monotonic() + plan.delay_s, m))
                continue
            if act == "msg_dup":
                self._offer_all(sess, streams, m)
            self._offer_all(sess, streams, m)
        t_stream = time.monotonic()
        metrics.record_phase("stream", t_stream - t_dist)

        timeout_now = False
        with self._lock:
            if sess.state in TERMINAL:
                # the reaper settled this session while we were
                # distributing; discard the attempt's streams
                for st in streams:
                    st.close(RuntimeError("session already settled"))
                return
            sess._streams = streams
            sess._config = config
            sess.quorum_at = t_stream
            if all(st.ready for st in streams):
                sess.state = "ready"
                self._ready.append(sess.session_id)
                self._ready_cv.notify()
            else:
                # short of quorum: park for late (delayed) arrivals —
                # the reaper delivers `pending` and publishes at quorum,
                # or times the session out at its deadline, naming the
                # missing senders
                sess.state = "collecting"
                sess._pending = pending
                if pending or sess.deadline:
                    self._reap_cv.notify()
                else:
                    # nothing will ever arrive and no deadline is set:
                    # settle now instead of wedging (drop faults without
                    # a deadline must still terminate)
                    timeout_now = True
        if timeout_now:
            self._timeout_session(sess)

    # -- internals: deadline reaper + delayed delivery ------------------
    def _reaper_loop(self) -> None:
        """Monotonic-clock timekeeper: delivers delayed broadcast
        messages when due and moves sessions past their deadline to the
        `timed_out` terminal state. Never touches a session the
        launcher already marked `finalizing`."""
        while True:
            deliveries: List[Tuple[ServeSession, list]] = []
            timeouts: List[ServeSession] = []
            with self._lock:
                if self._stop.is_set():
                    return
                now = time.monotonic()
                next_wake: Optional[float] = None
                for sess in list(self._sessions.values()):
                    if sess.state in TERMINAL or sess.state == "finalizing":
                        continue
                    if sess.deadline and now >= sess.deadline:
                        timeouts.append(sess)
                        continue
                    if sess._pending:
                        due = [m for t, m in sess._pending if t <= now]
                        if due:
                            sess._pending = [
                                (t, m) for t, m in sess._pending if t > now
                            ]
                            deliveries.append((sess, due))
                        for t, _m in sess._pending:
                            next_wake = (
                                t if next_wake is None else min(next_wake, t)
                            )
                    if sess.deadline:
                        next_wake = (
                            sess.deadline
                            if next_wake is None
                            else min(next_wake, sess.deadline)
                        )
                if not deliveries and not timeouts:
                    self._reap_cv.wait(
                        timeout=None if next_wake is None else
                        max(0.001, next_wake - now)
                    )
                    continue
            # timeouts FIRST: a delivery runs real proof verification
            # (StreamingCollect.offer) on this thread, and expired
            # sessions must not wait behind it. Deliveries stay on this
            # one thread deliberately — it serializes offers per parked
            # session (offer/finalize must never race) — so a deadline
            # expiring MID-delivery-batch is observed one batch late;
            # the lateness is bounded by one wake's delivery work and
            # only exists under injected msg_delay storms.
            for sess in timeouts:
                self._timeout_session(sess)
            for sess, due in deliveries:
                try:
                    for m in due:
                        self._offer_all(sess, sess._streams, m)
                except Exception as e:
                    # a failing delivery (journal IO, a codec bug) must
                    # settle the session, never kill the reaper thread;
                    # close the collectors like every other failure
                    # path (late offers -> "late", staged refs freed)
                    for st in sess._streams:
                        st.close(e)
                    self._finish(sess, e, time.monotonic())
                    continue
                dead_end = False
                with self._lock:
                    if (
                        sess.state == "collecting"
                        and sess._streams
                        and all(st.ready for st in sess._streams)
                    ):
                        sess.state = "ready"
                        sess.quorum_at = time.monotonic()
                        self._ready.append(sess.session_id)
                        self._ready_cv.notify()
                    elif (
                        sess.state == "collecting"
                        and not sess._pending
                        and not sess.deadline
                    ):
                        # the last delayed message just landed, the
                        # session is STILL short of quorum (a dropped
                        # sender), and no deadline will ever fire:
                        # settle now instead of wedging
                        dead_end = True
                if dead_end:
                    self._timeout_session(sess)

    def _timeout_session(self, sess: ServeSession) -> None:
        with self._lock:
            if sess.state in TERMINAL or sess.state == "finalizing":
                return
            try:
                self._queue.remove(sess.session_id)
            except ValueError:
                pass
            self._ready = [s for s in self._ready if s != sess.session_id]
            metrics.queue_gauge().set(len(self._queue))
            # name the quorum gap: senders the collectors are missing,
            # UNION the drops already rolled for this session (streams
            # may not be attached yet when the deadline fires mid-offer
            # — the pre-rolled fault stamps still name the culprits)
            missing = sorted(
                {pid for st in sess._streams for pid in st.missing()}
                | {
                    int(f.split(":", 1)[1])
                    for f in sess.faults
                    if f.startswith("msg_drop:")
                }
            )
            state0 = sess.state
            waited = time.monotonic() - sess.submitted_at
            streams = list(sess._streams)
        err = SessionTimeout(state0, missing, waited)
        for st in streams:
            st.close(err)  # late offers -> "late"; staged refs released
        self._finish(sess, err, time.monotonic(), state="timed_out")

    # -- internals: coalescing finalize side ----------------------------
    def _pick_batch(self) -> List[ServeSession]:
        """Under the lock: choose the batch to finalize now (oldest
        config group, policy-sized), or [] to keep lingering. Sessions
        the reaper settled while they sat in the ready list are swept
        out here."""
        live: List[ServeSession] = []
        for sid in self._ready:
            s = self._sessions.get(sid)
            if s is not None and s.state == "ready":
                live.append(s)
        if len(live) != len(self._ready):
            self._ready = [s.session_id for s in live]
        if not live:
            return []
        groups: Dict[object, List[ServeSession]] = {}
        for s in live:
            groups.setdefault(s._config, []).append(s)
        # oldest-first: the group containing the longest-waiting session
        group = min(groups.values(), key=lambda g: g[0].quorum_at)
        oldest_wait = time.monotonic() - group[0].quorum_at
        rows = 0
        if group[0]._streams:
            st0 = group[0]._streams[0]
            rows = len(st0.expected) * st0.new_n * len(group[0]._streams)
        count = self.policy.take(len(group), oldest_wait, rows)
        if count <= 0:
            return []
        batch = group[:count]
        taken = {s.session_id for s in batch}
        self._ready = [sid for sid in self._ready if sid not in taken]
        return batch

    def _launcher_loop(self) -> None:
        while True:
            with self._lock:
                if self._stop.is_set():
                    return
                now = time.monotonic()
                batch: List[ServeSession] = []
                attempt = 0
                next_retry: Optional[float] = None
                for i, (due, att, b) in enumerate(self._retry_batches):
                    if due <= now:
                        batch, attempt = b, att
                        del self._retry_batches[i]
                        break
                    next_retry = (
                        due if next_retry is None else min(next_retry, due)
                    )
                if not batch:
                    batch = self._pick_batch()
                    for sess in batch:
                        sess.state = "finalizing"  # reaper hands-off
                if not batch:
                    timeout = None
                    if self._ready:
                        oldest = min(
                            self._sessions[sid].quorum_at
                            for sid in self._ready
                        )
                        timeout = max(
                            0.005,
                            self.policy.wait_budget(
                                time.monotonic() - oldest
                            ),
                        )
                    if next_retry is not None:
                        dt = max(0.005, next_retry - now)
                        timeout = dt if timeout is None else min(timeout, dt)
                    self._ready_cv.wait(timeout=timeout)
                    continue
            self._finalize_batch(batch, attempt)

    def _finalize_batch(self, batch: List[ServeSession], attempt: int = 0) -> None:
        t0 = time.monotonic()
        config = batch[0]._config
        streams = []
        for sess in batch:
            if attempt == 0:
                metrics.record_phase("coalesce", t0 - sess.quorum_at)
            streams.extend(sess._streams)
        if attempt == 0:
            metrics.batch_histogram().observe(len(streams))
        plan = faults.active()
        bisect0 = metrics.rlc_bisect_count()
        batch_key = batch[0].session_id
        try:
            if plan and plan.fire("finalize_exc", (batch_key, attempt)):
                for sess in batch:
                    sess.faults.append("finalize_exc")
                raise faults.InjectedFinalizeError(
                    f"injected finalize failure (batch {batch_key}, "
                    f"attempt {attempt})"
                )
            errors = finalize_streams(streams, config)
        except Exception as e:
            # a raise here is infrastructure (protocol verdicts come
            # back in `errors`, isolated per session): retry with
            # jittered backoff — safe, finalize is pure over the
            # staged public messages until adoption, and an
            # already-finalized stream replays its stored verdict. The
            # batch is REQUEUED with a not-before, never slept out on
            # this (sole) launcher thread.
            if attempt >= self.retries:
                t1 = time.monotonic()
                for sess in batch:
                    for st in sess._streams:
                        st.close(e)
                    self._finish(sess, e, t1)
                return
            metrics.retries_counter().inc(stage="finalize")
            backoff = self.backoff_s * (2 ** attempt) * (1.0 + random.random())
            with self._lock:
                self._retry_batches.append(
                    (time.monotonic() + backoff, attempt + 1, batch)
                )
                self._ready_cv.notify()
            return
        t1 = time.monotonic()
        pos = 0
        for sess in batch:
            n = len(sess._streams)
            errs = [e for e in errors[pos : pos + n] if e is not None]
            pos += n
            metrics.record_phase("finalize", t1 - t0)
            self._finish(sess, errs[0] if errs else None, t1)
        # bisection-storm accounting (ROADMAP 5b): bisections in this
        # launch are the attributable cost of tampered traffic — honest
        # transcripts bisect zero times — so charge them to the blamed
        # sessions' committees; over-budget committees are shed at
        # admission until their window rolls
        delta = metrics.rlc_bisect_count() - bisect0
        if delta > 0 and self.guard.enabled():
            blamed = [s for s in batch if s.blame]
            if blamed:
                share = -(-delta // len(blamed))  # ceil-split
                for s in blamed:
                    self.guard.charge(s.committee_id, share)

    def _finish(
        self,
        sess: ServeSession,
        error: Optional[Exception],
        now: float,
        state: Optional[str] = None,
    ) -> None:
        """Move a session to its terminal state (exactly once: callers
        may race, the first transition wins) and release every resource
        it held — committee busy flag, stream references, inflight
        accounting."""
        with self._lock:
            if sess.state in TERMINAL:
                return
            sess.state = state or ("done" if error is None else "aborted")
            sess.finalized_at = now
            sess._streams = []
            sess._pending = []
            sess._wire_msgs = []
            if error is not None:
                sess.blame = isinstance(error, FsDkrError)
                sess.error = f"{type(error).__name__}: {error}"
            com = self._committees.get(sess.committee_id)
            if com is not None:
                # free the slot ONLY if this session holds it: a session
                # settled while still queued never acquired it, and the
                # current holder must keep its exclusivity
                if com.busy == sess.session_id:
                    com.busy = None
                    self._work_cv.notify()
                if sess.state == "done":
                    com.epochs += 1
            self._inflight -= 1
            self.sessions_done += sess.state == "done"
            self.sessions_aborted += sess.state == "aborted"
            self.sessions_timed_out += sess.state == "timed_out"
            metrics.inflight_gauge().set(self._inflight)
            if sess.state != "done" and sess.epoch is not None:
                # a FAILED epoch must stay retryable: drop the dedupe
                # entry so the client's next submit(cid, epoch) creates
                # a fresh session (done sessions keep deduping — that
                # refresh happened; handing it back is the contract)
                key = (sess.committee_id, sess.epoch)
                if self._epoch_index.get(key) == sess.session_id:
                    del self._epoch_index[key]
            # retire into the bounded history (memory stays O(history))
            self._sessions.pop(sess.session_id, None)
            self._finished[sess.session_id] = sess
            self._trim_history_locked()
            if self._inflight == 0:
                self._idle_cv.notify_all()
            final_state = sess.state
            self._recent_totals.append(now - sess.submitted_at)
        self._jappend_safe(
            {
                "t": "terminal",
                "sid": sess.session_id,
                "cid": sess.committee_id,
                "epoch": sess.epoch,
                "state": final_state,
                "blame": sess.blame,
                "error": sess.error,
            }
        )
        if self.keystore is not None:
            # terminal: the session's new dks are no longer re-derivable
            # material, they are either adopted or dead — drop them
            self.keystore.drop_session(sess.committee_id, sess.session_id)
        metrics.record_outcome(final_state, now - sess.submitted_at)
        # the committee's eks just rotated (or the session died): refresh
        # the SLO-derived pool targets against the live key state and
        # wake the producer — collect's kick has often drained by now
        if final_state == "done":
            self.planner.retarget(sess.committee_id)
            precompute.kick()
        # a terminal state also releases any wait_broadcasts() waiter
        sess._dist_evt.set()
        sess._done_evt.set()

    def _trim_history_locked(self) -> None:
        """Caller holds self._lock: evict finished sessions past the
        bounded history, dropping each evicted session's idempotency
        entry ONLY if it still maps to that session — a failed
        predecessor may have been superseded by a live retry session
        whose mapping must survive."""
        while len(self._finished) > self._history:
            _sid, old = self._finished.popitem(last=False)
            if old.epoch is not None:
                key = (old.committee_id, old.epoch)
                if self._epoch_index.get(key) == old.session_id:
                    del self._epoch_index[key]

    # -- recovery surface (driven by serving.recovery) ------------------
    def has_committee(self, committee_id) -> bool:
        with self._lock:
            return committee_id in self._committees

    def committee_size(self, committee_id) -> int:
        with self._lock:
            com = self._committees.get(committee_id)
            return len(com.keys) if com is not None else 0

    def reserve_session_ids(self, max_seen: int) -> None:
        """Never re-issue a session id a journal already used: a
        same-directory restart appends new records to the log the NEXT
        recovery reads, and colliding sids would merge two logical
        sessions in replay."""
        with self._lock:
            self._next_id = max(self._next_id, int(max_seen))

    def restore_terminal(
        self,
        committee_id,
        epoch: Optional[int],
        state: str,
        blame: bool,
        error: Optional[str],
        rejournal: bool = True,
    ) -> int:
        """Replay a journaled terminal verdict verbatim — no recompute,
        no adoption, no outcome metrics (the work happened in a prior
        incarnation; `fsdkr_journal_replayed` counts it instead). Done
        epochs re-enter the idempotency index so `submit(cid, epoch=N)`
        keeps deduping across the restart. `rejournal=False` skips the
        self-containment copy — recovery passes it when replaying the
        service's OWN journal directory, where the record already lives
        (re-journaling there would double the terminal set on every
        restart)."""
        if state not in TERMINAL:
            raise ValueError(f"not a terminal state: {state!r}")
        with self._lock:
            self._next_id += 1
            sess = ServeSession(
                session_id=self._next_id,
                committee_id=committee_id,
                state=state,
                epoch=epoch,
            )
            now = time.monotonic()
            sess.submitted_at = sess.finalized_at = now
            sess.blame = bool(blame)
            sess.error = error
            sess._done_evt.set()
            if state == "done":
                com = self._committees.get(committee_id)
                if com is not None:
                    com.epochs += 1
                if epoch is not None:
                    self._epoch_index[(committee_id, epoch)] = sess.session_id
            self.sessions_replayed += 1
            self._finished[sess.session_id] = sess
            self._trim_history_locked()
        # re-journal into THIS incarnation's log (when it is a
        # DIFFERENT directory) so the chain stays self-contained: a
        # second death recovers from this journal alone, without
        # walking predecessors
        if rejournal:
            self._jappend_safe(
                {
                    "t": "terminal",
                    "sid": sess.session_id,
                    "cid": committee_id,
                    "epoch": epoch,
                    "state": state,
                    "blame": bool(blame),
                    "error": error,
                    "replayed": True,
                }
            )
        return sess.session_id

    def _supersede_journaled(
        self, origin_sid: Optional[int], committee_id, epoch, new_sid: int
    ) -> None:
        """Close a journaled predecessor session's log entry once its
        work has been taken over under a new sid. Without this, a
        SECOND recovery of the same directory would see the origin sid
        still in-flight (its keystore dks possibly intact) and re-run
        it against already-rotated committee keys — a wrong verdict
        waiting to happen. The origin's dks are dropped with it."""
        if origin_sid is None:
            return
        self._jappend_safe(
            {
                "t": "terminal",
                "sid": origin_sid,
                "cid": committee_id,
                "epoch": epoch,
                "state": "aborted",
                "blame": False,
                "error": f"superseded by recovery into session {new_sid}",
                "replayed": True,
            }
        )
        if self.keystore is not None:
            self.keystore.drop_session(committee_id, origin_sid)

    def finish_unrecoverable(
        self,
        committee_id,
        epoch: Optional[int],
        error: Exception,
        origin_sid: Optional[int] = None,
    ) -> int:
        """A journaled in-flight session whose secret state cannot be
        re-derived: admit it and settle it `aborted` WITHOUT blame in
        one stroke — the error is not an FsDkrError, so the abort reads
        transient and the epoch becomes resubmittable (the `_finish`
        path drops the idempotency entry for non-done epochs). Never a
        fabricated verdict."""
        with self._lock:
            if committee_id not in self._committees:
                raise KeyError(f"committee {committee_id!r} not admitted")
            self._next_id += 1
            sess = ServeSession(
                session_id=self._next_id,
                committee_id=committee_id,
                epoch=epoch,
                submitted_at=time.monotonic(),
            )
            sess.state = "collecting"
            if epoch is not None:
                self._epoch_index[(committee_id, epoch)] = sess.session_id
            self._sessions[sess.session_id] = sess
            self._inflight += 1
            metrics.inflight_gauge().set(self._inflight)
        # WAL OUTSIDE the service lock (journal fsyncs under its own
        # lock); best-effort: this whole path is already degraded
        # durability, and one journal IO failure here must not abort
        # the caller's replay loop (a lost record just means the next
        # recovery settles the origin session again). `admitted` still
        # precedes the supersede/_finish terminals below.
        self._jappend_safe(
            {
                "t": "admitted",
                "sid": sess.session_id,
                "cid": committee_id,
                "epoch": epoch,
            }
        )
        self._supersede_journaled(
            origin_sid, committee_id, epoch, sess.session_id
        )
        self._finish(sess, error, time.monotonic())
        return sess.session_id

    def resume_session(
        self,
        committee_id,
        epoch: Optional[int],
        dks: Sequence,
        expected: Sequence[int],
        broadcasts: Sequence[Tuple[int, str]],
        origin_sid: Optional[int] = None,
    ) -> int:
        """Resume a journaled in-flight session: fresh StreamingCollect
        collectors from the committee's live LocalKeys + the keystore's
        re-derived dks, the journaled accepted broadcasts re-offered in
        acceptance order through the SAME offer path live traffic uses,
        then back into the ordinary lifecycle (launcher finalize at
        quorum, reaper deadline otherwise). Verdict + blame are
        bit-identical to the uninterrupted run by the shared-helper
        equivalence."""
        with self._lock:
            com = self._committees.get(committee_id)
            if com is None:
                raise KeyError(f"committee {committee_id!r} not admitted")
            if com.busy is not None:
                raise RuntimeError(
                    f"committee {committee_id!r} busy during recovery"
                )
            self._next_id += 1
            sess = ServeSession(
                session_id=self._next_id,
                committee_id=committee_id,
                epoch=epoch,
            )
            now = time.monotonic()
            sess.submitted_at = sess.started_at = now
            if self.deadline_s > 0:
                sess.deadline = now + self.deadline_s
            sess.state = "collecting"
            sess._config = com.config
            if epoch is not None:
                self._epoch_index[(committee_id, epoch)] = sess.session_id
            self._sessions[sess.session_id] = sess
            self._inflight += 1
            metrics.inflight_gauge().set(self._inflight)
            com.busy = sess.session_id
            keys = com.keys
        # from here on the session owns the committee's busy slot and
        # the inflight count: ANY failure must settle it through
        # _finish (which releases both) — raising out of this method
        # would leak the slot and wedge the committee forever. The
        # admission WAL append happens here, OUTSIDE the service lock
        # (journal fsyncs under its own lock) and inside the
        # settle-on-failure region; `admitted` still precedes
        # `collecting` because both moved with it, in order.
        streams = []
        try:
            self._jappend(
                {
                    "t": "admitted",
                    "sid": sess.session_id,
                    "cid": committee_id,
                    "epoch": epoch,
                }
            )
            self._jappend(
                {
                    "t": "collecting",
                    "sid": sess.session_id,
                    "expected": list(expected),
                }
            )
            self._supersede_journaled(
                origin_sid, committee_id, epoch, sess.session_id
            )
            self._deposit_dks(sess, dks)
            streams = [
                RefreshMessage.collect_stream(
                    k, dk, expected, (), sess._config
                )
                for k, dk in zip(keys, dks)
            ]
            for sender, wire in broadcasts:
                msg = refresh_message_from_json(wire)
                self._offer_all(sess, streams, msg, wire=wire)
        except Exception as e:
            for st in streams:
                st.close(e)
            self._finish(sess, e, time.monotonic())
            return sess.session_id
        timeout_now = False
        with self._lock:
            if sess.state in TERMINAL:
                # the deadline fired while the replay offers ran
                for st in streams:
                    st.close(RuntimeError("session settled during recovery"))
                return sess.session_id
            sess._streams = streams
            sess.quorum_at = time.monotonic()
            if all(st.ready for st in streams):
                sess.state = "ready"
                self._ready.append(sess.session_id)
                self._ready_cv.notify()
            elif sess.deadline:
                self._reap_cv.notify()
            else:
                # short of quorum with no deadline: the journal holds
                # everything that will ever arrive — settle now, naming
                # the missing senders, instead of wedging
                timeout_now = True
        if timeout_now:
            self._timeout_session(sess)
        return sess.session_id

    # -- introspection --------------------------------------------------
    def stats(self) -> dict:
        """Session counts by state. Raises the first exception a
        precompute producer step raised: a producer that cannot launch
        must not leave every distribute quietly inline."""
        err = precompute.producer_error()
        if err is not None:
            raise err
        with self._lock:
            # active sessions only: the scan is bounded by inflight, not
            # by the lifetime session count
            states: Dict[str, int] = {}
            for s in self._sessions.values():
                states[s.state] = states.get(s.state, 0) + 1
            states["done"] = self.sessions_done
            states["aborted"] = self.sessions_aborted
            states["timed_out"] = self.sessions_timed_out
            return {
                "committees": len(self._committees),
                "inflight": self._inflight,
                "queued": len(self._queue),
                "ready": len(self._ready),
                "sessions_done": self.sessions_done,
                "sessions_aborted": self.sessions_aborted,
                "sessions_timed_out": self.sessions_timed_out,
                "sessions_rejected": self.sessions_rejected,
                "sessions_replayed": self.sessions_replayed,
                "workers_respawned": self.workers_respawned,
                "states": states,
            }
