"""Crash recovery: replay a journal into fresh streaming sessions through
the ordinary offer()/finalize path (an own copy of
fsdkr_tpu/serving/recovery.py).

`recover(service, journal_dir)` reads a journal
(`serving.journal.read_records`, torn-tail tolerant) and rebuilds the
dead incarnation's state inside a live `RefreshService`:

- **committee** records re-admit committees whose LocalKeys the
  keystore can supply (the supervisor re-admits explicitly before
  recovery; the keystore path covers in-process restarts).
- **terminal** records replay their stored verdict verbatim — state,
  blame flag, error string — with NO recompute
  (`RefreshService.restore_terminal`). Done epochs re-enter the
  idempotency index, so `submit(committee, epoch=N)` keeps deduping
  across the restart.
- **in-flight** sessions (admitted/collecting, no terminal record) are
  resumed only when BOTH their accepted broadcasts and their secret
  state are available: the journaled broadcasts are decoded with the
  wire codec and offered, in journal (= acceptance) order, into fresh
  `StreamingCollect` sessions built from the keystore's LocalKeys and
  per-session decryption keys. The resumed session rejoins the service
  lifecycle (`RefreshService.resume_session`) and finalizes through
  the same shared helpers as live traffic — verdict and
  identifiable-abort blame are bit-identical to the uninterrupted run
  by the same structural argument every prior equivalence held.
- a session whose secret state canNOT be re-derived (the common
  cross-process case: new decryption keys live only in the dead
  incarnation's memory) terminates ``aborted`` WITHOUT blame —
  `RecoverySecretsUnavailable` is deliberately not an FsDkrError, so
  the abort reads as transient/retryable and the epoch becomes
  resubmittable. Recovery NEVER fabricates a verdict.

Every replay decision stamps the flight recorder (kind="recovery"), so
a kill-storm postmortem shows exactly what each survivor did with the
dead shard's log.

## Secrets

The journal holds public data only; secrets come from the keystore.
`MemoryKeystore` is process-memory only — nothing it holds ever
touches disk. The service deposits each session's new decryption keys
at distribute time and drops them at terminal; committee LocalKeys are
deposited at admit.

## Committee records and the device

A committee record carries the config's public protocol parameters and
its `backend` ("host" or "cuda"; the JAX package journals "host" or
"tpu", so the two packages' segments are equal byte for byte at backend
"host"). The port's `ProtocolConfig.device` is an execution choice, not
a fact of the committee: it is never journaled, and a replayed
committee takes the device of the service it is replayed into.
"""

from __future__ import annotations

import pathlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..config import ProtocolConfig
from ..telemetry import flight, registry
from .journal import read_records

__all__ = [
    "MemoryKeystore",
    "RecoverySecretsUnavailable",
    "JournaledSession",
    "load_state",
    "recover",
    "config_from_record",
    "config_record",
]


class RecoverySecretsUnavailable(RuntimeError):
    """A journaled in-flight session whose secret state the keystore
    cannot re-derive. Deliberately NOT an FsDkrError: this is an
    infrastructure outcome (aborted_transient, retryable), never an
    identifiable-abort verdict."""


class MemoryKeystore:
    """Process-memory secret store backing recovery. Holds committee
    LocalKeys and per-session new decryption keys BY REFERENCE — it
    never serializes them and never writes them anywhere. A keystore
    outliving a service object is what makes an in-process restart
    fully recoverable; across real process death the session secrets
    are gone by design and recovery degrades to aborted_transient."""

    def __init__(self):
        self._lock = threading.Lock()
        self._committees: Dict[object, list] = {}
        self._session_dks: Dict[Tuple[object, int], list] = {}

    def put_committee(self, committee_id, keys) -> None:
        with self._lock:
            self._committees[committee_id] = list(keys)

    def committee_keys(self, committee_id) -> Optional[list]:
        with self._lock:
            return self._committees.get(committee_id)

    def drop_committee(self, committee_id) -> None:
        with self._lock:
            self._committees.pop(committee_id, None)
            for k in [
                k for k in self._session_dks if k[0] == committee_id
            ]:
                del self._session_dks[k]

    def put_session_dks(self, committee_id, session_id: int, dks) -> None:
        with self._lock:
            self._session_dks[(committee_id, session_id)] = list(dks)

    def session_dks(self, committee_id, session_id: int) -> Optional[list]:
        with self._lock:
            return self._session_dks.get((committee_id, session_id))

    def drop_session(self, committee_id, session_id: int) -> None:
        with self._lock:
            self._session_dks.pop((committee_id, session_id), None)


# ---------------------------------------------------------------------------
# journal state model


@dataclass
class JournaledSession:
    sid: int
    cid: object = None
    epoch: Optional[int] = None
    expected: Optional[List[int]] = None
    broadcasts: List[Tuple[int, str]] = field(default_factory=list)
    terminal: Optional[dict] = None


def config_record(config: ProtocolConfig) -> dict:
    """The PUBLIC config parameters a committee record carries — enough
    to reconstruct the ProtocolConfig on replay, nothing else (no
    device)."""
    return {
        "paillier_bits": config.paillier_bits,
        "m_security": config.m_security,
        "correct_key_rounds": config.correct_key_rounds,
        "backend": config.backend,
        "hash_alg": config.hash_alg,
        "curve": config.curve,
    }


def config_from_record(rec: dict, device: str) -> ProtocolConfig:
    """The ProtocolConfig of a committee record, on `device` (the
    replaying service's)."""
    return ProtocolConfig(**rec, device=device)


def load_state(journal_dir):
    """Parse a journal directory into (sessions, committees) — sessions
    keyed by journaled session id in first-seen order, committees keyed
    by committee id. Torn tails are dropped by the reader; corruption
    raises. Missing/empty directory -> ({}, {})."""
    sessions: Dict[int, JournaledSession] = {}
    committees: Dict[object, dict] = {}
    for rec in read_records(journal_dir):
        t = rec.get("t")
        if t == "committee":
            committees[rec["cid"]] = rec
            continue
        sid = rec.get("sid")
        if sid is None:
            continue
        sess = sessions.get(sid)
        if sess is None:
            sess = sessions[sid] = JournaledSession(sid=sid)
        if t == "admitted":
            sess.cid = rec["cid"]
            sess.epoch = rec.get("epoch")
        elif t == "collecting":
            sess.expected = list(rec["expected"])
            # a new attempt always opens with `collecting`: drop any
            # broadcasts from a previous attempt even if its `reset`
            # record was lost (best-effort append) — mixing one
            # attempt's messages with another's secrets is the one
            # replay shape that could produce a wrong result
            sess.broadcasts = []
        elif t == "broadcast":
            sess.broadcasts.append((rec["sender"], rec["wire"]))
        elif t == "reset":
            # a failed worker attempt requeued: the next attempt re-runs
            # distribute with fresh randomness, so the prior attempt's
            # broadcasts (and its deposited secrets) are stale
            sess.expected = None
            sess.broadcasts = []
        elif t == "terminal":
            sess.terminal = rec
            if sess.cid is None:
                sess.cid = rec.get("cid")
            if sess.epoch is None:
                sess.epoch = rec.get("epoch")
    return sessions, committees


def _flight(name: str, **fields) -> None:
    flight.record("recovery", name, **fields)


def _replayed_counter():
    return registry.counter(
        "fsdkr_journal_replayed",
        "journal records consumed by recovery replay",
    )


def recover(service, journal_dir, keystore: Optional[MemoryKeystore] = None) -> dict:
    """Replay `journal_dir` into `service`. Returns a report dict:

    - ``sessions``: {journaled sid: {"disposition": ..., "sid": new sid
      or None, "cid", "epoch", "state"}} where disposition is one of
      ``replayed_terminal`` / ``resumed`` / ``aborted_transient`` /
      ``skipped_no_committee``.
    - ``replayed_terminal`` / ``resumed`` / ``aborted_transient`` /
      ``skipped`` counts, ``broadcasts_replayed``, and
      ``committees_admitted``.

    Idempotent in effect: terminal verdicts restore as finished history
    (done epochs keep deduping), in-flight sessions either resume into
    the live lifecycle or settle retryably. The caller decides what to
    do about aborted_transient sessions (the supervisor resubmits
    them)."""
    keystore = keystore or getattr(service, "keystore", None)
    torn_counter = registry.counter(
        "fsdkr_journal_torn_tails",
        "truncated segment tails dropped during replay",
    )
    torn0 = torn_counter.value()
    sessions, committees = load_state(journal_dir)
    torn = int(torn_counter.value() - torn0)
    report = {
        "journal_dir": str(journal_dir),
        "torn_tails": torn,
        "sessions": {},
        "replayed_terminal": 0,
        "resumed": 0,
        "aborted_transient": 0,
        "skipped": 0,
        "broadcasts_replayed": 0,
        "committees_admitted": 0,
    }
    if not sessions and not committees:
        _flight("replay_empty", dir=str(journal_dir))
        return report

    # journaled sids must never collide with sids this incarnation will
    # allocate (same-directory restart: new records append to the same
    # log the NEXT recovery reads)
    service.reserve_session_ids(max(sessions) if sessions else 0)
    # same-directory restart: the terminal records already live in the
    # log this service appends to — re-journaling them would double the
    # terminal set on every restart. A peer adopting a FOREIGN journal
    # re-journals, keeping its own log self-contained.
    same_dir = (
        service.journal is not None
        and pathlib.Path(journal_dir).resolve()
        == pathlib.Path(service.journal.dir).resolve()
    )

    for cid, rec in committees.items():
        if service.has_committee(cid):
            continue
        keys = keystore.committee_keys(cid) if keystore else None
        if keys is None:
            continue
        service.admit(cid, keys, config_from_record(rec["config"], service.device))
        report["committees_admitted"] += 1
        _flight("committee_readmitted", cid=str(cid))

    replayed = _replayed_counter()
    for sid, js in sessions.items():
        entry = {"cid": js.cid, "epoch": js.epoch, "sid": None}
        report["sessions"][sid] = entry
        if js.terminal is not None:
            new_sid = service.restore_terminal(
                js.cid,
                js.epoch,
                js.terminal["state"],
                bool(js.terminal.get("blame")),
                js.terminal.get("error"),
                rejournal=not same_dir,
            )
            entry.update(
                disposition="replayed_terminal",
                sid=new_sid,
                state=js.terminal["state"],
            )
            report["replayed_terminal"] += 1
            replayed.inc()
            _flight(
                "terminal_replayed",
                sid=sid,
                state=js.terminal["state"],
                blame=bool(js.terminal.get("blame")),
            )
            continue
        if js.cid is None or not service.has_committee(js.cid):
            entry["disposition"] = "skipped_no_committee"
            report["skipped"] += 1
            _flight("skipped_no_committee", sid=sid)
            continue
        dks = (
            keystore.session_dks(js.cid, sid)
            if keystore is not None
            else None
        )
        resumable = (
            js.expected is not None
            and dks is not None
            and len(dks) == service.committee_size(js.cid)
        )
        if not resumable:
            new_sid = service.finish_unrecoverable(
                js.cid,
                js.epoch,
                RecoverySecretsUnavailable(
                    f"session {sid} (committee {js.cid!r}, epoch "
                    f"{js.epoch!r}): secret state not re-derivable from "
                    f"the keystore; aborted transient (retryable)"
                ),
                origin_sid=sid,
            )
            entry.update(
                disposition="aborted_transient", sid=new_sid, state="aborted"
            )
            report["aborted_transient"] += 1
            _flight("aborted_transient", sid=sid)
            continue
        try:
            new_sid = service.resume_session(
                js.cid, js.epoch, dks, js.expected, js.broadcasts,
                origin_sid=sid,
            )
        except Exception as e:
            # one unresumable session (busy committee in a malformed
            # journal, journal IO) must not abort the whole replay —
            # settle it retryably like any other secrets-gone session
            new_sid = service.finish_unrecoverable(
                js.cid,
                js.epoch,
                RecoverySecretsUnavailable(
                    f"session {sid}: resume failed "
                    f"({type(e).__name__}: {e}); aborted transient"
                ),
                origin_sid=sid,
            )
            entry.update(
                disposition="aborted_transient", sid=new_sid, state="aborted"
            )
            report["aborted_transient"] += 1
            _flight("resume_failed", sid=sid)
            continue
        entry.update(disposition="resumed", sid=new_sid)
        report["resumed"] += 1
        report["broadcasts_replayed"] += len(js.broadcasts)
        replayed.inc(1 + len(js.broadcasts))
        _flight(
            "session_resumed",
            sid=sid,
            new_sid=new_sid,
            broadcasts=len(js.broadcasts),
        )
    _flight(
        "replay_done",
        dir=str(journal_dir),
        terminal=report["replayed_terminal"],
        resumed=report["resumed"],
        transient=report["aborted_transient"],
    )
    return report
