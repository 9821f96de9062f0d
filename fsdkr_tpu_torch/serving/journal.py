"""Durable public-broadcast journal: an append-only write-ahead log that
makes serving sessions survive process death (an own copy of
fsdkr_tpu/serving/journal.py; its segments are the JAX package's byte
for byte, so either package replays the other's).

fs-dkr is proactive security — a refresh that fails to complete leaves
the fleet holding stale, compromisable shares — so the refresh service
itself must be crash-durable. The journal records the PUBLIC facts of
every session as they happen, in exactly the wire encoding broadcasts
already use (`protocol.serialization`), so a fresh process (or a peer
shard adopting a dead shard's committees) can replay the log through
the ordinary `StreamingCollect.offer()`/finalize path and land on
bit-identical verdicts (`serving.recovery`).

## What is journaled — and what never is

Record types (one JSON object per record; `t` is the discriminator):

- ``committee`` — a committee admission: id, sizes, and the PUBLIC
  config parameters (bits, m_security, rounds, backend, hash, curve).
- ``admitted``  — a session entered the service: session id, committee
  id, optional idempotency epoch.
- ``collecting`` — the session's expected-sender set at the moment its
  streaming collectors were created.
- ``broadcast`` — one ACCEPTED broadcast message, serialized with
  `refresh_message_to_json` (broadcast-public by definition), in
  acceptance order. First-arrival-wins is preserved: the accepted copy
  is what was journaled, so a tampered-then-corrected arrival replays
  to the same blame verdict.
- ``terminal``  — the session's terminal state (done / aborted /
  timed_out), the blame flag, and the error string. Recovery replays a
  terminal verdict verbatim, never recomputes it.

Secrets — LocalKeys, new decryption keys, pool entries, CRT contexts —
are NEVER journaled. Recovery
re-derives secret state from the committee keystore
(`recovery.MemoryKeystore`); a session whose secrets cannot be
re-derived terminates ``aborted_transient`` (retryable), never with a
fabricated verdict.

## Framing, rotation, durability

Segments are ``wal-NNNNNN.seg`` files: an 12-byte header (magic +
version) followed by CRC-framed records — ``<u32 payload-len>
<u32 crc32(payload)> <payload>``. A new Journal NEVER appends to an
existing segment (a predecessor's tail may be torn; a fresh segment
keeps that tail exactly where replay expects it). Segments rotate at
`segment_bytes` (default 8 MiB, the JAX package's
FSDKR_JOURNAL_SEGMENT_MB).

Torn-tail tolerance: a record truncated at the END of a segment — the
signature of a crash mid-write — is dropped and counted
(``fsdkr_journal_torn_tails``). Anything else that fails the frame
(bad magic, CRC mismatch, undecodable payload) is REAL corruption and
raises `JournalCorruption` naming the segment and byte offset: silent
repair of non-tail damage could drop accepted broadcasts, which is the
one thing the journal exists to prevent.

fsync policy — `sync` (the JAX package's FSDKR_JOURNAL_SYNC):

- ``always`` — fsync after every record (safest; slowest).
- ``batch``  — default: fsync every `batch_records` records (32, the
  JAX package's FSDKR_JOURNAL_BATCH) and at rotation/close. A crash can
  lose at most one batch of un-synced tail records — all dropped as a
  torn/clean tail, never corrupted reads.
- ``off``    — buffered writes only (OS page cache; for benchmarks).

Chaos: the ``journal_torn_write`` fault site (`serving.faults`)
truncates the active segment mid-record — the frame header and a
payload prefix land on disk, then the segment rotates — simulating a
crash mid-write so the torn-tail replay path is exercised end to end.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
import threading
import zlib
from typing import Iterator, List, Tuple

from ..telemetry import registry

__all__ = [
    "Journal",
    "JournalCorruption",
    "read_records",
    "SEGMENT_MAGIC",
    "SEGMENT_VERSION",
]

SEGMENT_MAGIC = b"FSDKRWAL"
SEGMENT_VERSION = 1
_HEADER = SEGMENT_MAGIC + struct.pack("<I", SEGMENT_VERSION)
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)


class JournalCorruption(RuntimeError):
    """Non-tail journal damage: the segment and byte offset are named
    so the operator can quarantine the exact file — recovery must not
    guess past a record it cannot trust."""

    def __init__(self, segment: str, offset: int, detail: str):
        self.segment = segment
        self.offset = offset
        super().__init__(
            f"journal corruption in {segment} at offset {offset}: {detail}"
        )


def _counters():
    return {
        "records": registry.counter(
            "fsdkr_journal_records", "journal records appended"
        ),
        "bytes": registry.counter(
            "fsdkr_journal_bytes", "journal bytes appended (frames included)"
        ),
        "segments": registry.counter(
            "fsdkr_journal_segments", "journal segments opened"
        ),
        "fsyncs": registry.counter(
            "fsdkr_journal_fsyncs", "journal fsync calls"
        ),
        "replayed": registry.counter(
            "fsdkr_journal_replayed",
            "journal records consumed by recovery replay",
        ),
        "torn_tails": registry.counter(
            "fsdkr_journal_torn_tails",
            "truncated segment tails dropped during replay",
        ),
    }


SYNC_POLICIES = ("always", "batch", "off")


class Journal:
    """One shard's append-only journal directory. Thread-safe: the
    serving workers, launcher, and reaper all append through one lock
    (records are small; the fsync policy, not the lock, is the cost)."""

    def __init__(
        self,
        directory,
        sync: str = "batch",
        segment_bytes: int = 8 << 20,
        batch_records: int = 32,
    ):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        if sync not in SYNC_POLICIES:
            raise ValueError(f"bad sync policy {sync!r}: expected always|batch|off")
        self.sync_policy = sync
        self.segment_bytes = segment_bytes
        self.batch_records = max(1, batch_records)
        self._lock = threading.Lock()
        self._fh = None
        self._seg_index = self._next_segment_index()
        self._seg_written = 0
        self._unsynced = 0
        self._closed = False
        # per-instance accounting (the registry counters aggregate
        # across every journal in the process; stats() is THIS journal)
        self.records = 0
        self.bytes = 0
        self.segments = 0
        self.fsyncs = 0
        self._c = _counters()

    # -- segment management ---------------------------------------------
    def _next_segment_index(self) -> int:
        existing = self.segment_paths(self.dir)
        if not existing:
            return 1
        return int(existing[-1].stem.split("-")[1]) + 1

    @staticmethod
    def segment_paths(directory) -> List[pathlib.Path]:
        d = pathlib.Path(directory)
        if not d.is_dir():
            return []
        return sorted(d.glob("wal-*.seg"))

    def _open_segment(self) -> None:
        path = self.dir / f"wal-{self._seg_index:06d}.seg"
        self._seg_index += 1
        self._fh = open(path, "ab")
        self._fh.write(_HEADER)
        self._seg_written = len(_HEADER)
        self.segments += 1
        self._c["segments"].inc()

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            self._sync_locked(force=self.sync_policy != "off")
            self._fh.close()
            self._fh = None

    def _sync_locked(self, force: bool = False) -> None:
        if self._fh is None:
            return
        self._fh.flush()
        if force or self.sync_policy == "always" or (
            self.sync_policy == "batch"
            and self._unsynced >= self.batch_records
        ):
            os.fsync(self._fh.fileno())
            self._unsynced = 0
            self.fsyncs += 1
            self._c["fsyncs"].inc()

    # -- appending ------------------------------------------------------
    def append(self, rec: dict) -> None:
        """Append one record (a JSON-serializable dict of PUBLIC data).
        Raises on IO errors — a journal that silently drops records is
        worse than none (the serving retry path treats the raise as a
        transient failure)."""
        payload = json.dumps(
            rec, sort_keys=True, separators=(",", ":")
        ).encode()
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._closed:
                raise RuntimeError("journal is closed")
            if self._fh is None or self._seg_written >= self.segment_bytes:
                self._rotate_locked()
                self._open_segment()
            torn = self._torn_write_injected()
            if torn:
                # crash-mid-write simulation: a frame prefix lands on
                # disk, the record is LOST (that is the point — replay
                # must drop it as a torn tail), and writes continue in
                # a fresh segment
                cut = max(1, len(frame) - max(4, len(payload) // 2))
                self._fh.write(frame[:cut])
                self._sync_locked(force=self.sync_policy != "off")
                self._rotate_locked()
                self._open_segment()
                return
            self._fh.write(frame)
            self._seg_written += len(frame)
            self._unsynced += 1
            self.records += 1
            self.bytes += len(frame)
            self._c["records"].inc()
            self._c["bytes"].inc(len(frame))
            # the fsync policy, not the lock, is the cost: callers must
            # never hold the service's lock here
            self._sync_locked()

    @staticmethod
    def _torn_write_injected() -> bool:
        from . import faults

        plan = faults.active()
        return plan is not None and plan.fire_seq("journal_torn_write")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._rotate_locked()
            self._closed = True

    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": str(self.dir),
                "sync": self.sync_policy,
                "records": self.records,
                "bytes": self.bytes,
                "segments": self.segments,
                "fsyncs": self.fsyncs,
                "segment_bytes": self.segment_bytes,
            }


# ---------------------------------------------------------------------------
# replay


def _iter_segment(
    path: pathlib.Path, is_last_segment: bool
) -> Iterator[Tuple[dict, int]]:
    """Yield (record, offset) from one segment. A truncated record at
    the segment's END is a torn tail: dropped and counted (crashes and
    injected torn writes both leave exactly this shape, in any segment
    — rotation only ever follows a write, so a mid-directory segment
    can carry a torn tail too). Everything else raises
    JournalCorruption. `is_last_segment` is accepted for symmetry with
    callers that want stricter policies; the tail rule applies to every
    segment."""
    data = path.read_bytes()
    name = path.name
    if len(data) < len(_HEADER):
        if data and not _HEADER.startswith(data):
            raise JournalCorruption(name, 0, "bad segment magic")
        # empty/truncated header: a crash immediately after rotation
        _counters()["torn_tails"].inc()
        return
    if data[: len(_HEADER)] != _HEADER:
        raise JournalCorruption(name, 0, "bad segment magic or version")
    off = len(_HEADER)
    while off < len(data):
        if off + _FRAME.size > len(data):
            _counters()["torn_tails"].inc()
            return  # torn frame header at EOF
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + length
        if end > len(data):
            _counters()["torn_tails"].inc()
            return  # torn payload at EOF
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            raise JournalCorruption(name, off, "record CRC mismatch")
        try:
            rec = json.loads(payload)
        except ValueError:
            raise JournalCorruption(
                name, off, "record payload is not valid JSON"
            ) from None
        yield rec, off
        off = end


def read_records(directory) -> List[dict]:
    """Every surviving record across the directory's segments, in
    append order. A missing or empty directory is a clean no-op (a
    shard's very first boot has nothing to recover). Raises
    JournalCorruption on non-tail damage."""
    segs = Journal.segment_paths(directory)
    out: List[dict] = []
    for i, seg in enumerate(segs):
        for rec, _off in _iter_segment(seg, i == len(segs) - 1):
            out.append(rec)
    return out
