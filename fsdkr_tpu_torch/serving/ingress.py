"""Network ingress: an asyncio TCP server that feeds a RefreshService
over real sockets (an own copy of fsdkr_tpu/serving/ingress.py) — the
point where fs-dkr's broadcast-channel assumption (one message per
party on a broadcast channel) meets a lossy, adversarial network
instead of an in-process loop.

## Wire protocol

Length-prefixed CRC-framed JSON, the journal's frame shape on a socket:

    <u32 payload-len, little-endian> <u32 crc32(payload)> <payload JSON>

Every request carries a client-chosen ``rid`` echoed in the response,
so a duplicated response (the ``net_dup`` fault, or a retransmitting
middlebox) is detectable and droppable. Request ops:

- ``submit``    ``{op, rid, cid, epoch}`` — admit one refresh session
  (idempotent per (committee, epoch), exactly like the in-process API).
  The response carries the session id and the session's broadcast set
  (the distribute outputs, wire-encoded): the CLIENT is the broadcast
  channel — it re-delivers each message as a ``broadcast`` frame, so
  every broadcast transits the network and a dropped frame is a real
  quorum gap. Sets over half of ``max_frame`` are returned as a sender
  list instead; the client pulls each message with ``fetch``.
- ``fetch``     ``{op, rid, sid, senders}`` — a subset of an external
  session's broadcast set (for sets too big to inline in ``submitted``).
- ``broadcast`` ``{op, rid, sid, wire}`` — deliver one broadcast into
  the session's collectors (`RefreshService.offer_external`: journaled
  iff accepted, first arrival wins, order-independent). The offers run
  on the handler thread that took the frame, so their kernel launches
  count with the session's (`ops.tally`), not apart.
- ``wait``      ``{op, rid, sid, timeout}`` — block for the terminal
  verdict. A service-side timeout comes back as a TYPED error frame
  (``{"type": "error", "error": "timeout", ...}``) — never a closed
  connection (a closed connection means the NETWORK failed; a timeout
  is an answer).
- ``ping`` / ``stats`` — liveness and the ingress counter snapshot.

Responses: ``submitted`` / ``fetched`` / ``pending`` (the session is
alive but its distribute has not finished — retry the fetch; NOT the
same as ``unknown_session``, which means resubmit) / ``broadcast_ack``
/ ``terminal`` / ``rejected`` (admission shed — overload policy,
bisect guard, or the per-peer rate limiter; carries ``retry_after_s``)
/ ``redirect`` (this shard does not own the committee; carries the
peer port map so the client re-dials) / ``pong`` / ``stats`` /
``error``.

## Robustness

Every limit is a constructor argument at the JAX package's default
(there an FSDKR_INGRESS_* variable); the port reads no environment.

- **Backpressure, not queue growth**: every accepted frame charges a
  per-connection and a server-global inflight byte budget
  (``conn_inflight_budget``, 4 MiB / ``inflight_budget``, 32 MiB),
  released when its response has been written. Over budget, the server
  calls ``transport.pause_reading()`` — the kernel's TCP window closes
  and the SENDER stalls; nothing accumulates server-side
  (``fsdkr_ingress_paused_reads{scope}``).
- **Frame hygiene**: a length prefix over ``max_frame`` (8 MiB;
  oversize), a CRC mismatch, an undecodable payload, or an unknown op
  closes THAT connection (``fsdkr_ingress_frames_rejected{cause}``) and
  touches no other — one hostile peer cannot poison a sibling's stream.
- **Slow-loris**: connections idle past ``idle_s`` (60 s) or whose peer
  stops reading our responses for ``write_s`` (10 s; write-buffer
  high-water sustained) are closed by the hygiene sweep.
- **Per-peer rate limiting** (`policy.PeerRateLimiter`, off by
  default): charged like the BisectGuard — an over-rate peer is shed
  with a retry-after hint, and a peer that keeps hammering pays with
  its own connection.
- **Admission control**: `ServeRejected` from the service (overload /
  bisection budget) becomes an explicit ``rejected`` response carrying
  the retry-after hint — load shedding is an answer, not a dropped
  connection.
- **Graceful drain**: ``stop()`` stops accepting, lets in-flight
  requests finish (bounded), then closes what remains.

Chaos: the ``conn_drop`` / ``frame_truncate`` / ``net_delay`` /
``net_dup`` fault sites (`serving.faults`) act here, on connections and
frames only — a network-chaos storm can only ever look like a bad
network, never like a misbehaving verifier.

Secrecy: ONLY broadcast-public data transits the socket (wire-encoded
RefreshMessages, session metadata, verdicts). LocalKeys never do — they
reach a shard over the supervisor's private stdin pipe. The CRC is
framing hygiene, not authentication: an on-path adversary who tampers a
broadcast is exactly the adversary the proofs themselves blame (tamper
-> identifiable abort), which is why the wire needs no MAC to keep
verdicts sound.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import struct
import threading
import time
import zlib
from typing import Callable, Optional

from . import faults, metrics
from .policy import PeerRateLimiter
from .service import RefreshService, ServeRejected, TERMINAL

__all__ = [
    "FRAME_HEADER",
    "FrameError",
    "encode_frame",
    "IngressServer",
    "IngressClient",
]

FRAME_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
MAX_FRAME = 8 << 20  # the JAX package's FSDKR_INGRESS_MAX_FRAME_MB default


class FrameError(RuntimeError):
    """A frame that must close its connection. `cause` is the tiny-enum
    rejection label (oversize/crc/malformed/bad_op)."""

    def __init__(self, cause: str, detail: str):
        self.cause = cause
        super().__init__(f"{cause}: {detail}")


def encode_frame(obj: dict) -> bytes:
    payload = json.dumps(obj, default=str).encode()
    return FRAME_HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def _parse_frames(buf: bytearray, max_frame: int):
    """Yield decoded payload dicts from `buf`, consuming complete
    frames in place. Raises FrameError on oversize/CRC/JSON damage
    (leaving the buffer untouched — the caller closes the connection
    anyway)."""
    out = []
    off = 0
    while len(buf) - off >= FRAME_HEADER.size:
        length, crc = FRAME_HEADER.unpack_from(buf, off)
        if length > max_frame:
            raise FrameError(
                "oversize", f"length prefix {length} > cap {max_frame}"
            )
        if len(buf) - off - FRAME_HEADER.size < length:
            break  # incomplete tail: wait for more bytes
        start = off + FRAME_HEADER.size
        payload = bytes(buf[start : start + length])
        if zlib.crc32(payload) != crc:
            raise FrameError("crc", "frame CRC mismatch")
        try:
            obj = json.loads(payload)
        except ValueError:
            raise FrameError("malformed", "frame payload is not JSON") from None
        if not isinstance(obj, dict):
            raise FrameError("malformed", "frame payload is not an object")
        out.append((obj, FRAME_HEADER.size + length))
        off = start + length
    del buf[:off]
    return out


# ---------------------------------------------------------------------------
# server


class _Conn(asyncio.Protocol):
    """One client connection. All state here is touched only on the
    event-loop thread (protocol callbacks + response coroutines);
    blocking service calls run in the server's executor."""

    def __init__(self, server: "IngressServer"):
        self.server = server
        self.transport = None
        self.peer = "?"
        self.buf = bytearray()
        self.inflight = 0  # bytes of frames accepted, responses pending
        self.paused = False
        self.closed = False
        self.outcome = "closed"
        self.last_activity = time.monotonic()
        self.write_paused_at: Optional[float] = None
        # set while an INCOMPLETE frame sits in the buffer: a slow
        # loris dripping one byte at a time resets last_activity, but
        # not this — the sweep bounds how long one frame may take
        self.partial_since: Optional[float] = None
        self.conn_id = 0
        self.frame_seq = 0

    # -- lifecycle ------------------------------------------------------
    def connection_made(self, transport) -> None:
        self.transport = transport
        peername = transport.get_extra_info("peername") or ("?",)
        self.peer = str(peername[0])
        srv = self.server
        srv.conn_counter += 1
        self.conn_id = srv.conn_counter
        srv.conns.add(self)
        metrics.ingress_open_gauge().set(len(srv.conns))

    def connection_lost(self, exc) -> None:
        self.closed = True
        srv = self.server
        srv.conns.discard(self)
        metrics.ingress_open_gauge().set(len(srv.conns))
        metrics.ingress_connections().inc(outcome=self.outcome)
        srv._release(self, self.inflight)  # zeroes conn.inflight too
        if not any(c.peer == self.peer for c in srv.conns):
            # forget() only drops a refilled, debt-free bucket — a peer
            # closed for hammering keeps its rate state, so a tight
            # connect/hammer/reconnect loop buys no fresh burst
            srv.limiter.forget(self.peer)

    def pause_writing(self) -> None:
        self.write_paused_at = time.monotonic()

    def resume_writing(self) -> None:
        self.write_paused_at = None

    def close(self, outcome: str, cause: Optional[str] = None) -> None:
        if self.closed:
            return
        self.closed = True
        self.outcome = outcome
        if cause is not None:
            metrics.ingress_rejected().inc(cause=cause)
        if self.transport is not None and not self.transport.is_closing():
            # abort, not close: a connection being punished must not get
            # a graceful FIN that flushes whatever we still owed it
            self.transport.abort()

    def _write_frame(self, obj: dict) -> None:
        """Immediate control-path response (shed/drain answers): no
        fault injection, no executor round-trip."""
        if self.closed or self.transport.is_closing():
            return
        frame = encode_frame(obj)
        self.transport.write(frame)
        metrics.ingress_frames().inc(direction="out")
        metrics.ingress_bytes().inc(len(frame), direction="out")

    # -- inbound --------------------------------------------------------
    def data_received(self, data: bytes) -> None:
        if self.closed:
            return
        self.last_activity = time.monotonic()
        self.buf += data
        try:
            frames = _parse_frames(self.buf, self.server.max_frame)
        except FrameError as e:
            self.close("error", cause=e.cause)
            return
        if not self.buf:
            self.partial_since = None
        elif self.partial_since is None:
            self.partial_since = time.monotonic()
        for obj, nbytes in frames:
            if self.closed:
                return
            self._frame_in(obj, nbytes)

    def _frame_in(self, obj: dict, nbytes: int) -> None:
        srv = self.server
        self.frame_seq += 1
        metrics.ingress_frames().inc(direction="in")
        metrics.ingress_bytes().inc(nbytes, direction="in")
        rid = obj.get("rid")
        if srv.draining:
            # drain refuses NEW work with an answer, then the sweep
            # closes once in-flight responses are out
            metrics.ingress_rejected().inc(cause="draining")
            self._write_frame({"type": "error", "error": "draining",
                               "rid": rid})
            return
        plan = faults.active()
        if plan is not None and plan.fire(
            "conn_drop", (self.conn_id, self.frame_seq)
        ):
            self.close("faulted")
            return
        verdict = srv.limiter.charge(self.peer)
        if verdict is not None:
            metrics.ingress_peer_shed().inc()
            if verdict < 0:
                # hammering past a whole burst of sheds: the peer pays
                # with its own connection (BisectGuard-style charging)
                self.close("shed", cause="peer_rate")
                return
            self._write_frame({
                "type": "rejected", "reason": "peer_rate",
                "retry_after_s": round(verdict, 3), "rid": rid,
            })
            return
        op = obj.get("op")
        if op not in ("submit", "fetch", "broadcast", "wait", "ping",
                      "stats"):
            self.close("error", cause="bad_op")
            return
        srv._charge(self, nbytes)
        # the frame's OWN sequence rides along: fault decisions for its
        # response must key on it, not on whatever the counter says by
        # the time the response is written (overlapping responses would
        # share/skip keys and break seeded-storm reproducibility)
        asyncio.ensure_future(
            self._serve(obj, op, rid, nbytes, self.frame_seq)
        )

    # -- request handling ----------------------------------------------
    async def _serve(
        self, obj: dict, op: str, rid, nbytes: int, seq: int
    ) -> None:
        srv = self.server
        try:
            if op == "ping":
                resp = {"type": "pong"}
            elif op == "stats":
                resp = {"type": "stats", "ingress": metrics.ingress_snapshot(),
                        "serving": srv.service.stats()}
            elif op == "wait":
                resp = await self._await_terminal(obj)
            elif op == "submit":
                resp = await self._submit(obj)
            else:
                resp = await srv.loop.run_in_executor(
                    srv.pool, srv._handle_blocking, op, obj
                )
        except FrameError as e:
            if not self.closed:
                srv._release(self, nbytes)
            self.close("error", cause=e.cause)
            return
        except Exception as e:
            # a handler bug answers THIS request and touches nothing
            # else — the connection (and every other one) lives on
            resp = {"type": "error",
                    "error": f"{type(e).__name__}: {e}"}
        resp.setdefault("rid", rid)
        try:
            await self._respond(resp, seq)
        finally:
            # connection_lost releases a dead connection's WHOLE
            # remaining charge; only a live connection releases here
            # (both run on the loop thread, so the check cannot race)
            if not self.closed:
                srv._release(self, nbytes)

    async def _poll(
        self, probe, sid: int, deadline: float, timeout_resp: dict
    ) -> dict:
        """Slice-poll a non-blocking service probe on the executor:
        `probe(sid)` raising TimeoutError means "still running" (sleep
        100 ms, retry until `deadline` or the connection dies — the
        timeout is a TYPED answer, never a closed connection) and
        KeyError means the session is unknown. Polling instead of
        parking keeps the bounded pool free: neither a burst of cheap
        long-timeout `wait` frames nor a submit burst against a
        backlogged service may starve the broadcast/fetch ops other
        sessions need to reach quorum before their deadline."""
        srv = self.server
        while True:
            try:
                return await srv.loop.run_in_executor(srv.pool, probe, sid)
            except TimeoutError:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self.closed:
                    return timeout_resp
                await asyncio.sleep(min(0.1, remaining))
            except KeyError:
                return {"type": "error", "error": "unknown_session",
                        "sid": sid}

    async def _await_terminal(self, obj: dict) -> dict:
        sid = int(obj.get("sid", -1))
        timeout = min(600.0, float(obj.get("timeout", 30.0)))
        return await self._poll(
            self.server._wait_result, sid,
            deadline=time.monotonic() + timeout,
            timeout_resp={"type": "error", "error": "timeout",
                          "sid": sid, "timeout_s": timeout},
        )

    async def _submit(self, obj: dict) -> dict:
        """Admission runs one fast executor hop; the distribute wait
        then slice-polls via `_poll`."""
        srv = self.server
        pre = await srv.loop.run_in_executor(srv.pool, srv._submit_admit, obj)
        if isinstance(pre, dict):
            return pre
        sid = pre
        bound = srv.service.deadline_s + 10.0
        return await self._poll(
            srv._submit_result, sid,
            deadline=time.monotonic() + bound,
            timeout_resp={"type": "error", "error": "timeout",
                          "sid": sid, "timeout_s": round(bound, 3)},
        )

    async def _respond(self, resp: dict, seq: int) -> None:
        if self.closed:
            return
        plan = faults.active()
        key = (self.conn_id, seq)
        if plan is not None and plan.fire("net_delay", key):
            await asyncio.sleep(plan.delay_s)
        if self.closed:
            return
        frame = encode_frame(resp)
        if plan is not None and plan.fire("frame_truncate", key):
            # the torn shape a dying peer leaves: a prefix, then RST
            self.transport.write(frame[: max(1, len(frame) // 3)])
            metrics.ingress_frames().inc(direction="out")
            metrics.ingress_bytes().inc(len(frame) // 3, direction="out")
            self.close("faulted")
            return
        dup = plan is not None and plan.fire("net_dup", key)
        for _ in range(2 if dup else 1):
            self.transport.write(frame)
            metrics.ingress_frames().inc(direction="out")
            metrics.ingress_bytes().inc(len(frame), direction="out")
        self.last_activity = time.monotonic()


class IngressServer:
    """One shard's TCP ingress over a running `RefreshService`.

    Owns a dedicated event-loop thread, so it composes with the
    service's thread-based scheduler and with the shard child process
    (`serving.supervisor`). Short blocking service calls run on a
    bounded executor; the two long waits (`submit`'s distribute,
    `wait`'s verdict) poll in slices from coroutines so they can never
    park a pool thread for their full duration — the loop thread only
    frames, routes, and enforces hygiene.

    `router(cid)` — optional: return a redirect payload (dict) when
    this shard does not own `cid`, or None to serve locally. The
    supervisor wires it to the fleet's shard->port map.
    """

    def __init__(
        self,
        service: RefreshService,
        host: str = "127.0.0.1",
        port: int = 0,
        router: Optional[Callable[[object], Optional[dict]]] = None,
        max_frame: int = MAX_FRAME,
        inflight_budget: int = 32 << 20,
        conn_inflight_budget: int = 4 << 20,
        idle_s: float = 60.0,
        write_s: float = 10.0,
        limiter: Optional[PeerRateLimiter] = None,
        handlers: int = 16,
    ):
        """The limits at the JAX package's defaults (its variables):
        `max_frame` bytes (FSDKR_INGRESS_MAX_FRAME_MB, 8 MiB),
        `inflight_budget` (FSDKR_INGRESS_INFLIGHT_MB, 32 MiB),
        `conn_inflight_budget` (FSDKR_INGRESS_CONN_INFLIGHT_MB, 4 MiB),
        `idle_s` (FSDKR_INGRESS_IDLE_S, 60; 0 = off), `write_s`
        (FSDKR_INGRESS_WRITE_S, 10; 0 = off), `limiter` (a
        PeerRateLimiter; FSDKR_INGRESS_PEER_RPS, default off) and
        `handlers` (FSDKR_INGRESS_HANDLERS, 16, at least 4): the
        executor threads that run the blocking service calls."""
        self.service = service
        self.host = host
        self.port = port  # 0 = kernel-assigned; real port after start()
        self.router = router
        self.max_frame = max(1, int(max_frame))
        self.inflight_budget = max(1, int(inflight_budget))
        self.conn_inflight_budget = max(1, int(conn_inflight_budget))
        self.idle_s = idle_s
        self.write_s = write_s
        self.limiter = limiter or PeerRateLimiter()
        handlers = max(4, int(handlers))
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=handlers, thread_name_prefix="fsdkr-ingress"
        )
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.conns: set = set()
        self.conn_counter = 0
        self.inflight = 0  # server-global accepted-frame bytes
        self.draining = False
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._sweep_task = None
        self._ready = threading.Event()
        self._start_err: Optional[BaseException] = None

    # -- backpressure (loop thread only) --------------------------------
    def _charge(self, conn: _Conn, nbytes: int) -> None:
        conn.inflight += nbytes
        self.inflight += nbytes
        if not conn.paused and conn.inflight > self.conn_inflight_budget:
            conn.paused = True
            conn.transport.pause_reading()
            metrics.ingress_paused().inc(scope="conn")
        if self.inflight > self.inflight_budget:
            # global budget: REAL backpressure on every sender — the
            # alternative is unbounded queue growth, which is how an
            # overloaded server dies instead of slowing down
            for c in self.conns:
                if not c.paused and not c.closed:
                    c.paused = True
                    c.transport.pause_reading()
                    metrics.ingress_paused().inc(scope="server")

    def _release(self, conn: _Conn, nbytes: int) -> None:
        # the connection's own charge comes off FIRST: the resume
        # checks below must see the post-release value, or the final
        # release of a paused connection (e.g. one frame bigger than
        # half the conn budget) reads its own stale charge, never
        # resumes reading, and the connection is wedged forever — the
        # hygiene sweep deliberately spares paused conns
        conn.inflight = max(0, conn.inflight - nbytes)
        self.inflight = max(0, self.inflight - nbytes)
        if self.inflight <= self.inflight_budget // 2:
            for c in list(self.conns):
                if (
                    c.paused
                    and not c.closed
                    and c.inflight <= self.conn_inflight_budget // 2
                ):
                    c.paused = False
                    c.transport.resume_reading()
        elif (
            conn.paused
            and not conn.closed
            and conn.inflight <= self.conn_inflight_budget // 2
            and self.inflight <= self.inflight_budget
        ):
            conn.paused = False
            conn.transport.resume_reading()

    # -- blocking op handlers (executor threads) ------------------------
    def _submit_admit(self, obj: dict):
        """submit, phase 1 (executor, fast): route + admit + enqueue.
        Returns a final response dict (redirect/rejected/error) or the
        new session id for the async distribute poll."""
        svc = self.service
        cid = obj.get("cid")
        if cid is None:
            raise FrameError("bad_op", "submit without cid")
        if not svc.has_committee(cid):
            if self.router is not None:
                red = self.router(cid)
                if red is not None:
                    return dict(red, type="redirect")
            return {"type": "error", "error": "unknown_committee",
                    "cid": cid}
        try:
            return svc.submit(cid, epoch=obj.get("epoch"), external=True)
        except ServeRejected as e:
            return {
                "type": "rejected", "reason": e.reason,
                "retry_after_s": round(e.retry_after_s, 3),
            }

    def _submit_result(self, sid: int) -> dict:
        """submit, phase 2 (executor, one poll slice): non-blocking
        look at the distribute outputs; raises TimeoutError while they
        are still pending (the coroutine sleeps and retries)."""
        svc = self.service
        state, wires = svc.wait_broadcasts(sid, timeout=0)
        resp = {"type": "submitted", "sid": sid, "state": state}
        if state in TERMINAL:
            sess = svc.wait(sid, 0)
            resp.update(blame=sess.blame, error=sess.error)
        else:
            senders = [snd for snd, _w in wires]
            resp["senders"] = senders
            total = sum(len(w) for _s, w in wires)
            if total <= self.max_frame // 2:
                resp["broadcasts"] = wires
            # else: the client pulls per-sender `fetch` frames — a
            # full-width committee's broadcast set must not demand a
            # giant frame the cap exists to forbid
        return resp

    def _wait_result(self, sid: int) -> dict:
        """wait, one poll slice (executor): non-blocking look at the
        terminal verdict; raises TimeoutError while the session runs."""
        sess = self.service.wait(sid, 0)
        return {
            "type": "terminal", "sid": sid, "state": sess.state,
            "blame": sess.blame, "error": sess.error,
            "retries": sess.retries,
            "latency_s": round(
                max(0.0, sess.finalized_at - sess.submitted_at), 4
            ),
        }

    def _handle_blocking(self, op: str, obj: dict) -> dict:
        svc = self.service
        if op == "fetch":
            sid = int(obj.get("sid", -1))
            want = obj.get("senders")
            try:
                state, wires = svc.wait_broadcasts(sid, timeout=0)
            except KeyError:
                return {"type": "error", "error": "unknown_session",
                        "sid": sid}
            except TimeoutError:
                # the session EXISTS — distribute just hasn't finished.
                # Answering 'unknown' here would tell the client its
                # session died with a shard and push it into a
                # pointless resubmit; 'pending' says retry the fetch.
                return {"type": "pending", "sid": sid}
            if want is not None:
                want = {int(s) for s in want}
                wires = [(s, w) for s, w in wires if s in want]
            return {"type": "fetched", "sid": sid, "state": state,
                    "broadcasts": wires}
        if op == "broadcast":
            sid = int(obj.get("sid", -1))
            wire = obj.get("wire")
            if not isinstance(wire, str):
                raise FrameError("malformed", "broadcast without wire")
            try:
                result = svc.offer_external(sid, wire)
            except Exception:
                # a valid frame carrying an undecodable broadcast is a
                # hostile or broken peer: same policy as a bad frame —
                # close ITS connection, count it, touch nobody else
                raise FrameError(
                    "malformed", "broadcast wire payload undecodable"
                ) from None
            return {"type": "broadcast_ack", "sid": sid, "result": result}
        raise FrameError("bad_op", f"unroutable op {op!r}")

    # -- lifecycle ------------------------------------------------------
    def start(self, timeout: float = 10.0) -> "IngressServer":
        self._thread = threading.Thread(
            target=self._run_loop, name="fsdkr-ingress-loop", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("ingress server failed to start (timeout)")
        if self._start_err is not None:
            raise RuntimeError(
                f"ingress server failed to start: {self._start_err}"
            )
        return self

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self.loop = loop
        try:
            self._server = loop.run_until_complete(
                loop.create_server(lambda: _Conn(self), self.host, self.port)
            )
            self.port = self._server.sockets[0].getsockname()[1]
            self._sweep_task = loop.create_task(self._hygiene_sweep())
        except BaseException as e:
            self._start_err = e
            self._ready.set()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            loop.close()

    async def _hygiene_sweep(self) -> None:
        """Idle and slow-write (slow-loris) policing, every 500 ms. A
        connection that sends nothing for idle_s, or whose peer stops
        draining our responses for write_s, is closed — it holds
        buffers and an fd someone honest could be using."""
        while True:
            await asyncio.sleep(0.5)
            now = time.monotonic()
            for c in list(self.conns):
                if c.closed:
                    continue
                if (
                    self.write_s > 0
                    and c.write_paused_at is not None
                    and now - c.write_paused_at > self.write_s
                ):
                    c.close("error", cause="slow_write")
                elif c.paused:
                    # the SERVER paused this connection's reads
                    # (backpressure): its bytes sit unread in the
                    # kernel by our own choice — aborting it as idle/
                    # slow-read would turn 'paused, not loss' into
                    # loss. (slow_write above still applies: that is
                    # the PEER not reading us.) But a conn paused by
                    # the GLOBAL pass while holding little or no
                    # charge of its own may have no release left to
                    # resume it — if global inflight oscillates in
                    # (budget/2, budget] the release-side checks never
                    # fire for it, so the sweep is its resume backstop
                    if (
                        self.inflight <= self.inflight_budget
                        and c.inflight <= self.conn_inflight_budget // 2
                    ):
                        c.paused = False
                        c.transport.resume_reading()
                elif (
                    self.idle_s > 0
                    and c.partial_since is not None
                    and now - c.partial_since > self.idle_s
                ):
                    # read-side slow loris: a frame dribbled in byte by
                    # byte keeps last_activity fresh, but no single
                    # frame gets longer than idle_s to complete
                    c.close("error", cause="slow_read")
                elif (
                    self.idle_s > 0
                    and c.inflight == 0
                    and now - c.last_activity > self.idle_s
                ):
                    c.close("idle")

    async def _shutdown(self, drain_s: float) -> None:
        """Graceful drain: stop accepting, answer what is in flight,
        then close the rest. `Server.wait_closed` waits for every
        connection to drop (Python 3.12.1 on), so it comes last: awaited
        first, as the JAX package's drain does, it holds the drain until
        the stop times out and the loop dies with the connections open."""
        self.draining = True
        if self._server is not None:
            self._server.close()
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            if all(c.inflight == 0 for c in self.conns):
                break
            await asyncio.sleep(0.05)
        for c in list(self.conns):
            if not c.closed:
                c.outcome = "drained"
                c.transport.close()
        if self._sweep_task is not None:
            self._sweep_task.cancel()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass

    def stop(self, drain_s: float = 10.0) -> None:
        if self.loop is None or self._thread is None:
            return
        if not self._thread.is_alive():
            return  # already stopped (stop() is idempotent)
        if self._start_err is None:
            fut = asyncio.run_coroutine_threadsafe(
                self._shutdown(drain_s), self.loop
            )
            try:
                fut.result(timeout=drain_s + 5.0)
            except Exception:
                pass
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            pass  # loop already closed
        self._thread.join(timeout=10.0)
        self.pool.shutdown(wait=False)

    def stats(self) -> dict:
        return dict(
            metrics.ingress_snapshot(),
            inflight_bytes=self.inflight,
            draining=self.draining,
        )


# ---------------------------------------------------------------------------
# client


class IngressClient:
    """Synchronous wire-protocol client (tests and chip_smoke's ingress
    phase speak through this). One in-flight request
    at a time unless the caller pipelines explicitly via send()/recv().

    Every transport-level defect — connection refused/reset, torn
    frame, CRC mismatch, oversize response — raises ConnectionError:
    to a client the network failing IS one condition, answered by
    reconnect + idempotent resubmit. Duplicated responses (net_dup) are
    dropped by rid matching."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        max_frame: int = MAX_FRAME,
    ):
        import socket

        self.timeout = timeout
        self.max_frame = max_frame
        self._rid = 0
        self._buf = bytearray()
        # responses parsed while waiting for a different rid (client
        # pipelining: server answers in COMPLETION order, not request
        # order) — handed back when their recv() comes; rids already
        # handed back, so a net_dup duplicate is discarded. A rid
        # whose recv() TIMED OUT forfeits its response: the documented
        # recovery for a timeout is reconnect + idempotent resubmit,
        # never a re-recv of the same rid
        self._pending: dict = {}
        self._done_rids: set = set()
        self._outstanding: set = set()  # rids sent, not yet handed back
        self._sock = socket.create_connection((host, port), timeout=timeout)

    # -- framing --------------------------------------------------------
    def send(self, obj: dict) -> int:
        """Write one request frame; returns its rid (for recv)."""
        self._rid += 1
        obj = dict(obj, rid=self._rid)
        try:
            self._sock.sendall(encode_frame(obj))
        except OSError as e:
            raise ConnectionError(f"send failed: {e}") from None
        # only after the frame is on the wire: a failed send must not
        # leave a rid outstanding forever, pinning the prune floor
        self._outstanding.add(self._rid)
        return self._rid

    def _done(self, rid: int) -> None:
        """Record `rid` as handed back and bound the dup-tracking
        state: anything below the OLDEST rid still awaiting its recv
        can only ever be a duplicate — a long-lived client under
        dup-heavy chaos must not leak `_done_rids`/`_pending`, but a
        parked response a pipelining caller has yet to collect must
        survive the prune."""
        self._outstanding.discard(rid)
        self._done_rids.add(rid)
        floor = min(self._outstanding, default=self._rid)
        self._done_rids = {r for r in self._done_rids if r >= floor}
        for r in [r for r in self._pending if r < floor]:
            del self._pending[r]

    def recv(self, rid: Optional[int] = None, timeout: Optional[float] = None) -> dict:
        """Read frames until one matches `rid` (default: the last
        send), dropping duplicates/stale responses."""
        want = self._rid if rid is None else rid
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.timeout
        )
        while True:
            if want in self._pending:
                resp = self._pending.pop(want)  # pop BEFORE the prune
                self._done(want)
                return resp
            got = None
            for obj, _n in _parse_frames(self._buf, self.max_frame):
                r = obj.get("rid")
                if r == want or r is None:
                    # a net_dup duplicate of the awaited rid in the
                    # SAME parse batch is discarded here, never parked
                    if got is None:
                        got = obj
                elif r not in self._pending and r not in self._done_rids:
                    # an out-of-order pipelined response: park it; a
                    # DUPLICATE (net_dup) of one already parked or
                    # already handed back is discarded
                    self._pending[r] = obj
            if got is not None:
                self._done(want)
                return got
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # the caller is giving up on this rid: it must not pin
                # the prune floor for the rest of the client's life
                # (which also means a late response for it may be
                # pruned — a timed-out rid forfeits its response)
                self._outstanding.discard(want)
                raise ConnectionError(f"no response for rid {want} in time")
            self._sock.settimeout(min(remaining, 5.0))
            try:
                data = self._sock.recv(1 << 16)
            except OSError as e:
                import socket as _socket

                if isinstance(e, _socket.timeout):
                    continue
                raise ConnectionError(f"recv failed: {e}") from None
            if not data:
                raise ConnectionError("connection closed by server")
            self._buf += data

    def request(self, obj: dict, timeout: Optional[float] = None) -> dict:
        rid = self.send(obj)
        try:
            return self.recv(rid, timeout)
        except FrameError as e:
            raise ConnectionError(f"bad response frame: {e}") from None

    # -- ops ------------------------------------------------------------
    def submit(self, cid, epoch=None, timeout: Optional[float] = None) -> dict:
        return self.request(
            {"op": "submit", "cid": cid, "epoch": epoch}, timeout
        )

    def fetch(self, sid: int, senders=None, timeout=None) -> dict:
        req = {"op": "fetch", "sid": sid}
        if senders is not None:
            req["senders"] = list(senders)
        return self.request(req, timeout)

    def broadcast(self, sid: int, wire: str, timeout=None) -> dict:
        return self.request(
            {"op": "broadcast", "sid": sid, "wire": wire}, timeout
        )

    def wait(self, sid: int, timeout_s: float = 30.0) -> dict:
        return self.request(
            {"op": "wait", "sid": sid, "timeout": timeout_s},
            timeout=timeout_s + 10.0,
        )

    def ping(self) -> dict:
        return self.request({"op": "ping"})

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
