"""Multi-process shard supervisor: partition committees across N
`RefreshService` shard processes, health-check them by heartbeat, and
on shard death reassign its committees to a peer that replays the dead
shard's journal and resumes (an own copy of
fsdkr_tpu/serving/supervisor.py).

- **Partitioning**: committees shard by fingerprint (SHA-256 of the
  committee id, mod shard count) — sessions share nothing across
  committees but the config-keyed key pool, so the partition is clean.
  Reassignment after a death overrides the fingerprint (the assignment
  map, not the hash, is authoritative).
- **Shards** are child processes of THIS module
  (``python -m fsdkr_tpu_torch.serving.supervisor --shard ...``), each
  running one `RefreshService` with its own journal directory and a
  flight-recorder dump beside it (``--flight``). Every shard runs on
  ``device`` ("cuda" unless the caller asks for the CPU, as the tests
  do): a child that finds no card fails its ``ready`` and the
  supervisor raises — no shard carries on on the host. Shards on one
  card each hold their own CUDA context and load the kernels that
  ``build/`` already holds. Parent and child speak JSON lines over
  stdin/stdout; committee LocalKeys travel over that private pipe
  (never disk) using the `protocol.serialization` checkpoint codec. The
  child's stdout is the protocol alone: everything else the child or a
  library it loads prints goes to its ``stderr.log``.
- **Health**: shards heartbeat every ``hb_interval`` with their serving
  stats and journal counters, and dump their flight ring to
  ``<journal_dir>/flight.json`` on every beat — SIGKILL is uncatchable,
  so the postmortem is the last completed beat, collected by the
  supervisor at failover. Death is detected by process exit, stdout
  EOF, or a stale heartbeat. A beat whose stats raise (a precompute
  producer step failed: a kernel that cannot launch) goes out as a
  ``fault``: the supervisor records it in `errors` and fails the shard.
  A shard declared dead while its process still runs (stale heartbeat,
  broken pipe, fault) is SIGKILLed and reaped first, so the peer never
  replays a journal a live process still writes.
- **Failover**: the supervisor re-admits the dead shard's committees on
  a peer (admission-time key material), sends the peer a ``recover``
  command for the dead journal directory — terminal verdicts replay
  verbatim (idempotency index included), in-flight sessions settle
  ``aborted_transient`` (their new dks died with the shard, and
  recovery never fabricates a verdict) — then resubmits every pending
  epoch. The idempotency index makes that safe: a replayed-done epoch
  dedupes to its stored verdict instantly; a transiently-aborted epoch
  re-runs. MTTR is measured from death detection to the first pending
  epoch of that shard resolving.
- **Chaos**: the ``shard_kill`` fault site (`serving.faults`) is
  consulted by `chaos_kill` and acted out by `kill_shard` (SIGKILL).
  ``faults`` arms a fault plan inside every shard (the load generator's
  network storm: the ingress sites act there).
- **Tracing**: with ``trace=True`` every shard enables its span tracer
  and writes its Chrome trace to ``<journal_dir>/trace.json`` when it
  stops cleanly (a SIGKILLed shard leaves none).

Aggregate `fsdkr_serving_*` / `fsdkr_journal_*` / `fsdkr_ingress_*`
readings across shards come from the heartbeats
(`ShardSupervisor.aggregate`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["ShardSupervisor", "ShardHandle", "shard_for"]


def shard_for(committee_id, shards: int) -> int:
    """Fingerprint partition: stable across processes — SHA-256 of the
    canonical JSON id, never Python's salted hash()."""
    h = hashlib.sha256(
        json.dumps(committee_id, sort_keys=True).encode()
    ).digest()
    return int.from_bytes(h[:8], "big") % max(1, shards)


# ---------------------------------------------------------------------------
# shard child process


def _protocol_out():
    """The child's stdout for protocol lines alone: a private copy of
    fd 1, after which fd 1 (and sys.stdout) point at stderr, so nothing
    a library prints, and no compiler or warning output, can reach the
    parent's reader."""
    out = os.fdopen(os.dup(1), "w", buffering=1)
    sys.stdout.flush()
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return out


def _emit(out, lock: threading.Lock, obj: dict) -> None:
    with lock:
        out.write(json.dumps(obj, default=str) + "\n")
        out.flush()


def _start_device(device: str) -> Tuple[str, float, float]:
    """(device name, CUDA init seconds, kernel load seconds). On "cuda":
    a context on the card and the CIOS and EC kernels loaded (built
    first when `build/` lacks them); raises when torch finds no card."""
    import torch

    if device == "cpu":
        return "cpu", 0.0, 0.0
    if not torch.cuda.is_available():
        raise RuntimeError(
            "shard started with device='cuda' but torch finds no CUDA "
            "device; pass device='cpu' to serve on the plain versions"
        )
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    name = torch.cuda.get_device_name()
    t1 = time.perf_counter()
    from ..ops import ec_kernels, montgomery_kernels

    montgomery_kernels.load_library()
    ec_kernels.load_library()
    return name, t1 - t0, time.perf_counter() - t1


def _shard_main(args) -> int:
    """One shard: a RefreshService with a journal, driven by JSON-line
    commands on stdin, reporting events on stdout — and, with
    ``--ingress-port``, by wire-protocol clients on a TCP socket
    (`serving.ingress`). Runs until stdin closes or a ``stop`` command
    arrives."""
    out = _protocol_out()
    out_lock = threading.Lock()
    try:
        from ..protocol.serialization import local_key_from_json
        from ..telemetry import flight
        from . import recovery
        from .service import RefreshService, ServeRejected

        t_imported = time.time()
        import_s = t_imported - args.spawned_at if args.spawned_at else 0.0
        name, cuda_s, load_s = _start_device(args.device)
        flight.install(args.flight)
        if args.faults:
            from . import faults

            faults.configure(args.faults)
        if args.trace:
            from ..telemetry.spans import get_tracer

            get_tracer().enable()
        svc = RefreshService(
            journal=args.journal_dir,
            deadline_s=args.deadline,
            retries=args.retries,
            workers=args.workers,
            device=args.device,
        )
        svc.start()
    except Exception as e:
        _emit(out, out_lock, {
            "ev": "failed", "shard": args.shard_id,
            "detail": f"{type(e).__name__}: {e}",
        })
        return 2
    stop_evt = threading.Event()

    # network ingress: committees this shard does not own redirect to
    # the fleet's port map (installed by the parent's `ingress_peers`
    # command once every shard reported its bound port). The HINT is
    # the fingerprint owner; failover reassignments override
    # fingerprints, so clients fall back to trying the rest.
    peer_ports: Dict[int, int] = {}

    def _router(cid):
        if not peer_ports:
            return None
        hint = peer_ports.get(shard_for(cid, args.shards))
        return {
            "ports": {str(k): v for k, v in peer_ports.items()},
            "hint": hint,
        }

    ingress = None
    if args.ingress_port >= 0:
        from .ingress import IngressServer

        ingress = IngressServer(
            svc, host=args.ingress_host, port=args.ingress_port,
            router=_router,
        ).start()

    def heartbeat():
        from . import metrics as smetrics

        while not stop_evt.wait(args.hb_interval):
            try:
                flight.dump(args.flight, reason="heartbeat")  # postmortem-in-waiting
            except Exception:
                pass
            try:
                beat = {
                    "ev": "hb",
                    "shard": args.shard_id,
                    "stats": svc.stats(),  # raises a producer step's error
                    "journal": svc.journal_stats(),
                    "ingress": (
                        smetrics.ingress_snapshot()
                        if ingress is not None else None
                    ),
                }
            except Exception as e:
                beat = {"ev": "fault", "shard": args.shard_id,
                        "detail": f"{type(e).__name__}: {e}"}
            _emit(out, out_lock, beat)

    def waiter(cid, epoch, sid):
        s = svc.wait(sid)  # blocks until terminal
        flight.record("shard", "terminal", sid=sid, state=s.state, blame=s.blame)
        _emit(out, out_lock, {
            "ev": "terminal",
            "shard": args.shard_id,
            "cid": cid,
            "epoch": epoch,
            "sid": sid,
            "state": s.state,
            "blame": s.blame,
            "error": s.error,
            "latency_s": round(
                max(0.0, s.finalized_at - s.submitted_at), 4
            ),
            "retries": s.retries,
        })

    threading.Thread(target=heartbeat, daemon=True, name="shard-hb").start()
    # the shard's own lifecycle lands in the flight ring beside the
    # service's faults and recovery decisions: the postmortem a SIGKILL
    # leaves (the last heartbeat's dump) shows what the shard was doing
    flight.record("shard", "ready", shard=args.shard_id, device=name)
    _emit(out, out_lock, {
        "ev": "ready", "shard": args.shard_id, "pid": os.getpid(),
        "ingress_port": ingress.port if ingress is not None else None,
        "device": name,
        "startup": {
            "import_s": round(import_s, 4),
            "cuda_init_s": round(cuda_s, 4),
            "kernel_load_s": round(load_s, 4),
            "service_s": round(time.time() - t_imported - cuda_s - load_s, 4),
        },
    })

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            cmd = json.loads(line)
        except ValueError:
            _emit(out, out_lock, {"ev": "error", "detail": "bad command json"})
            continue
        op = cmd.get("cmd")
        try:
            if op == "admit":
                cid = cmd["cid"]
                if not svc.has_committee(cid):
                    keys = [local_key_from_json(k) for k in cmd["keys"]]
                    svc.admit(
                        cid, keys,
                        recovery.config_from_record(cmd["config"], args.device),
                    )
                flight.record("shard", "admit", cid=str(cid))
                _emit(out, out_lock, {"ev": "admitted", "shard": args.shard_id,
                                      "cid": cid})
            elif op == "submit":
                cid, epoch = cmd["cid"], cmd.get("epoch")
                try:
                    sid = svc.submit(cid, epoch=epoch)
                except ServeRejected as e:
                    _emit(out, out_lock, {
                        "ev": "rejected", "shard": args.shard_id,
                        "cid": cid, "epoch": epoch,
                        "retry_after_s": e.retry_after_s,
                    })
                    continue
                flight.record("shard", "submit", cid=str(cid), epoch=epoch, sid=sid)
                threading.Thread(
                    target=waiter, args=(cid, epoch, sid), daemon=True
                ).start()
            elif op == "recover":
                flight.record("recovery", "peer_journal_adopted",
                              dir=str(cmd["dir"]))
                report = recovery.recover(svc, cmd["dir"], svc.keystore)
                _emit(out, out_lock, {"ev": "recovered", "shard": args.shard_id,
                                      "report": report})
            elif op == "deadline":
                svc.deadline_s = float(cmd["s"])
                _emit(out, out_lock, {"ev": "deadline_set", "shard": args.shard_id})
            elif op == "sync":
                if svc.journal is not None:
                    svc.journal.sync()
                _emit(out, out_lock, {"ev": "synced", "shard": args.shard_id})
            elif op == "ingress_peers":
                peer_ports.clear()
                peer_ports.update(
                    {int(k): int(v) for k, v in cmd["ports"].items()}
                )
                _emit(out, out_lock, {"ev": "peers_set", "shard": args.shard_id})
            elif op == "stop":
                break
            else:
                _emit(out, out_lock, {"ev": "error", "detail": f"unknown cmd {op!r}"})
        except Exception as e:  # a failing command must not kill the shard
            _emit(out, out_lock, {
                "ev": "error", "shard": args.shard_id, "cmd": op,
                "detail": f"{type(e).__name__}: {e}",
            })
    stop_evt.set()
    if ingress is not None:
        ingress.stop()  # drain first: stop accepting, answer in-flight
    svc.stop()
    try:
        flight.dump(args.flight, reason="shard-exit")
    except Exception:
        pass
    if args.trace:
        from ..telemetry.spans import get_tracer

        get_tracer().write_chrome_trace(args.trace)
    _emit(out, out_lock, {"ev": "stopped", "shard": args.shard_id})
    return 0


# ---------------------------------------------------------------------------
# parent side


class ShardHandle:
    def __init__(self, idx: int, proc, journal_dir: pathlib.Path, spawned: float):
        self.idx = idx
        self.proc = proc
        self.journal_dir = journal_dir
        self.flight_path = journal_dir / "flight.json"
        self.stderr_path = journal_dir / "stderr.log"
        self.spawned = spawned  # monotonic
        self.ingress_port: Optional[int] = None
        self.device: Optional[str] = None  # the ready event's device name
        self.startup: dict = {}  # the ready event's split, + spawn_to_ready_s
        self.failed: Optional[str] = None  # a `failed` event's detail
        self.fault: Optional[str] = None  # a `fault` beat's detail
        self.alive = True
        self.ready = False
        self.stopped = False  # clean shutdown acknowledged
        self.failed_over = False  # death already handled
        self.last_hb = time.monotonic()
        self.last_stats: dict = {}
        self.last_journal: dict = {}
        self.last_ingress: dict = {}
        self.committees: set = set()


class ShardSupervisor:
    """Parent-side fleet controller. Construct, `start()`, `admit` and
    `submit` committees/epochs, call `pump()` from the driving loop (it
    drains shard events AND runs health checks / failover), `drain()`
    for quiescence, `stop()` to tear down. `outcomes` accumulates one
    record per resolved (committee, epoch); `errors` one per fault beat
    and per failed command a shard reported.

    `device` is every shard's torch device ("cuda": the shards run on
    the card; "cpu": on the plain versions)."""

    def __init__(
        self,
        shards: int = 2,
        root=None,
        deadline_s: float = 10.0,
        retries: int = 2,
        workers: int = 1,
        hb_interval: float = 0.5,
        hb_timeout: Optional[float] = None,
        spawn_timeout: float = 240.0,
        max_resubmits: int = 2,
        ingress: bool = False,
        ingress_host: str = "127.0.0.1",
        device: str = "cuda",
        faults: Optional[str] = None,
        trace: bool = False,
    ):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {device!r}")
        self.n_shards = max(1, int(shards))
        # absolute: the children run from the repo root
        self.root = pathlib.Path(root or ".fsdkr_shards").resolve()
        self.deadline_s = deadline_s
        self.retries = retries
        self.workers = workers
        self.hb_interval = hb_interval
        self.hb_timeout = hb_timeout or max(5.0, 8 * hb_interval)
        self.spawn_timeout = spawn_timeout
        self.max_resubmits = max_resubmits
        self.device = device
        self.faults = faults or None
        self.trace = bool(trace)
        # each shard listens on a TCP ingress port (kernel-assigned,
        # reported in its ready event); after start() the parent
        # broadcasts the port map so shards can redirect clients for
        # committees they do not own
        self.ingress = bool(ingress)
        self.ingress_host = ingress_host
        self.shards: List[ShardHandle] = []
        self.events: "queue.Queue[Tuple[int, dict]]" = queue.Queue()
        self.assignment: Dict[object, int] = {}
        self._admissions: Dict[object, Tuple[list, dict]] = {}
        # (cid, epoch) -> pending record; resolved ones move to outcomes
        self.pending: Dict[Tuple[object, Optional[int]], dict] = {}
        self.outcomes: List[dict] = []
        self.failovers: List[dict] = []
        self.errors: List[dict] = []
        self.kills = 0
        self._gen = 0  # failover generation, for MTTR attribution
        self._stopping = False
        # single-threaded by contract: pending/outcomes/assignment are
        # touched only from the thread driving pump()/submit(); the
        # reader threads just enqueue onto self.events

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Spawn every shard and wait for each one's ready. Raises when a
        shard fails its start (no card on device "cuda", a broken
        import) or is not ready within `spawn_timeout`; the shards
        already started are stopped first."""
        self.root.mkdir(parents=True, exist_ok=True)
        for i in range(self.n_shards):
            self.shards.append(self._spawn(i))
        deadline = time.monotonic() + self.spawn_timeout
        while time.monotonic() < deadline:
            self.pump(0.2, health=False)
            bad = [h for h in self.shards if h.failed or (not h.ready and not h.alive)]
            if bad:
                self.stop()
                raise RuntimeError(
                    "shards failed to start: " + "; ".join(
                        f"shard {h.idx}: "
                        f"{h.failed or h.fault or self._stderr_tail(h)}"
                        for h in bad
                    )
                )
            if all(h.ready for h in self.shards):
                if self.ingress:
                    ports = self.ingress_ports()
                    for h in self.shards:
                        self._send(h, {"cmd": "ingress_peers",
                                       "ports": ports})
                return
        missing = [h.idx for h in self.shards if not h.ready]
        self.stop()
        raise RuntimeError(f"shards never became ready: {missing}")

    @staticmethod
    def _stderr_tail(h: ShardHandle) -> str:
        try:
            return h.stderr_path.read_text(errors="replace")[-400:].strip() or "exited"
        except OSError:
            return "exited"

    def ingress_ports(self) -> Dict[int, int]:
        """Live shards' TCP ingress ports (empty unless ingress=True)."""
        return {
            h.idx: h.ingress_port
            for h in self.shards
            if h.alive and h.ingress_port is not None
        }

    def _child_cmd(self, idx: int) -> List[str]:
        """The interpreter command of shard `idx`, before its arguments."""
        return [sys.executable, "-m", "fsdkr_tpu_torch.serving.supervisor"]

    def _spawn(self, idx: int) -> ShardHandle:
        jdir = self.root / f"shard{idx:02d}"
        jdir.mkdir(parents=True, exist_ok=True)
        stderr = open(jdir / "stderr.log", "ab")
        spawned = time.monotonic()
        proc = subprocess.Popen(
            self._child_cmd(idx) + [
                "--shard", "--shard-id", str(idx),
                "--journal-dir", str(jdir),
                "--flight", str(jdir / "flight.json"),
                "--device", self.device,
                "--deadline", str(self.deadline_s),
                "--retries", str(self.retries),
                "--workers", str(self.workers),
                "--hb-interval", str(self.hb_interval),
                "--shards", str(self.n_shards),
                "--ingress-port", "0" if self.ingress else "-1",
                "--ingress-host", self.ingress_host,
                "--spawned-at", repr(time.time()),
            ] + (["--faults", self.faults] if self.faults else [])
              + (["--trace", str(jdir / "trace.json")] if self.trace else []),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=stderr,
            text=True,
            cwd=str(pathlib.Path(__file__).resolve().parents[2]),
        )
        stderr.close()
        handle = ShardHandle(idx, proc, jdir, spawned)
        threading.Thread(
            target=self._reader, args=(handle,), daemon=True,
            name=f"shard{idx}-reader",
        ).start()
        return handle

    def _reader(self, handle: ShardHandle) -> None:
        for line in handle.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                self.events.put((handle.idx, json.loads(line)))
            except ValueError:
                continue  # not a protocol line
        self.events.put((handle.idx, {"ev": "_eof"}))

    def stop(self) -> None:
        self._stopping = True
        for h in self.shards:
            if h.alive:
                self._send(h, {"cmd": "stop"})
        for h in self.shards:
            try:
                h.proc.wait(timeout=10)
            except Exception:
                h.proc.kill()
                h.proc.wait(timeout=10)

    def set_deadline(self, deadline_s: float) -> None:
        """A new session deadline on every live shard, for the sessions
        submitted from now on (and on a failover peer's resubmits)."""
        self.deadline_s = deadline_s
        for h in self._alive():
            self._send(h, {"cmd": "deadline", "s": deadline_s})

    # -- plumbing -------------------------------------------------------
    def _send(self, handle: ShardHandle, obj: dict) -> bool:
        try:
            handle.proc.stdin.write(json.dumps(obj, default=str) + "\n")
            handle.proc.stdin.flush()
            return True
        except Exception:
            # a broken pipe IS a death signal — route it through the
            # same one-shot death handler as EOF and the health check,
            # or the shard's committees would wedge un-failed-over
            self._on_death(handle, "broken pipe")
            return False

    def _on_death(self, handle: ShardHandle, cause: str) -> None:
        """One-shot death handling shared by every detection path
        (stdout EOF, broken stdin pipe, process exit, stale heartbeat, a
        fault beat): mark the shard dead, SIGKILL and reap its process
        if it still runs, and fail its committees over exactly once.
        Clean shutdowns (acked `stopped`, or supervisor stop() in
        progress) and shards that never became ready never failover."""
        handle.alive = False
        if (self._stopping or handle.stopped or handle.failed_over
                or not handle.ready):
            return
        handle.failed_over = True
        handle.proc.kill()  # SIGKILL; a no-op once the process has exited
        try:
            handle.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f"shard {handle.idx} ({cause}) outlived SIGKILL for 60 s: "
                "its journal cannot be handed to a peer"
            ) from None
        self._failover(handle, cause)

    def _alive(self) -> List[ShardHandle]:
        return [h for h in self.shards if h.alive]

    # -- committee / session intake -------------------------------------
    def admit(self, committee_id, keys, config) -> None:
        """Admit a committee fleet-wide: serialize its LocalKeys once
        (the failover re-admission source) and route to the fingerprint
        shard. The config's device is not sent: every shard runs on the
        supervisor's `device`."""
        from ..protocol.serialization import local_key_to_json
        from .recovery import config_record

        wire = [local_key_to_json(k) for k in keys]
        crec = config_record(config)
        self._admissions[committee_id] = (wire, crec)
        owner = shard_for(committee_id, self.n_shards)
        if not self.shards[owner].alive:
            owner = self._peer_for(owner)
        self.assignment[committee_id] = owner
        self.shards[owner].committees.add(committee_id)
        self._send(self.shards[owner], {
            "cmd": "admit", "cid": committee_id, "keys": wire,
            "config": crec,
        })

    def submit(self, committee_id, epoch: Optional[int]) -> None:
        owner = self.assignment[committee_id]
        key = (committee_id, epoch)
        if key not in self.pending:
            self.pending[key] = {
                "shard": owner,
                "t0": time.monotonic(),
                "via": "primary",
                "resubmits": 0,
                "gen": None,
            }
        self._send(self.shards[owner], {
            "cmd": "submit", "cid": committee_id, "epoch": epoch,
        })

    # -- event / health loop --------------------------------------------
    def pump(self, max_wait: float = 0.1, health: bool = True) -> None:
        """Drain shard events (blocking up to `max_wait` for the first)
        and run the health check. Call this from the driving loop."""
        deadline = time.monotonic() + max_wait
        block = max_wait
        while True:
            try:
                idx, ev = self.events.get(timeout=max(0.0, block))
            except queue.Empty:
                break
            self._on_event(idx, ev)
            block = deadline - time.monotonic()
            if block <= 0:
                # drain whatever is already queued, without blocking
                while True:
                    try:
                        idx, ev = self.events.get_nowait()
                    except queue.Empty:
                        break
                    self._on_event(idx, ev)
                break
        if health:
            self.check_health()

    def _on_event(self, idx: int, ev: dict) -> None:
        h = self.shards[idx]
        kind = ev.get("ev")
        if kind == "ready":
            h.ready = True
            h.ingress_port = ev.get("ingress_port")
            h.device = ev.get("device")
            h.startup = dict(ev.get("startup") or {},
                             spawn_to_ready_s=round(time.monotonic() - h.spawned, 4))
            h.last_hb = time.monotonic()
        elif kind == "failed":
            h.failed = ev.get("detail") or "failed"
        elif kind == "fault":
            # the shard's service is broken (a producer step raised): not
            # a stale beat, and not to be served from any longer
            h.fault = ev.get("detail") or "fault"
            self.errors.append({"shard": idx, "cmd": None, "detail": h.fault})
            from ..telemetry import flight

            flight.record("supervisor", "shard_fault", shard=idx,
                          detail=h.fault[:200])
            self._on_death(h, f"fault: {h.fault}")
        elif kind == "error":
            self.errors.append({"shard": idx, "cmd": ev.get("cmd"),
                                "detail": ev.get("detail")})
        elif kind == "hb":
            h.last_hb = time.monotonic()
            h.last_stats = ev.get("stats") or {}
            h.last_journal = ev.get("journal") or {}
            h.last_ingress = ev.get("ingress") or {}
        elif kind == "terminal":
            self._resolve(idx, ev)
        elif kind == "rejected":
            key = (ev.get("cid"), ev.get("epoch"))
            pend = self.pending.pop(key, None)
            if pend is not None:
                self.outcomes.append({
                    "cid": ev.get("cid"), "epoch": ev.get("epoch"),
                    "state": "rejected", "blame": False, "error": None,
                    "latency_s": None, "via": pend["via"], "shard": idx,
                })
        elif kind == "recovered":
            for fo in self.failovers:
                if fo.get("peer") == idx and "recovery" not in fo:
                    rep = ev.get("report") or {}
                    rep.pop("sessions", None)
                    fo["recovery"] = rep
                    # replay latency: death detection -> the peer
                    # finished adopting the journal (MTTR proper also
                    # needs an interrupted epoch to complete; this is
                    # the floor every failover pays)
                    fo["recover_s"] = round(
                        time.monotonic() - fo["detected_mono"], 4
                    )
                    break
        elif kind == "stopped":
            h.stopped = True
        elif kind == "_eof":
            # stdout EOF is the fastest death signal (a SIGKILL closes
            # the pipe immediately, long before the heartbeat staleness
            # window); a clean shutdown acked `stopped` first
            self._on_death(h, "exit")

    def _resolve(self, idx: int, ev: dict) -> None:
        key = (ev.get("cid"), ev.get("epoch"))
        pend = self.pending.get(key)
        if pend is None:
            return  # duplicate terminal for an already-resolved epoch
        state, blame = ev.get("state"), bool(ev.get("blame"))
        transient_failure = state in ("aborted", "timed_out") and not blame
        if transient_failure and pend["resubmits"] < self.max_resubmits:
            # the retry contract: transient failures (including
            # recovery's aborted_transient) are resubmittable — the
            # epoch index guarantees at most one effective run
            pend["resubmits"] += 1
            pend["via"] = "resubmit"
            owner = self.assignment[key[0]]
            self._send(self.shards[owner], {
                "cmd": "submit", "cid": key[0], "epoch": key[1],
            })
            return
        del self.pending[key]
        out = {
            "cid": key[0], "epoch": key[1], "state": state, "blame": blame,
            "error": ev.get("error"), "latency_s": ev.get("latency_s"),
            "total_s": round(time.monotonic() - pend["t0"], 4),
            "via": pend["via"], "resubmits": pend["resubmits"],
            "shard": idx,
        }
        self.outcomes.append(out)
        if pend.get("gen") is not None:
            for fo in self.failovers:
                if fo["gen"] == pend["gen"] and fo.get("mttr_s") is None:
                    fo["mttr_s"] = round(
                        time.monotonic() - fo["detected_mono"], 4
                    )

    def check_health(self) -> None:
        now = time.monotonic()
        for h in self.shards:
            if not h.alive:
                continue
            if h.proc.poll() is not None:
                self._on_death(h, "exit")
            elif h.ready and now - h.last_hb > self.hb_timeout:
                self._on_death(h, "stale heartbeat")

    def _peer_for(self, dead_idx: int) -> int:
        alive = [h.idx for h in self._alive()]
        if not alive:
            raise RuntimeError("no live shard left to adopt committees")
        # deterministic: the next live shard after the dead one
        for off in range(1, self.n_shards):
            cand = (dead_idx + off) % self.n_shards
            if cand in alive:
                return cand
        return alive[0]

    def _failover(self, dead: ShardHandle, cause: str) -> None:
        """Reassign the dead shard's committees to a peer, replay its
        journal there, resubmit its pending epochs. `dead`'s process has
        exited."""
        from ..telemetry import flight

        detected = time.monotonic()
        self._gen += 1
        gen = self._gen
        flight.record("supervisor", "shard_death", shard=dead.idx, gen=gen,
                      cause=cause[:200])
        peer = self.shards[self._peer_for(dead.idx)]
        fo = {
            "gen": gen,
            "dead": dead.idx,
            "peer": peer.idx,
            "cause": cause,
            "exit_code": dead.proc.returncode,
            "detected_mono": detected,
            "detected_wall": time.time(),
            "committees": len(dead.committees),
            "journal_dir": str(dead.journal_dir),
            # the dead shard's postmortem: its last completed heartbeat
            # flight dump, collected beside its journal
            "flight_dump": (
                str(dead.flight_path) if dead.flight_path.exists() else None
            ),
            "mttr_s": None,
        }
        self.failovers.append(fo)
        moved = sorted(dead.committees, key=str)
        fo["moved"] = list(moved)
        for cid in moved:
            wire, crec = self._admissions[cid]
            self._send(peer, {
                "cmd": "admit", "cid": cid, "keys": wire, "config": crec,
            })
            self.assignment[cid] = peer.idx
            peer.committees.add(cid)
        dead.committees.clear()
        # peer hygiene: refresh every live shard's redirect port map so
        # no redirect keeps steering clients at the dead shard's port —
        # the fingerprint hint dies with the shard, the ports list
        # shrinks to the living
        ports = self.ingress_ports()
        if ports:
            for h in self._alive():
                self._send(h, {"cmd": "ingress_peers", "ports": ports})
        self._send(peer, {"cmd": "recover", "dir": str(dead.journal_dir)})
        # resubmit every unresolved epoch the dead shard owned; the
        # peer's restored idempotency index replays done epochs
        # instantly and re-runs transient ones
        moved_set = set(moved)
        for (cid, epoch), pend in list(self.pending.items()):
            if cid not in moved_set:
                continue
            pend["shard"] = peer.idx
            pend["via"] = "failover"
            pend["gen"] = gen
            self._send(peer, {
                "cmd": "submit", "cid": cid, "epoch": epoch,
            })

    # -- chaos ----------------------------------------------------------
    def kill_shard(self, idx: Optional[int] = None) -> Optional[int]:
        """SIGKILL a live shard (the `shard_kill` fault site acts
        through here). Returns the killed index, or None when no victim
        is available (never kill the last shard standing)."""
        alive = self._alive()
        if len(alive) < 2:
            return None
        victim = None
        for h in alive:
            if idx is None or h.idx == idx:
                victim = h
                break
        if victim is None:
            return None
        try:
            os.kill(victim.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.kills += 1
        return victim.idx

    def chaos_kill(self, key, idx: Optional[int] = None) -> Optional[int]:
        """The `shard_kill` site: when the installed fault plan fires for
        `key` (the caller's tick), SIGKILL shard `idx` (or the first live
        one) through `kill_shard`. Returns the killed index or None."""
        from . import faults

        plan = faults.active()
        if plan is None or not plan.fire("shard_kill", (key,)):
            return None
        return self.kill_shard(idx)

    # -- quiescence / reporting -----------------------------------------
    def drain(self, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while self.pending and time.monotonic() < deadline:
            self.pump(0.2)
        return not self.pending

    def aggregate(self) -> dict:
        """Fleet-wide rollup from the last heartbeats (dead shards
        contribute their final beat — the aggregate survives kills)."""
        agg: Dict[str, float] = {}
        jagg: Dict[str, float] = {}
        iagg: Dict[str, object] = {}

        def _merge(into: dict, frm: dict) -> None:
            for k, v in frm.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    into[k] = into.get(k, 0) + v
                elif isinstance(v, dict):
                    _merge(into.setdefault(k, {}), v)

        for h in self.shards:
            for k, v in (h.last_stats or {}).items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
            for k, v in (h.last_journal or {}).items():
                if isinstance(v, (int, float)):
                    jagg[k] = jagg.get(k, 0) + v
            _merge(iagg, h.last_ingress or {})
        return {
            "shards": self.n_shards,
            "alive": len(self._alive()),
            "kills": self.kills,
            "failovers": [
                {k: v for k, v in fo.items() if k != "detected_mono"}
                for fo in self.failovers
            ],
            "errors": list(self.errors),
            "serving": agg,
            "journal": jagg,
            "ingress": iagg,
        }


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shard", action="store_true",
                   help="run as a shard child process (internal)")
    p.add_argument("--shard-id", type=int, default=0)
    p.add_argument("--journal-dir", default=None)
    p.add_argument("--flight", default=None,
                   help="the flight recorder's dump (default: "
                        "<journal-dir>/flight.json)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--deadline", type=float, default=10.0)
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--hb-interval", type=float, default=0.5)
    p.add_argument("--shards", type=int, default=1,
                   help="fleet shard count (redirect fingerprint hints)")
    p.add_argument("--ingress-port", type=int, default=-1,
                   help="TCP ingress port (0 = kernel-assigned, "
                        "-1 = no ingress)")
    p.add_argument("--ingress-host", default="127.0.0.1")
    p.add_argument("--spawned-at", type=float, default=0.0,
                   help="the parent's time.time() at spawn (start-up split)")
    p.add_argument("--faults", default=None,
                   help="a fault plan spec armed in the shard (serving.faults)")
    p.add_argument("--trace", default=None,
                   help="enable the span tracer; its Chrome trace goes to "
                        "this path at a clean stop")
    args = p.parse_args(argv)
    if not args.shard:
        p.error("supervisor is a library; only --shard mode runs directly "
                "(use ShardSupervisor)")
    if not args.journal_dir:
        p.error("--journal-dir is required in --shard mode")
    if not args.flight:
        args.flight = str(pathlib.Path(args.journal_dir) / "flight.json")
    return _shard_main(args)


if __name__ == "__main__":
    sys.exit(main())
