"""Serving load generator (an own copy of scripts/loadgen.py): Poisson
refresh arrivals across many committees through the port's
RefreshService, reporting sustained sessions/s, exact end-to-end latency
percentiles and pool economics; with --chaos the same window under a
deterministic fault plan, with verdict-correctness accounting; the
crash storm (--crash-storm) and the network storm (--net) over a shard
fleet on the card. Run as ``python -m fsdkr_tpu_torch.serving.loadgen``.

Modes, each returning the JAX package's report dict and gates:

- the default window (`run_window`): 1. keygen `--bases` distinct
  committees and clone them out to `--committees` (cloned committees
  share auxiliary mod-N~ parameters until their first epoch rotates
  every Paillier key; the clone count is reported); 2. admit everything
  and run one unmeasured seed epoch per committee; 3. wait for the
  background producer to fill the planned pool depth (--prefill-wait);
  4. the measured window: open-loop Poisson arrivals at --rate over
  uniformly random committees, then drain.
- --chaos: between 3 and 4 a fault-free baseline window, then the
  window under the fault plan; every session classified against the
  faults that hit it (zero wedged, zero wrong verdicts); then the
  tamper-economics curve (--curve, `run_tamper_curve`): closed-loop
  bursts at each malicious-traffic rate, with the RLC bisections and
  the wall a session.
- --crash-storm (`run_crash_storm`): Poisson arrivals over a
  ShardSupervisor fleet while the `shard_kill` fault site SIGKILLs
  shards at seed-determined ticks; gates on zero lost accepted
  broadcasts across every journal, zero wrong verdicts, zero wedged,
  and the kills injected; reports MTTR per failover, `recover_s` and
  the bystander p99.
- --net (`run_net_storm`, composing --kills): wire-protocol client
  processes (``--net-client``, the port's IngressClient) over TCP
  against an ingress-enabled fleet under the network fault sites armed
  in every shard.

Differences from scripts/loadgen.py: `--device` ("cuda" unless asked
for "cpu") takes the place of `--backend tpu`, and `--backend` picks the
verifier ("cuda", the card's kernels, or "host"); `platform` reads
`<device>-shards`; the report records torch's CUDA version and the
card's name and power limit; reports go under chiprun_out/ by default;
`--trace PATH` enables the span tracer and writes its Chrome trace
(the storms' shards trace too: each writes its own when it stops
cleanly, copied beside PATH as `<stem>.shardNN.json`, and the report
sums their spans by name). `--deadline-factor F` sets the storms' session deadline to F
times the seed epoch's p99 once the seed epoch has run. Journals are
audited with `serving.recovery.load_state`. The module reads no
environment: every knob is an argument.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import subprocess
import sys
import time

# rates chosen so a short smoke window still fires every class at least
# once (per-message sites roll n times per session); seed is appended
DEFAULT_FAULTS = (
    "worker_crash=0.3,finalize_exc=0.25,pool_dry=0.05,msg_delay=0.15,"
    "msg_drop=0.12,msg_dup=0.15,msg_tamper=0.15,mem_squeeze=0.5,"
    "delay_s=0.4,squeeze_factor=0.25"
)

# network-chaos storm: per-frame rates at the ingress — a session
# exchanges ~8-10 frames, so a few percent per frame hits a large
# fraction of sessions with at least one dropped connection, torn
# response, duplicated response, or delayed answer
DEFAULT_NET_FAULTS = (
    "conn_drop=0.04,frame_truncate=0.02,net_delay=0.08,net_dup=0.06,"
    "delay_s=0.3"
)

OUT_DIR = "chiprun_out"

__all__ = [
    "DEFAULT_FAULTS",
    "DEFAULT_NET_FAULTS",
    "parse_args",
    "percentile",
    "device_info",
    "run_window",
    "collect_sessions",
    "classify_chaos",
    "run_tamper_curve",
    "run_net_client",
    "run_crash_storm",
    "run_net_storm",
    "run_service_window",
    "main",
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--committees", type=int, default=200)
    p.add_argument("--bases", type=int, default=4,
                   help="distinct keygen committees cloned out to --committees")
    p.add_argument("--n", type=int, default=3, help="committee size")
    p.add_argument("--t", type=int, default=1, help="threshold")
    p.add_argument("--bits", type=int, default=640,
                   help="Paillier modulus bits (640 = smallest exact-recovery size)")
    p.add_argument("--m-security", type=int, default=8)
    p.add_argument("--ck-rounds", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of every service and shard")
    p.add_argument("--backend", choices=("cuda", "host"), default="cuda",
                   help="verifier backend (cuda = the device kernels, or "
                        "their plain versions on --device cpu)")
    p.add_argument("--window", type=float, default=60.0,
                   help="measured window seconds")
    p.add_argument("--rate", type=float, default=0.0,
                   help="offered sessions/sec (0 = auto: ~70%% of calibrated capacity)")
    p.add_argument("--seed-epochs", type=int, default=1)
    p.add_argument("--prefill-wait", type=float, default=60.0)
    p.add_argument("--drain-timeout", type=float, default=300.0)
    p.add_argument("--max-backlog", type=int, default=64,
                   help="arrivals shed (not queued) beyond this in-flight count")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--tag", default=None,
                   help="report tag (default: sustained, or storm with --chaos)")
    p.add_argument("--out", default=None,
                   help=f"report path (default {OUT_DIR}/serving_<tag>.json, "
                        "chaos_<tag>.json, crash_storm.json or net_storm.json)")
    p.add_argument("--trace", default=None,
                   help="enable the span tracer and write its Chrome trace here")
    # ---- chaos mode --------------------------------------------------
    p.add_argument("--chaos", action="store_true",
                   help="run the measured window under a fault plan and "
                        "emit the chaos report")
    p.add_argument("--faults", default=None,
                   help="fault plan spec (default: the storm spec with "
                        "--seed appended)")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="per-session deadline seconds (chaos default 15, "
                        "storms 8; 0 = the service's default)")
    p.add_argument("--deadline-factor", type=float, default=0.0,
                   help="storms: the deadline after the seed epoch becomes "
                        "this factor times the seed epoch's p99 (0 = off)")
    p.add_argument("--retries", type=int, default=None,
                   help="transient-failure retries (default: the service's, 2)")
    p.add_argument("--baseline-window", type=float, default=0.0,
                   help="fault-free baseline window seconds (chaos; default "
                        "min(window, 20))")
    p.add_argument("--curve", default="0,0.01,0.05",
                   help="tamper-rate curve for the bisection-economics "
                        "measurement ('' disables)")
    p.add_argument("--curve-sessions", type=int, default=18,
                   help="closed-loop sessions per curve point")
    p.add_argument("--bisect-budget", type=int, default=0,
                   help="per-committee RLC bisection budget per window "
                        "(0 = guard off)")
    p.add_argument("--p99-bound", type=float, default=3.0,
                   help="chaos gate: healthy-traffic p99 must stay within "
                        "this factor of the fault-free baseline")
    # ---- crash-storm mode ----------------------------------------------
    p.add_argument("--crash-storm", action="store_true",
                   help="Poisson window over a multi-process shard "
                        "supervisor with periodic SIGKILLs")
    p.add_argument("--shards", type=int, default=4,
                   help="shard processes under the supervisor")
    p.add_argument("--kills", type=int, default=None,
                   help="shard SIGKILLs injected across the window "
                        "(the shard_kill fault site; default 3 for "
                        "--crash-storm, 0 for --net — network chaos "
                        "composes with kills only when asked)")
    p.add_argument("--journal-root", default=None,
                   help="journal root directory (default: a temp dir; "
                        "journals hold PUBLIC data only)")
    p.add_argument("--journal-dir", default=None,
                   help="journal THIS run's single service to the given "
                        "directory (the report gains a `journal` block)")
    # ---- network mode --------------------------------------------------
    p.add_argument("--net", action="store_true",
                   help="multi-process network storm: client processes "
                        "speak the wire protocol over real TCP sockets "
                        "against an ingress-enabled ShardSupervisor "
                        "(combine with --kills N for the crash x network "
                        "storm)")
    p.add_argument("--clients", type=int, default=2,
                   help="wire-protocol client processes (--net)")
    p.add_argument("--net-faults", default=None,
                   help="network fault spec armed in every shard "
                        "(conn_drop/frame_truncate/net_delay/net_dup; "
                        "default: the net storm spec with --seed appended; "
                        "'' = no network chaos)")
    p.add_argument("--max-attempts", type=int, default=5,
                   help="client resubmit attempts per epoch before it "
                        "counts as unresolved/wedged (--net)")
    p.add_argument("--net-client", action="store_true",
                   help=argparse.SUPPRESS)  # internal: client worker
    return p.parse_args(argv)


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return round(sorted_vals[idx], 4)


def device_info(device: str) -> dict:
    """torch's and CUDA's versions, and on "cuda" the card's name and
    power limit as nvidia-smi reports them."""
    import torch

    info = {"device": device, "torch": torch.__version__, "cuda": torch.version.cuda,
            "card": None, "power_limit": None}
    if device == "cuda" and torch.cuda.is_available():
        info["card"] = torch.cuda.get_device_name(0)
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            )
            if out.returncode == 0 and out.stdout.strip():
                info["power_limit"] = out.stdout.strip().splitlines()[0].split(",")[-1].strip()
        except (OSError, subprocess.SubprocessError):
            pass
    return info


def _config(args):
    from ..config import ProtocolConfig

    return ProtocolConfig(
        paillier_bits=args.bits,
        m_security=args.m_security,
        correct_key_rounds=args.ck_rounds,
        backend=args.backend,
        device=args.device,
    )


def _committees(args, config):
    """`--bases` keygens cloned out to `--committees`: {cid: keys}, and
    the keygen seconds."""
    from ..protocol import simulate_keygen

    t0 = time.time()
    bases = [simulate_keygen(args.t, args.n, config) for _ in range(args.bases)]
    committees = {
        cid: [k.clone() for k in bases[cid % args.bases]]
        for cid in range(args.committees)
    }
    return committees, time.time() - t0


def _build_kernels(device: str) -> None:
    """On the card, build (or load) the CIOS and EC kernels once in this
    process, so the shards load what it built instead of each starting a
    build."""
    if device == "cuda":
        from ..ops import ec_kernels, montgomery_kernels

        montgomery_kernels.load_library()
        ec_kernels.load_library()


def _write_report(report: dict, out: str) -> str:
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(out).write_text(json.dumps(report, indent=1, default=str) + "\n")
    return out


def _start_trace(args) -> None:
    if args.trace:
        from ..telemetry.spans import get_tracer

        get_tracer().enable()


def _end_trace(args, report: dict) -> None:
    """Write the parent's Chrome trace and name it, with the phases'
    stats, in the report."""
    if not args.trace:
        return
    from ..telemetry.spans import get_tracer

    tr = get_tracer()
    pathlib.Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    report["trace"] = {
        "path": tr.write_chrome_trace(args.trace),
        "spans": len(tr.spans()),
        "spans_dropped": tr.spans_dropped(),
        "phase_seconds": {k: round(v.seconds, 4) for k, v in tr.stats().items()},
    }


def run_window(svc, cids, rng, rate, window_s, max_backlog, drain_timeout,
               backlog_shed_inline):
    """One open-loop Poisson window. Returns (session ids, inline-shed
    count, service-rejected count, window wall, drained, drain wall,
    window start)."""
    from .service import ServeRejected

    win_ids, shed, rejected = [], 0, 0
    t_win = time.monotonic()
    next_arrival = t_win
    while True:
        now = time.monotonic()
        if now - t_win >= window_s:
            break
        if now < next_arrival:
            time.sleep(min(0.005, next_arrival - now))
            continue
        next_arrival += rng.expovariate(rate)
        if backlog_shed_inline and svc.stats()["inflight"] >= max_backlog:
            shed += 1
            continue
        try:
            win_ids.append(svc.submit(rng.choice(cids)))
        except ServeRejected:
            rejected += 1
    window_wall = time.monotonic() - t_win
    drained = svc.drain(timeout=drain_timeout)
    drain_wall = time.monotonic() - t_win - window_wall
    return win_ids, shed, rejected, window_wall, drained, drain_wall, t_win


def collect_sessions(svc, win_ids):
    """wait(sid, 0) per id; a TimeoutError is a WEDGED session — the
    failure class the chaos gate exists to catch."""
    sessions, wedged = [], 0
    for sid in win_ids:
        try:
            sessions.append(svc.wait(sid, 0))
        except TimeoutError:
            wedged += 1
    return sessions, wedged


def classify_chaos(sessions):
    """Per-session verdict-correctness accounting against the faults
    that hit each session. Wrong verdicts: a session with NO disruptive
    fault aborted with identifiable blame, or a tampered session
    finished clean."""
    out = {
        "done_clean": 0, "recovered": 0, "aborted_blame": 0,
        "aborted_transient": 0, "timed_out": 0,
        "timed_out_named": 0, "wrong_verdicts": 0,
        "wrong_detail": [],
    }
    for s in sessions:
        tampered = any(f.startswith("msg_tamper") for f in s.faults)
        dropped = any(f.startswith("msg_drop") for f in s.faults)
        transient = s.retries > 0 or any(
            f in ("worker_crash", "finalize_exc") for f in s.faults
        )
        if s.state == "done":
            out["recovered" if (transient or tampered) else "done_clean"] += 1
            if tampered:
                out["wrong_verdicts"] += 1
                out["wrong_detail"].append(
                    f"session {s.session_id}: tampered but finished clean"
                )
        elif s.state == "aborted":
            out["aborted_blame" if s.blame else "aborted_transient"] += 1
            if s.blame and not tampered:
                out["wrong_verdicts"] += 1
                out["wrong_detail"].append(
                    f"session {s.session_id}: healthy but blamed: {s.error}"
                )
        elif s.state == "timed_out":
            out["timed_out"] += 1
            if "missing senders" in (s.error or ""):
                out["timed_out_named"] += 1
            elif dropped and "state 'collecting'" in (s.error or ""):
                # a collecting-state timeout always knows its drops (fault
                # decisions are rolled before distribute); a timeout while
                # still queued/distributing has no senders to name
                out["wrong_verdicts"] += 1
                out["wrong_detail"].append(
                    f"session {s.session_id}: dropped-message timeout did "
                    f"not name senders: {s.error}"
                )
    out["wrong_detail"] = out["wrong_detail"][:8]
    return out


def run_tamper_curve(svc, cids, rates, sessions_per_rate, seed, drain_timeout):
    """Closed-loop bursts at each tamper rate: RLC bisection fallbacks
    and the wall a session, plus admission rejections when the bisect
    guard is armed."""
    from . import faults
    from . import metrics as smetrics
    from .service import ServeRejected

    curve = []
    for rate in rates:
        svc.guard.reset()  # each point starts with a clean budget window
        spec = f"seed={seed},msg_tamper={rate}" if rate > 0 else f"seed={seed}"
        plan = faults.configure(spec)
        bisect0 = smetrics.rlc_bisect_count()
        t0 = time.monotonic()
        ids, rejected = [], 0
        for k in range(sessions_per_rate):
            # wait out OVERLOAD rejections (the curve measures verify
            # cost, not admission); a bisection-budget rejection IS the
            # measurement — the guard shedding the tampering committee
            while True:
                try:
                    ids.append(svc.submit(cids[k % len(cids)]))
                    break
                except ServeRejected as e:
                    if "bisection" in e.reason:
                        rejected += 1
                        break
                    time.sleep(min(0.5, e.retry_after_s))
        svc.drain(timeout=drain_timeout)
        wall = time.monotonic() - t0
        sessions, wedged = collect_sessions(svc, ids)
        aborted = sum(s.state == "aborted" for s in sessions)
        point = {
            "tamper_rate": rate,
            "sessions": len(ids),
            "rejected": rejected,
            "aborted": aborted,
            "wedged": wedged,
            "tamper_injected": plan.injected().get("msg_tamper", 0),
            "bisect_fallbacks": smetrics.rlc_bisect_count() - bisect0,
            "wall_s": round(wall, 2),
            "s_per_session": round(wall / max(1, len(ids)), 4),
        }
        faults.reset()
        curve.append(point)
        _log(f"[loadgen] curve tamper={rate}: {point['bisect_fallbacks']} "
             f"bisects, {point['s_per_session']}s/session, "
             f"{aborted} aborted, {rejected} rejected")
    return curve


# ---------------------------------------------------------------------------
# the network storm's client process


def run_net_client() -> int:
    """Internal worker for --net (spawned as `--net-client`): one
    wire-protocol client process. Reads its spec as one JSON line on
    stdin, prints `{"ev": "ready"}`, waits for a `go` line, runs a
    Poisson window of refresh epochs over its committees ENTIRELY over
    TCP (submit -> receive the broadcast set -> re-deliver every
    broadcast -> wait for the verdict), and prints one result JSON line.
    The client IS the broadcast channel: it retries through redirects,
    rejections, dropped connections and torn frames — reconnect and
    idempotent resubmit — and classifies what it observed."""
    import threading

    from .ingress import IngressClient
    from .supervisor import shard_for

    spec = json.loads(sys.stdin.readline())
    ports = [int(p) for p in spec["ports"].values()]
    port_of_shard = {int(k): int(v) for k, v in spec["ports"].items()}
    n_shards = int(spec["shards"])
    committees = list(spec["committees"])
    epochs = {int(c): int(e) for c, e in spec["epochs"]}
    rate = float(spec["rate_hz"])
    window_s = float(spec["window_s"])
    deadline_s = float(spec["deadline_s"])
    max_attempts = int(spec["max_attempts"])
    op_timeout = float(spec.get("op_timeout_s", 30.0))
    rng = random.Random(int(spec["seed"]))
    counters = {"reconnects": 0, "redirects": 0, "rejected": 0,
                "unknown_committee_retries": 0, "sessions_started": 0}
    lock = threading.Lock()

    def count(k, n=1):
        with lock:
            counters[k] = counters.get(k, 0) + n

    def run_epoch(cid, epoch, out):
        t0 = time.monotonic()
        attempts = reconnects = redirects = 0
        # first dial: the fingerprint owner (a failover overrides it; the
        # redirect response re-routes)
        port = port_of_shard.get(shard_for(cid, n_shards), ports[0])
        ports_cycle = [port] + [p for p in ports if p != port]
        cycle_i = 0
        cli = None
        outcome = None
        budget = t0 + deadline_s * (max_attempts + 1) + 60.0
        while outcome is None and attempts < max_attempts and time.monotonic() < budget:
            attempts += 1
            try:
                if cli is None:
                    cli = IngressClient("127.0.0.1", port, timeout=op_timeout)
                r = cli.submit(cid, epoch, timeout=op_timeout)
                typ = r.get("type")
                if typ == "redirect":
                    redirects += 1
                    count("redirects")
                    attempts -= 1  # routing, not a failed attempt
                    hint = r.get("hint")
                    new_port = int(hint) if hint else None
                    if new_port is None or new_port == port:
                        pp = [int(v) for v in (r.get("ports") or {}).values()]
                        alt = [p for p in (pp or ports) if p != port]
                        new_port = alt[0] if alt else port
                    port = new_port
                    cli.close()
                    cli = None
                    continue
                if typ == "rejected":
                    count("rejected")
                    attempts -= 1  # shed is an answer, not an attempt
                    time.sleep(min(1.0, float(r.get("retry_after_s", 0.1))))
                    continue
                if typ == "error":
                    if r.get("error") == "unknown_committee":
                        # failover in flight: the committee is between
                        # shards — rotate ports until one owns it
                        count("unknown_committee_retries")
                        attempts -= 1
                        cycle_i += 1
                        port = ports_cycle[cycle_i % len(ports_cycle)]
                        cli.close()
                        cli = None
                        time.sleep(0.2)
                        continue
                    time.sleep(0.2)
                    continue
                sid = r["sid"]
                count("sessions_started")
                if r.get("state") in ("done", "aborted", "timed_out"):
                    # idempotent dedupe handed back a finished epoch
                    # (replayed after failover): that IS the verdict
                    outcome = {"state": r["state"], "blame": bool(r.get("blame")),
                               "error": r.get("error")}
                    break
                bcasts = r.get("broadcasts")
                if bcasts is None:
                    f = cli.fetch(sid, timeout=op_timeout)
                    while f.get("type") in ("pending", "rejected") \
                            and time.monotonic() < budget:
                        # pending: the session is alive, distribute has
                        # not finished; rejected: the limiter shed this
                        # fetch — retry the fetch, honouring retry_after_s
                        if f.get("type") == "rejected":
                            count("rejected")
                        time.sleep(max(0.1, float(f.get("retry_after_s", 0.0))))
                        f = cli.fetch(sid, timeout=op_timeout)
                    if f.get("type") in ("pending", "rejected"):
                        continue  # the wall budget expired first
                    bcasts = f.get("broadcasts") or []
                rng.shuffle(bcasts)  # arrival order must not matter
                resubmit = False
                for _snd, wire in bcasts:
                    ack = cli.broadcast(sid, wire, timeout=op_timeout)
                    if ack.get("type") != "broadcast_ack" or ack.get("result") == "unknown":
                        # "unknown": the session died with its shard
                        resubmit = True
                        break
                if resubmit:
                    continue
                term = cli.wait(sid, deadline_s + 10.0)
                if term.get("type") == "error" and term.get("error") == "timeout":
                    term = cli.wait(sid, deadline_s + 10.0)  # once more
                if term.get("type") != "terminal":
                    continue
                st = term["state"]
                outcome = {"state": st, "blame": bool(term.get("blame")),
                           "error": term.get("error"),
                           "server_latency_s": term.get("latency_s")}
                if st == "done" or (st == "aborted" and outcome["blame"]):
                    break  # verdicts are final; transients retry
                outcome = None if attempts < max_attempts else outcome
            except (ConnectionError, OSError):
                # a network failure is NOT a protocol attempt: rotate
                # ports and redial (the wall budget bounds a dead fleet)
                attempts -= 1
                reconnects += 1
                count("reconnects")
                if cli is not None:
                    cli.close()
                    cli = None
                cycle_i += 1
                port = ports_cycle[cycle_i % len(ports_cycle)]
                time.sleep(min(1.0, 0.05 * (reconnects + attempts)))
        if cli is not None:
            cli.close()
        if outcome is None:
            outcome = {"state": "unresolved", "blame": False,
                       "error": "client attempts exhausted"}
        outcome.update(
            cid=cid, epoch=epoch, attempts=attempts,
            reconnects=reconnects, redirects=redirects,
            latency_s=round(time.monotonic() - t0, 4),
            end_unix=time.time(),
        )
        out.append(outcome)

    print(json.dumps({"ev": "ready"}), flush=True)
    if not sys.stdin.readline():  # the parent's start barrier
        return 1
    outcomes: list = []
    busy = {}
    threads = []
    t_win = time.monotonic()
    next_arrival = t_win
    while time.monotonic() - t_win < window_s:
        now = time.monotonic()
        if now < next_arrival:
            time.sleep(min(0.01, next_arrival - now))
            continue
        next_arrival += rng.expovariate(rate)
        idle = [c for c in committees if not (busy.get(c) and busy[c].is_alive())]
        if not idle:
            continue  # every committee has an epoch in flight
        cid = rng.choice(idle)
        epoch = epochs[cid]
        epochs[cid] = epoch + 1
        th = threading.Thread(target=run_epoch, args=(cid, epoch, outcomes), daemon=True)
        busy[cid] = th
        threads.append(th)
        th.start()
    join_deadline = time.monotonic() + deadline_s * (max_attempts + 1) + 90
    for th in threads:
        th.join(timeout=max(1.0, join_deadline - time.monotonic()))
    print(json.dumps({
        "ev": "result",
        "client_id": spec.get("client_id"),
        "window_s": round(time.monotonic() - t_win, 2),
        "outcomes": outcomes,
        "counters": counters,
        "threads_unjoined": sum(th.is_alive() for th in threads),
    }, default=str), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the storms


def _seed_fleet(sup, committees, args, tag):
    """Epoch 0 of every committee through the pipes (unmeasured; warms the
    shards' engine caches). Returns ({cid: next epoch}, seconds, the seed
    outcomes)."""
    t0 = time.time()
    epoch_of = {}
    for cid in committees:
        sup.submit(cid, 0)
        epoch_of[cid] = 1
    if not sup.drain(timeout=max(args.drain_timeout, 10 * args.committees)):
        _log(f"[{tag}] WARNING: seed epoch did not drain: {sup.pending}")
    seed_s = time.time() - t0
    outcomes = list(sup.outcomes)
    sup.outcomes.clear()
    return epoch_of, seed_s, outcomes


def _seed_p99(outcomes):
    return percentile(sorted(o["latency_s"] for o in outcomes
                             if o["state"] == "done" and o["latency_s"] is not None), 0.99)


def _apply_deadline_factor(sup, args, seed_outcomes, deadline_s, tag):
    """--deadline-factor: the deadline from now on is the factor times
    the seed epoch's p99."""
    p99 = _seed_p99(seed_outcomes)
    if args.deadline_factor > 0 and p99:
        deadline_s = round(args.deadline_factor * p99, 3)
        sup.set_deadline(deadline_s)
        _log(f"[{tag}] deadline {deadline_s}s = {args.deadline_factor} x seed p99 {p99}s")
    return deadline_s, p99


def _audit_journals(root, failovers):
    """Every session that ever ACCEPTED a broadcast must be accounted: a
    terminal record in its own journal, or its journal adopted by a
    recovery (whose report settles every non-terminal session). Returns
    (lost sessions, scan counts)."""
    from .recovery import load_state

    recovered_dirs = {fo["journal_dir"] for fo in failovers if fo.get("recovery")}
    lost = []
    scanned = {"journals": 0, "sessions": 0, "broadcast_records": 0, "terminal_records": 0}
    for shard_dir in sorted(pathlib.Path(root).glob("shard*")):
        sessions, _coms = load_state(shard_dir)
        scanned["journals"] += 1
        scanned["sessions"] += len(sessions)
        for sid, js in sessions.items():
            scanned["broadcast_records"] += len(js.broadcasts)
            scanned["terminal_records"] += js.terminal is not None
            if js.broadcasts and js.terminal is None and str(shard_dir) not in recovered_dirs:
                lost.append(f"{shard_dir.name}:{sid}")
    return lost, scanned


def _stats_block(vals):
    return {
        "per_failover": vals,
        "mean": round(sum(vals) / len(vals), 3) if vals else None,
        "max": round(max(vals), 3) if vals else None,
    }


def _shard_traces(sup, trace_path: str) -> dict:
    """The shards' Chrome traces (each written at its clean stop; a
    SIGKILLed shard leaves none) copied beside `trace_path` as
    `<stem>.shardNN.json`, and each span name's seconds summed over
    them: the fleet's wall by stage."""
    import shutil

    base = pathlib.Path(trace_path)
    paths, seconds = [], {}
    for h in sup.shards:
        src = h.journal_dir / "trace.json"
        if not src.exists():
            continue
        dst = base.with_name(f"{base.stem}.shard{h.idx:02d}.json")
        shutil.copyfile(src, dst)
        paths.append(str(dst))
        for ev in json.loads(src.read_text())["traceEvents"]:
            if ev.get("ph") == "X":
                seconds[ev["name"]] = seconds.get(ev["name"], 0.0) + ev["dur"] / 1e6
    return {"paths": paths,
            "phase_seconds": {k: round(v, 4) for k, v in sorted(seconds.items())}}


def run_crash_storm(args) -> dict:
    """Poisson refresh arrivals over a multi-process ShardSupervisor
    while the `shard_kill` fault site SIGKILLs shards mid-window. Every
    submitted epoch is classified (done_clean / recovered after
    failover-replay-resubmit / aborted_transient / rejected / lost), and
    the report gates on zero lost accepted broadcasts, zero wrong
    verdicts and zero wedged sessions, with MTTR per failover and the
    healthy-bystander p99 (committees whose shard never died)."""
    import tempfile

    from . import faults
    from ..telemetry import export as tel_export
    from .supervisor import ShardSupervisor

    if args.kills is None:
        args.kills = 3  # the crash storm's whole point
    t_start = time.time()
    _start_trace(args)
    config = _config(args)
    rng = random.Random(args.seed)
    rate = args.rate or 1.0
    deadline_s = args.deadline or 8.0
    root = args.journal_root or tempfile.mkdtemp(prefix="fsdkr_storm_")

    # the kill schedule is seed-deterministic through the fault plan:
    # evenly spaced ticks across the window, each consulted against the
    # shard_kill site (rate 1.0, capped at --kills)
    plan = faults.configure(f"seed={args.seed},shard_kill=1.0,shard_kill_max={args.kills}")

    _log(f"[storm] keygen {args.bases} base committees (n={args.n}, t={args.t}, "
         f"{args.bits}-bit)")
    committees, keygen_s = _committees(args, config)
    _build_kernels(args.device)

    sup = ShardSupervisor(
        shards=args.shards, root=root, deadline_s=deadline_s,
        retries=args.retries if args.retries is not None else 2,
        hb_interval=0.3, device=args.device, trace=bool(args.trace),
    )
    t0 = time.time()
    sup.start()
    _log(f"[storm] {args.shards} shards ready in {time.time() - t0:.1f}s "
         f"(journals under {root})")
    try:
        for cid, keys in committees.items():
            sup.admit(cid, keys, config)
        epoch_of, seed_s, seed_outcomes = _seed_fleet(sup, committees, args, "storm")
        _log(f"[storm] seeded {len(seed_outcomes)} epochs in {seed_s:.1f}s")
        deadline_s, seed_p99 = _apply_deadline_factor(sup, args, seed_outcomes, deadline_s,
                                                      "storm")

        # ---- measured window: Poisson arrivals + the kill schedule -----
        kill_ticks = [(i + 1) * args.window / (args.kills + 1) for i in range(args.kills)]
        kills_done, killed_shards = 0, []
        t_win = time.monotonic()
        next_arrival = t_win
        while True:
            now = time.monotonic()
            if now - t_win >= args.window:
                break
            while kill_ticks and now - t_win >= kill_ticks[0]:
                tick = kill_ticks.pop(0)
                if plan.fire("shard_kill", (round(tick, 3),)):
                    # prefer a victim with sessions IN FLIGHT, then any
                    # committee owner; kill_shard refuses the last shard
                    alive = [h for h in sup.shards if h.alive]
                    busy_idx = {p["shard"] for p in sup.pending.values()}
                    busy = [h for h in alive if h.idx in busy_idx]
                    owners = [h for h in alive if h.committees]
                    victim = rng.choice(busy or owners or alive)
                    k = sup.kill_shard(victim.idx)
                    if k is not None:
                        kills_done += 1
                        killed_shards.append(k)
                        _log(f"[storm] t+{now - t_win:.1f}s SIGKILL shard {k}")
            if now >= next_arrival:
                next_arrival += rng.expovariate(rate)
                cid = rng.choice(list(committees))
                sup.submit(cid, epoch_of[cid])
                epoch_of[cid] += 1
            sup.pump(0.02)
        window_wall = time.monotonic() - t_win
        drained = sup.drain(timeout=args.drain_timeout)
        drain_wall = time.monotonic() - t_win - window_wall
        faults.reset()

        # ---- classification ------------------------------------------
        outcomes = list(sup.outcomes)
        agg = sup.aggregate()
        failovers = agg["failovers"]
        moved_cids = {c for fo in failovers for c in fo.get("moved", [])}
        cls = {"done_clean": 0, "recovered": 0, "aborted_transient": 0,
               "timed_out": 0, "rejected": 0, "aborted_blame": 0}
        wrong = []
        for o in outcomes:
            if o["state"] == "done":
                cls["recovered" if (o["via"] != "primary" or o["resubmits"])
                    else "done_clean"] += 1
            elif o["state"] == "rejected":
                cls["rejected"] += 1
            elif o["state"] == "timed_out":
                cls["timed_out"] += 1
            elif o["blame"]:
                # no tampering is injected in the storm: any blame is wrong
                cls["aborted_blame"] += 1
                wrong.append(f"{o['cid']}/{o['epoch']}: blamed: {o['error']}")
            else:
                cls["aborted_transient"] += 1
        wedged = len(sup.pending)
        lost_sessions, scanned = _audit_journals(root, failovers)
        mttrs = [fo["mttr_s"] for fo in failovers if fo.get("mttr_s")]
        recovers = [fo["recover_s"] for fo in failovers if fo.get("recover_s")]
        bystander_lat = sorted(
            o["latency_s"] for o in outcomes
            if o["state"] == "done" and o["via"] == "primary"
            and o["cid"] not in moved_cids and o["latency_s"] is not None
        )
        done_total = cls["done_clean"] + cls["recovered"]
        report = {
            "metric": "serve_crash_storm",
            "platform": f"{args.device}-shards",
            "device_info": device_info(args.device),
            "shard_devices": sorted({str(h.device) for h in sup.shards}),
            "committees": args.committees,
            "distinct_bases": args.bases,
            "n": args.n,
            "t": args.t,
            "paillier_bits": args.bits,
            "m_security": args.m_security,
            "correct_key_rounds": args.ck_rounds,
            "backend": args.backend,
            "shards": args.shards,
            "window_s": round(window_wall, 2),
            "drain_s": round(drain_wall, 2),
            "drained": drained,
            "offered_rate_hz": rate,
            "deadline_s": deadline_s,
            "seed_p99_s": seed_p99,
            "seed": args.seed,
            "fault_spec": plan.spec(),
            "kills_injected": kills_done,
            "killed_shards": killed_shards,
            "epochs_submitted": len(outcomes) + wedged,
            "outcomes": cls,
            "sessions_per_s": round(done_total / window_wall, 4) if window_wall > 0 else None,
            "wrong_verdicts": len(wrong),
            "wrong_detail": wrong[:8],
            "wedged": wedged,
            "wedged_detail": [f"{c}/{e}" for (c, e) in list(sup.pending)[:8]],
            "lost_broadcast_sessions": len(lost_sessions),
            "lost_detail": lost_sessions[:8],
            "journal_audit": scanned,
            "mttr_s": _stats_block(mttrs),
            # death detection -> journal replay adopted on the peer (the
            # floor every failover pays; MTTR adds the first interrupted
            # epoch completing)
            "recover_s": _stats_block(recovers),
            "bystander_p99_s": percentile(bystander_lat, 0.99),
            "bystander_done": len(bystander_lat),
            "failovers": failovers,
            "aggregate": {k: agg[k] for k in ("serving", "journal", "alive")},
            "setup": {
                "keygen_s": round(keygen_s, 1),
                "seed_s": round(seed_s, 1),
                "seed_epochs_done": sum(o["state"] == "done" for o in seed_outcomes),
            },
            "gates": {
                "zero_lost_broadcasts": len(lost_sessions) == 0,
                "zero_wrong_verdicts": len(wrong) == 0,
                "zero_wedged": wedged == 0,
                # the acceptance storm wants >= 3; a smaller --kills run
                # gates against its own configuration
                "kills_injected": kills_done >= min(3, args.kills),
            },
        }
        report["telemetry"] = tel_export.snapshot()
    finally:
        faults.reset()
        sup.stop()
    if args.trace:
        report["shard_traces"] = _shard_traces(sup, args.trace)
    _end_trace(args, report)
    out = _write_report(report, args.out or f"{OUT_DIR}/crash_storm.json")
    _log(f"[storm] {kills_done} kills, outcomes {cls}, MTTR mean {report['mttr_s']['mean']}s, "
         f"bystander p99 {report['bystander_p99_s']}s, lost {len(lost_sessions)}, "
         f"wrong {len(wrong)}, wedged {wedged}")
    _log(f"[storm] report -> {out} (total wall {time.time() - t_start:.0f}s)")
    return report


def _spawn_client(spec: dict):
    """One `--net-client` process of this module, from the repo root."""
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "fsdkr_tpu_torch.serving.loadgen", "--net-client"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=sys.stderr, text=True,
        cwd=str(pathlib.Path(__file__).resolve().parents[2]),
    )
    proc.stdin.write(json.dumps(spec) + "\n")
    proc.stdin.flush()
    lines: list = []
    threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
    return {"proc": proc, "lines": lines, "spec": spec}


def run_net_storm(args) -> dict:
    """Multi-process wire-protocol clients over TCP against an
    ingress-enabled ShardSupervisor, under the network fault sites
    (conn_drop / frame_truncate / net_delay / net_dup) armed in every
    shard and, with --kills, shard SIGKILLs. Gates: zero wrong verdicts
    (no tampering injected -> any blame is wrong), zero wedged sessions
    (client attempts exhausted), zero lost ACCEPTED broadcasts (every
    journal audited), the fleet quiesced, and the healthy-bystander p99
    under the stated bound. Also reports the networked sessions/s
    against the in-process (pipe-fed) baseline window."""
    import os
    import tempfile

    from . import faults
    from .supervisor import ShardSupervisor

    if args.kills is None:
        args.kills = 0  # kills compose with network chaos only by request
    t_start = time.time()
    _start_trace(args)
    config = _config(args)
    rng = random.Random(args.seed)
    rate = args.rate or 1.0
    deadline_s = args.deadline or 8.0
    root = args.journal_root or tempfile.mkdtemp(prefix="fsdkr_net_")
    net_spec = args.net_faults
    if net_spec is None:
        net_spec = f"{DEFAULT_NET_FAULTS},seed={args.seed}"
    kill_plan = None
    if args.kills > 0:
        kill_plan = faults.configure(
            f"seed={args.seed},shard_kill=1.0,shard_kill_max={args.kills}"
        )

    _log(f"[net] keygen {args.bases} base committees (n={args.n}, t={args.t}, "
         f"{args.bits}-bit)")
    committees, keygen_s = _committees(args, config)
    _build_kernels(args.device)

    # the shards carry the NETWORK fault plan: its sites act only at the
    # ingress, so the pipe-fed seed and baseline stay chaos-free
    sup = ShardSupervisor(
        shards=args.shards, root=root, deadline_s=deadline_s,
        retries=args.retries if args.retries is not None else 2,
        hb_interval=0.3, ingress=True, device=args.device,
        faults=net_spec or None, trace=bool(args.trace),
    )
    t0 = time.time()
    sup.start()
    clients = []
    try:
        ports = sup.ingress_ports()
        _log(f"[net] {args.shards} shards ready in {time.time() - t0:.1f}s, ingress ports "
             f"{ports} (journals under {root})")
        for cid, keys in committees.items():
            sup.admit(cid, keys, config)
        epoch_of, seed_s, seed_outcomes = _seed_fleet(sup, committees, args, "net")
        deadline_s, seed_p99 = _apply_deadline_factor(sup, args, seed_outcomes, deadline_s,
                                                      "net")

        # ---- in-process baseline window (pipe path, no sockets) --------
        bw = args.baseline_window or min(args.window, 20.0)
        _log(f"[net] in-process baseline window {bw:.0f}s at {rate}/s")
        t_base = time.monotonic()
        next_arrival = t_base
        while time.monotonic() - t_base < bw:
            now = time.monotonic()
            if now >= next_arrival:
                next_arrival += rng.expovariate(rate)
                cid = rng.choice(list(committees))
                sup.submit(cid, epoch_of[cid])
                epoch_of[cid] += 1
            sup.pump(0.02)
        base_window = time.monotonic() - t_base
        sup.drain(timeout=args.drain_timeout)
        base_outcomes = list(sup.outcomes)
        sup.outcomes.clear()
        base_lat = sorted(o["latency_s"] for o in base_outcomes
                          if o["state"] == "done" and o["latency_s"] is not None)
        baseline = {
            "window_s": round(base_window, 2),
            "sessions_done": len(base_lat),
            "sessions_per_s": round(len(base_lat) / base_window, 4),
            "p50": percentile(base_lat, 0.50),
            "p99": percentile(base_lat, 0.99),
        }
        _log(f"[net] baseline: {baseline['sessions_per_s']}/s, p99 {baseline['p99']}s "
             f"({len(base_lat)} done in-process)")

        # ---- the wire-protocol client processes ------------------------
        n_clients = max(1, args.clients)
        assignment = {i: [] for i in range(n_clients)}
        for j, cid in enumerate(sorted(committees)):
            assignment[j % n_clients].append(cid)
        for i in range(n_clients):
            clients.append(_spawn_client({
                "client_id": i,
                "ports": {str(k): v for k, v in ports.items()},
                "shards": args.shards,
                "committees": assignment[i],
                "epochs": [[c, epoch_of[c]] for c in assignment[i]],
                "rate_hz": rate / n_clients,
                "window_s": args.window,
                "deadline_s": deadline_s,
                "max_attempts": args.max_attempts,
                "seed": args.seed * 1000 + i,
            }))
        # start barrier: every client finished importing before the window
        spawn_deadline = time.monotonic() + 300
        for c in clients:
            while time.monotonic() < spawn_deadline:
                if any('"ready"' in ln for ln in c["lines"]):
                    break
                if c["proc"].poll() is not None:
                    raise RuntimeError(f"net client {c['spec']['client_id']} died at startup")
                time.sleep(0.1)
        for c in clients:
            c["proc"].stdin.write("go\n")
            c["proc"].stdin.flush()
        _log(f"[net] {n_clients} clients started; window {args.window:.0f}s"
             + (f" with {args.kills} shard kills" if args.kills else ""))

        # ---- measured window: pump heartbeats + the kill schedule ------
        kill_ticks = [(i + 1) * args.window / (args.kills + 1) for i in range(args.kills)]
        kills_done, killed_shards = 0, []
        t_win = time.monotonic()
        while any(c["proc"].poll() is None for c in clients):
            now = time.monotonic() - t_win
            while kill_plan and kill_ticks and now >= kill_ticks[0]:
                tick = kill_ticks.pop(0)
                if kill_plan.fire("shard_kill", (round(tick, 3),)):
                    alive = [h for h in sup.shards if h.alive]
                    owners = [h for h in alive if h.committees]
                    victim = rng.choice(owners or alive)
                    k = sup.kill_shard(victim.idx)
                    if k is not None:
                        kills_done += 1
                        killed_shards.append(k)
                        _log(f"[net] t+{now:.1f}s SIGKILL shard {k}")
            sup.pump(0.1)
            if now > args.window + deadline_s * (args.max_attempts + 1) + 180:
                _log("[net] WARNING: clients overran the window budget")
                break
        window_wall = time.monotonic() - t_win
        faults.reset()

        results = []
        for c in clients:
            try:
                c["proc"].wait(timeout=30)
            except subprocess.TimeoutExpired:
                c["proc"].kill()
                c["proc"].wait(timeout=30)
        time.sleep(0.5)  # let the stdout reader threads hit EOF
        for c in clients:
            for ln in c["lines"]:
                try:
                    obj = json.loads(ln)
                except ValueError:
                    continue
                if obj.get("ev") == "result":
                    results.append(obj)
        if len(results) != n_clients:
            _log(f"[net] WARNING: {n_clients - len(results)} clients returned no result")

        # let in-flight deadline reaps settle, then read the fleet's last
        # word from the ALIVE shards' heartbeats (a SIGKILLed shard's last
        # beat can freeze a nonzero inflight forever)
        def _alive_inflight():
            return sum((h.last_stats or {}).get("inflight", 0) for h in sup.shards if h.alive)

        quiesce_deadline = time.monotonic() + deadline_s + 15
        while time.monotonic() < quiesce_deadline:
            sup.pump(0.2)
            if _alive_inflight() == 0:
                break
        quiesced = _alive_inflight() == 0
        agg = sup.aggregate()

        # ---- classification ------------------------------------------
        outcomes = [o for r in results for o in r["outcomes"]]
        moved_cids = {c for fo in agg["failovers"] for c in fo.get("moved", [])}
        cls = {"done_clean": 0, "recovered": 0, "aborted_blame": 0,
               "aborted_transient": 0, "timed_out": 0, "unresolved": 0}
        wrong = []
        bystander_lat = []
        for o in outcomes:
            disturbed = (o["attempts"] > 1 or o["reconnects"] > 0
                         or o["redirects"] > 0 or o["cid"] in moved_cids)
            if o["state"] == "done":
                cls["recovered" if disturbed else "done_clean"] += 1
                if not disturbed:
                    bystander_lat.append(o["latency_s"])
            elif o["state"] == "aborted" and o["blame"]:
                # no tampering injected anywhere: blame is wrong
                cls["aborted_blame"] += 1
                wrong.append(f"{o['cid']}/{o['epoch']}: blamed: {o['error']}")
            elif o["state"] == "aborted":
                cls["aborted_transient"] += 1
            elif o["state"] == "timed_out":
                cls["timed_out"] += 1
            else:
                cls["unresolved"] += 1
        wedged = cls["unresolved"] + sum(int(r.get("threads_unjoined", 0)) for r in results)
        bystander_lat.sort()
        lost_sessions, scanned = _audit_journals(root, agg["failovers"])

        client_counters: dict = {}
        for r in results:
            for k, v in (r.get("counters") or {}).items():
                client_counters[k] = client_counters.get(k, 0) + v
        done_total = cls["done_clean"] + cls["recovered"]
        cores = os.cpu_count() or 1
        p99_by = percentile(bystander_lat, 0.99)
        bound_s = (round(deadline_s + args.p99_bound * baseline["p99"], 3)
                   if baseline["p99"] else None)
        # MTTR over the sockets: the failover's detection to the first
        # epoch of a moved committee that a client saw done after it
        mttrs = []
        for fo in agg["failovers"]:
            moved = set(fo.get("moved", []))
            ends = [o["end_unix"] for o in outcomes if o["cid"] in moved
                    and o["state"] == "done" and o["end_unix"] > fo["detected_wall"]]
            fo["mttr_s"] = round(min(ends) - fo["detected_wall"], 4) if ends else None
            if fo["mttr_s"] is not None:
                mttrs.append(fo["mttr_s"])
        recovers = [fo["recover_s"] for fo in agg["failovers"] if fo.get("recover_s")]
        report = {
            "metric": "serve_net_storm",
            "platform": f"{args.device}-shards-tcp",
            "device_info": device_info(args.device),
            "shard_devices": sorted({str(h.device) for h in sup.shards}),
            "committees": args.committees,
            "distinct_bases": args.bases,
            "n": args.n,
            "t": args.t,
            "paillier_bits": args.bits,
            "m_security": args.m_security,
            "correct_key_rounds": args.ck_rounds,
            "backend": args.backend,
            "shards": args.shards,
            "clients": n_clients,
            "window_s": args.window,
            "window_wall_s": round(window_wall, 2),
            "offered_rate_hz": rate,
            "deadline_s": deadline_s,
            "seed_p99_s": seed_p99,
            "seed": args.seed,
            "net_fault_spec": net_spec or None,
            "kill_fault_spec": kill_plan.spec() if kill_plan else None,
            "kills_injected": kills_done,
            "killed_shards": killed_shards,
            "epochs_submitted": len(outcomes),
            "outcomes": cls,
            "wrong_verdicts": len(wrong),
            "wrong_detail": wrong[:8],
            "wedged": wedged,
            "wedged_detail": [
                {k: o[k] for k in ("cid", "epoch", "attempts", "reconnects", "redirects",
                                   "latency_s", "error")}
                for o in outcomes if o["state"] == "unresolved"][:8],
            "lost_broadcast_sessions": len(lost_sessions),
            "lost_detail": lost_sessions[:8],
            "journal_audit": scanned,
            "client_counters": client_counters,
            "in_process_baseline": baseline,
            "net_sessions_per_s": round(done_total / window_wall, 4) if window_wall > 0
            else None,
            "net_sessions_per_s_per_core": round(done_total / window_wall / cores, 4)
            if window_wall > 0 else None,
            "in_process_sessions_per_s_per_core": round(baseline["sessions_per_s"] / cores, 4),
            "cores": cores,
            # over the sockets: detection to a moved committee's first
            # epoch done (the clients' wall clocks)
            "mttr_s": _stats_block(mttrs),
            "recover_s": _stats_block(recovers),
            "bystander_p99_s": p99_by,
            "bystander_done": len(bystander_lat),
            "p99_bound": args.p99_bound,
            "p99_bound_s": bound_s,
            "p99_bound_stated": "deadline_s + p99_bound * in_process_p99",
            "failovers": agg["failovers"],
            # serving/journal/ingress sums come from shard heartbeats and
            # client processes ONLY, never the parent's registry
            "aggregate": {k: agg[k] for k in ("serving", "journal", "ingress", "alive")},
            "aggregation": "shard heartbeats + client results; parent registry excluded",
            "setup": {"keygen_s": round(keygen_s, 1), "seed_s": round(seed_s, 1)},
            "knobs": {"max_attempts": args.max_attempts},
            "gates": {
                "zero_lost_broadcasts": len(lost_sessions) == 0,
                "zero_wrong_verdicts": len(wrong) == 0,
                "zero_wedged": wedged == 0,
                "fleet_quiesced": quiesced,
                "p99_within_bound": (
                    p99_by is not None and bound_s is not None and p99_by <= bound_s
                ) or not bystander_lat,
                "kills_injected": kills_done >= min(3, args.kills),
            },
        }
    finally:
        faults.reset()
        for c in clients:
            if c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait(timeout=30)
        sup.stop()
    if args.trace:
        report["shard_traces"] = _shard_traces(sup, args.trace)
    _end_trace(args, report)
    out = _write_report(report, args.out or f"{OUT_DIR}/net_storm.json")
    _log(f"[net] outcomes {cls} | wrong {len(wrong)} | wedged {wedged} | lost "
         f"{len(lost_sessions)} | bystander p99 {p99_by}s (bound {bound_s}s) | net "
         f"{report['net_sessions_per_s']}/s vs in-process {baseline['sessions_per_s']}/s")
    _log(f"[net] report -> {out} (total wall {time.time() - t_start:.0f}s)")
    return report


# ---------------------------------------------------------------------------
# the in-process window


def _dry_by_cause():
    """The cause-labeled dry counter summed over pool kinds:
    {'real': n, 'injected': m}."""
    from ..telemetry import registry

    out: dict = {}
    m = registry.get_registry().get("fsdkr_pool_dry")
    if m is None:
        return out
    for rec in m.snapshot_values():
        cause = rec["labels"].get("cause", "?")
        out[cause] = out.get(cause, 0) + int(rec["value"])
    return out


def _mem_block() -> dict:
    """The memory plan's `fsdkr_mem_*` metrics, read from the registry
    (the serving layer does not import the backend)."""
    from ..telemetry import registry

    out = {}
    for m in registry.get_registry().metrics():
        if m.name.startswith("fsdkr_mem_"):
            out[m.name[len("fsdkr_mem_"):]] = m.snapshot_values()
    return out


def run_service_window(args) -> dict:
    """The default sustained window, or with --chaos the chaos report
    and the tamper curve, on one in-process RefreshService."""
    from .. import precompute
    from ..telemetry import export as tel_export
    from . import faults
    from . import metrics as smetrics
    from .planner import SLO
    from .policy import BisectGuard, OverloadPolicy
    from .service import RefreshService, ServeRejected

    t_start = time.time()
    tag = args.tag or ("storm" if args.chaos else "sustained")
    _start_trace(args)
    config = _config(args)
    rng = random.Random(args.seed)

    # ---- phase 1: committees -------------------------------------------
    _log(f"[loadgen] keygen {args.bases} base committees (n={args.n}, t={args.t}, "
         f"{args.bits}-bit)")
    committees, keygen_s = _committees(args, config)
    _log(f"[loadgen] keygen {keygen_s:.1f}s; admitting {args.committees} committees")

    deadline_s = args.deadline
    if args.chaos and deadline_s <= 0:
        deadline_s = 15.0
    retries = args.retries if args.retries is not None else 2
    if args.chaos:
        # chaos admission control lives in the SERVICE (explicit rejected
        # outcomes with retry-after), not the inline backlog check
        svc = RefreshService(
            deadline_s=deadline_s, retries=retries,
            overload=OverloadPolicy(max_queue=args.max_backlog, shed_p99_factor=0.0),
            guard=BisectGuard(budget=args.bisect_budget),
            journal=args.journal_dir, device=args.device,
        )
    else:
        svc = RefreshService(deadline_s=deadline_s, retries=retries, journal=args.journal_dir,
                             device=args.device)
    # per-committee rate: the offered total spread uniformly
    per_rate = (args.rate or 1.0) / max(1, args.committees)
    for cid, keys in committees.items():
        svc.admit(cid, keys, config, SLO(arrival_rate_hz=per_rate))
    svc.start()
    try:
        # ---- phase 2: seed epochs --------------------------------------
        t0 = time.time()
        for _epoch in range(args.seed_epochs):
            for cid in committees:
                # seeding is closed-loop setup: wait out a rejection
                while True:
                    try:
                        svc.submit(cid)
                        break
                    except ServeRejected as e:
                        time.sleep(min(1.0, e.retry_after_s))
            if not svc.drain(timeout=max(args.drain_timeout, 12 * args.committees)):
                _log("[loadgen] WARNING: seed epoch did not drain; continuing")
        seed_s = time.time() - t0
        seed_done = svc.stats()["sessions_done"]
        _log(f"[loadgen] seeded {seed_done} sessions in {seed_s:.1f}s "
             f"({seed_done / seed_s:.2f}/s single-stream)")

        # auto rate: ~70% of the calibrated closed-loop capacity, so the
        # producer has idle time to keep the pools at depth
        rate = args.rate
        if rate <= 0:
            rate = max(0.1, 0.7 * seed_done / seed_s) if seed_s > 0 else 1.0
            _log(f"[loadgen] auto rate: {rate:.2f} sessions/s")

        # ---- phase 3: prefill wait -------------------------------------
        t0 = time.time()
        precompute.kick()
        deficit0 = precompute.deficit_total()
        while time.time() - t0 < args.prefill_wait:
            if precompute.deficit_total() == 0:
                break
            time.sleep(0.25)
        prefill_s = time.time() - t0
        deficit_left = precompute.deficit_total()
        _log(f"[loadgen] prefill {prefill_s:.1f}s (deficit {deficit0} -> {deficit_left})")

        # ---- phase 3b (chaos): fault-free baseline window --------------
        baseline = None
        fault_plan = None
        if args.chaos:
            bw = args.baseline_window or min(args.window, 20.0)
            _log(f"[loadgen] chaos baseline window {bw:.0f}s (no faults)")
            ids, _shed, _rej, bwall, bdrained, _bd, _t0 = run_window(
                svc, list(committees), rng, rate, bw, args.max_backlog,
                args.drain_timeout, backlog_shed_inline=False,
            )
            bsessions, bwedged = collect_sessions(svc, ids)
            blat = sorted(s.finalized_at - s.submitted_at for s in bsessions
                          if s.state == "done")
            baseline = {
                "window_s": round(bwall, 2),
                "sessions_done": len(blat),
                "drained": bdrained,
                "wedged": bwedged,
                "p50": percentile(blat, 0.50),
                "p99": percentile(blat, 0.99),
            }
            _log(f"[loadgen] baseline p99 {baseline['p99']}s ({len(blat)} sessions)")
            fault_plan = faults.configure(args.faults or f"{DEFAULT_FAULTS},seed={args.seed}")
            _log(f"[loadgen] fault plan armed: {fault_plan.spec()}")

        # ---- phase 4: measured window ----------------------------------
        smetrics.phase_histogram().reset()
        smetrics.sessions_counter().reset()
        smetrics.batch_histogram().reset()
        pool0 = precompute.precompute_stats()
        dry0 = _dry_by_cause()
        rejected0 = svc.sessions_rejected
        win_ids, shed, rejected, window_s, drained, drain_s, t_win = run_window(
            svc, list(committees), rng, rate, args.window, args.max_backlog,
            args.drain_timeout, backlog_shed_inline=not args.chaos,
        )
        pool1 = precompute.precompute_stats()
        dry1 = _dry_by_cause()

        sessions, wedged = collect_sessions(svc, win_ids)
        done = [s for s in sessions if s.state == "done"]
        aborted = [s for s in sessions if s.state == "aborted"]
        timed_out = [s for s in sessions if s.state == "timed_out"]
        # completed-inside-window throughput (the sustained figure) and
        # the drain-inclusive one
        done_in_window = [s for s in done if s.finalized_at - t_win <= args.window]
        lat = sorted(s.finalized_at - s.submitted_at for s in done)
        consumed = pool1["consumed"] - pool0["consumed"]
        dry = pool1["dry_fallbacks"] - pool0["dry_fallbacks"]
        takes = consumed + dry

        prod = {}
        for rec in tel_export.snapshot()["metrics"].get(
                "fsdkr_producer_occupancy", {}).get("values", []):
            prod["occupancy"] = round(rec["value"], 4)

        report = {
            "metric": "serve_chaos" if args.chaos else "serve_sustained",
            "platform": args.device,
            "device_info": device_info(args.device),
            "committees": args.committees,
            "distinct_bases": args.bases,
            "n": args.n,
            "t": args.t,
            "paillier_bits": args.bits,
            "m_security": args.m_security,
            "correct_key_rounds": args.ck_rounds,
            "backend": args.backend,
            "window_s": round(window_s, 2),
            "drain_s": round(drain_s, 2),
            "drained": drained,
            "offered_rate_hz": round(rate, 4),
            "arrivals": len(win_ids),
            "shed": shed,
            "rejected": rejected,
            "sessions_done": len(done),
            "sessions_done_in_window": len(done_in_window),
            "sessions_aborted": len(aborted),
            "sessions_timed_out": len(timed_out),
            "sessions_wedged": wedged,
            "abort_errors": sorted({s.error for s in aborted if s.error})[:5],
            "sessions_per_s": round(len(done_in_window) / window_s, 4),
            "sessions_per_s_incl_drain": (
                round(len(done) / (window_s + drain_s), 4) if window_s + drain_s > 0 else None
            ),
            "latency_s": {
                "p50": percentile(lat, 0.50),
                "p95": percentile(lat, 0.95),
                "p99": percentile(lat, 0.99),
                "mean": round(sum(lat) / len(lat), 4) if lat else None,
                "max": round(lat[-1], 4) if lat else None,
            },
            "pool": {
                "consumed": consumed,
                "dry_fallbacks": dry,
                "dry_fallback_rate": round(dry / takes, 4) if takes else None,
                "dry_by_cause": {k: dry1.get(k, 0) - dry0.get(k, 0)
                                 for k in set(dry0) | set(dry1)},
                "produced": pool1["produced"] - pool0["produced"],
                "bytes_pooled": pool1["bytes_pooled"],
                "entries_pooled": pool1["entries"],
                "pools": pool1["pools"],
                "prefill_deficit_left": deficit_left,
            },
            "producer": prod,
            "mem": _mem_block(),
            "journal": svc.journal_stats(),
            "setup": {
                "keygen_s": round(keygen_s, 1),
                "seed_epochs": args.seed_epochs,
                "seed_s": round(seed_s, 1),
                "seed_sessions_per_s": round(seed_done / seed_s, 3) if seed_s > 0 else None,
                "prefill_s": round(prefill_s, 1),
            },
            "knobs": {
                "batch_max_sessions": svc.policy.max_sessions,
                "batch_linger_ms": round(svc.policy.linger_s * 1000, 1),
                "workers": svc.workers,
                "planner_horizon_s": svc.planner.horizon_s,
                "planner_max_ahead": svc.planner.max_ahead,
                "deadline_s": svc.deadline_s,
                "retries": svc.retries,
                "max_backlog": args.max_backlog,
            },
        }

        # ---- chaos accounting + tamper-economics curve -----------------
        if args.chaos:
            outcomes = classify_chaos(sessions)
            injected = fault_plan.injected()
            faults.reset()
            # the p99 gate reads HEALTHY traffic: sessions no DISRUPTIVE
            # fault hit and that completed first try — what injection
            # costs bystanders, not what the faulted sessions paid
            disruptive = ("worker_crash", "finalize_exc", "msg_delay", "msg_drop",
                          "msg_tamper")
            healthy_lat = sorted(
                s.finalized_at - s.submitted_at for s in done
                if s.retries == 0
                and not any(f.startswith(d) for f in s.faults for d in disruptive)
            )
            p99_healthy = percentile(healthy_lat, 0.99)
            p99_base = baseline["p99"] if baseline else None
            ratio = (round(p99_healthy / p99_base, 3)
                     if p99_healthy and p99_base and p99_base > 0 else None)
            # the STATED bound: one in-flight session a committee means a
            # healthy arrival inherits at most ONE doomed sibling's
            # deadline of queue wait, plus bounded service
            bound_s = round(deadline_s + args.p99_bound * p99_base, 3) if p99_base else None
            report["chaos"] = {
                "fault_spec": fault_plan.spec(),
                "injected": injected,
                "injected_classes": sorted(injected),
                "outcomes": outcomes,
                "wedged": wedged,
                "wrong_verdicts": outcomes["wrong_verdicts"],
                "service_rejected_total": svc.sessions_rejected - rejected0,
                "workers_respawned": svc.stats()["workers_respawned"],
                "baseline": baseline,
                "healthy_done": len(healthy_lat),
                "p99_healthy_done_s": p99_healthy,
                "p99_all_done_s": report["latency_s"]["p99"],
                "p99_vs_baseline": ratio,
                "p99_bound": args.p99_bound,
                "p99_bound_s": bound_s,
                "p99_bound_stated": "deadline_s + p99_bound * baseline_p99",
                "p99_within_bound": (p99_healthy is not None and bound_s is not None
                                     and p99_healthy <= bound_s),
            }
            rates = [float(x) for x in args.curve.split(",") if x.strip()] if args.curve else []
            if rates:
                report["chaos"]["tamper_curve"] = run_tamper_curve(
                    svc, list(committees), rates, args.curve_sessions, args.seed,
                    args.drain_timeout,
                )
        report["telemetry"] = tel_export.snapshot()
    finally:
        faults.reset()
        svc.stop()
        precompute.stop_background()
    _end_trace(args, report)
    prefix = "chaos" if args.chaos else "serving"
    out = _write_report(report, args.out or f"{OUT_DIR}/{prefix}_{tag}.json")
    _log(f"[loadgen] report -> {out} (total wall {time.time() - t_start:.0f}s)")
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.net_client:
        return run_net_client()
    if args.net:
        report = run_net_storm(args)
    elif args.crash_storm:
        report = run_crash_storm(args)
    else:
        report = run_service_window(args)
    print(json.dumps(report, default=str))
    return 0 if all(report.get("gates", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
