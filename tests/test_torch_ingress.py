"""The port's TCP ingress (fsdkr_tpu_torch/serving/ingress.py) and its
per-peer rate limiter against the JAX package's, at TEST_CONFIG widths.

- Framing: `encode_frame` gives the JAX package's bytes; `_parse_frames`
  the same frames and the same `FrameError` causes on the same partial
  and defective buffers; the client's rid dedup and state bound.
- `PeerRateLimiter`: the same admit/shed/close sequence under one
  injected clock.
- A socket epoch (one committee, n=3, backend "host", one worker, the
  shared samplers of tests/_torch_samplers.py) through each package's
  IngressServer with its IngressClient as the broadcast channel, an
  honest epoch and one whose sender 2 is tampered on the wire: the same
  verdicts, blame and error texts, journal segments byte for byte,
  adopted LocalKeys (`to_fields`) and `fsdkr_ingress_*` changes.
- Hostile bytes: seeded mutations of a valid request stream and a fixed
  set of defective frames close connections with the same causes, and a
  bystander's connection lives on.
- The network fault sites (`conn_drop`, `frame_truncate`, `net_dup`,
  `net_delay` under a drain) and redirect, backpressure, idle and
  slow-loris give the JAX package's outcomes.
- One socket epoch on the cuda backend's plain versions (device="cpu",
  n=2) adopts the keys the JAX package's socket epoch adopts.

Only sessions meant to time out get short deadlines; healthy sessions
get minutes.
"""

import copy
import dataclasses
import random
import socket
import struct
import threading
import time
import zlib
from types import SimpleNamespace

import pytest

from _torch_samplers import JAX, PORT, canned_material, install_samplers
from fsdkr_tpu import precompute as j_precompute
from fsdkr_tpu import serving as j_serving
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.protocol import serialization as j_serialization
from fsdkr_tpu.serving import faults as j_faults
from fsdkr_tpu.serving import ingress as j_ingress
from fsdkr_tpu.serving import metrics as j_metrics
from fsdkr_tpu.serving import policy as j_policy

from fsdkr_tpu_torch import TEST_CONFIG, precompute, serving
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.protocol import serialization
from fsdkr_tpu_torch.serving import faults, ingress, metrics, policy

HOST = dataclasses.replace(TEST_CONFIG, backend="host")
CANNED = 12  # key bundles: two epochs of three, and the pools' runway

PKGS = {
    "jax": SimpleNamespace(serving=j_serving, ingress=j_ingress, metrics=j_metrics,
                           faults=j_faults, ser=j_serialization, svc_kw={}),
    "port": SimpleNamespace(serving=serving, ingress=ingress, metrics=metrics,
                            faults=faults, ser=serialization, svc_kw={"device": "cpu"}),
}


def _clear_both():
    for pc in (precompute, j_precompute):
        pc.clear_pools()
        pc.clear_targets()
    faults.reset()
    j_faults.reset()


@pytest.fixture(autouse=True)
def _clean():
    _clear_both()
    yield
    _clear_both()


@pytest.fixture(scope="module")
def committee3():
    return jax_keygen(1, 3, JAX_CONFIG)


@pytest.fixture(scope="module")
def committee2():
    return jax_keygen(1, 2, JAX_CONFIG)


@pytest.fixture(scope="module")
def canned():
    return canned_material(JAX_CONFIG, CANNED)


@pytest.fixture
def samplers(monkeypatch, canned):
    jreset = install_samplers(monkeypatch, JAX, canned["jax"], JAX_CONFIG.paillier_bits)
    preset = install_samplers(monkeypatch, PORT, canned["port"], TEST_CONFIG.paillier_bits)
    return jreset, preset


def _service(pkg, **kw):
    ns = PKGS[pkg]
    return ns.serving.RefreshService(**ns.svc_kw, **kw)


def _wait(pred, timeout=20.0, what="condition"):
    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.02)


def _snap(pkg):
    return PKGS[pkg].metrics.ingress_snapshot()


def _delta(after, before):
    out = {}
    for key, v in after.items():
        if isinstance(v, dict):
            d = {k: x - before.get(key, {}).get(k, 0) for k, x in v.items()}
            d = {k: x for k, x in d.items() if x}
            if d:
                out[key] = d
        elif key != "open_connections" and v != before.get(key, 0):
            out[key] = v - before.get(key, 0)
    return out


def _quiet(srv):
    """Every connection of `srv` has been torn down (its own set: a
    server of an earlier test in this process may have left its gauge
    above 0 when its loop stopped)."""
    _wait(lambda: not srv.conns, what="connections closed")


# ---------------------------------------------------------------------------
# framing


FRAMES = [
    {"op": "ping", "rid": 1},
    {"op": "submit", "cid": "c1", "epoch": 3, "rid": 2},
    {"type": "terminal", "sid": 7, "state": "done", "blame": False, "error": None,
     "latency_s": 1.2345, "rid": 9},
    {"op": "broadcast", "sid": 1, "wire": "{\"x\": [1, 2]}" * 40, "rid": 4},
    {"type": "stats", "k": (1, 2), "nested": {"a": {"b": [None, True]}}},
    {"text": "caf\u00e9 \"q\"", "small": 3.5e-7},
]


@pytest.mark.parametrize("obj", FRAMES, ids=range(len(FRAMES)))
def test_encode_frame_bytes_match_jax(obj):
    assert ingress.encode_frame(obj) == j_ingress.encode_frame(obj)
    assert ingress.FRAME_HEADER.size == j_ingress.FRAME_HEADER.size == 8


def _parse(mod, buf, cap=1 << 20):
    """(frames, remaining bytes) or ("error", cause, remaining bytes)."""
    b = bytearray(buf)
    try:
        return ([o for o, _n in mod._parse_frames(b, cap)], bytes(b))
    except mod.FrameError as e:
        return ("error", e.cause, bytes(b))


def _crc_frame(payload):
    return struct.pack("<II", len(payload), zlib.crc32(payload)) + payload


_OK = j_ingress.encode_frame({"op": "ping"})
_BAD_CRC = bytearray(_OK)
_BAD_CRC[-1] ^= 0xFF
BUFFERS = {
    "whole": b"".join(j_ingress.encode_frame(o) for o in FRAMES),
    "tail": _OK + _OK[:-2],
    "header_only": _OK[:5],
    "oversize": struct.pack("<II", 1 << 30, 0),
    "oversize_after_one": _OK + struct.pack("<II", (1 << 20) + 1, 0),
    "crc": bytes(_BAD_CRC),
    "not_json": _crc_frame(b"\x00not-json"),
    "not_object": _crc_frame(b"[1,2,3]"),
    "empty": b"",
}


@pytest.mark.parametrize("name", list(BUFFERS))
def test_parse_frames_match_jax(name):
    buf = BUFFERS[name]
    got = _parse(ingress, buf)
    assert got == _parse(j_ingress, buf)
    if name in ("oversize", "crc", "not_json", "not_object"):
        assert got[0] == "error"


def test_parse_frames_byte_at_a_time_match_jax():
    blob = BUFFERS["whole"]
    seen = {}
    for mod in (ingress, j_ingress):
        buf, out = bytearray(), []
        for b in blob:
            buf.append(b)
            out.append([o for o, _n in mod._parse_frames(buf, 1 << 20)])
        seen[mod] = out
    assert seen[ingress] == seen[j_ingress]
    assert sum(seen[ingress], []) == FRAMES[:4] + [
        {"type": "stats", "k": [1, 2], "nested": {"a": {"b": [None, True]}}}, FRAMES[5]]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_client_same_batch_dup_not_parked_and_state_bounded(pkg):
    """A net_dup copy of the awaited rid in the same parse batch is
    dropped, not parked; the dup-tracking state stays bounded; a parked
    response whose rid is still outstanding is handed back."""
    mod = PKGS[pkg].ingress
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    cli = mod.IngressClient("127.0.0.1", lsock.getsockname()[1], timeout=1)
    try:
        cli._rid = 1
        frame = mod.encode_frame({"type": "pong", "rid": 1})
        cli._buf += frame + frame
        assert cli.recv(1, timeout=1)["type"] == "pong"
        assert not cli._pending
        cli._done_rids.update(range(1, 5000))
        cli._pending.update({r: {} for r in range(2, 50)})
        cli._rid = 5000
        cli._buf += mod.encode_frame({"type": "pong", "rid": 5000})
        assert cli.recv(5000, timeout=1)["type"] == "pong"
        assert len(cli._done_rids) == 1 and not cli._pending
        cli._rid = 9000
        cli._outstanding.add(20)
        cli._pending[20] = {"type": "pong", "rid": 20}
        assert cli.recv(20, timeout=1)["type"] == "pong"
        assert 20 not in cli._pending and not cli._outstanding
    finally:
        cli.close()
        lsock.close()


# ---------------------------------------------------------------------------
# the per-peer rate limiter


def _limiter_trace(make):
    """One scripted drive: (op, peer, time) -> verdicts."""
    now = [100.0]
    lim = make(lambda: now[0])
    script = (
        [("charge", "a", 0.0)] * 3 + [("charge", "a", 0.0)] * 4 + [("charge", "b", 0.0)]
        + [("charge", "a", 10.0)] * 2 + [("forget", "a", 10.0), ("charge", "a", 10.0)]
        + [("forget", "a", 20.0), ("charge", "a", 20.0)]
        + [("charge", "c", 20.0 + 0.1 * k) for k in range(30)]
        + [("charge", f"p{k}", 30.0) for k in range(520)]
        + [("charge", "a", 40.0), ("forget", "b", 40.0), ("charge", "b", 40.0)]
    )
    out = []
    for op, peer, t in script:
        now[0] = 100.0 + t
        out.append(lim.charge(peer) if op == "charge" else lim.forget(peer))
    return out, len(lim._buckets)


@pytest.mark.parametrize("rps,burst", [(2.0, 2.0), (1.0, None), (5.0, 1.0), (0.0, None)])
def test_peer_rate_limiter_sequence_matches_jax(rps, burst):
    def port(clock):
        return policy.PeerRateLimiter(rps=rps, burst=burst, clock=clock)

    def jax(clock):
        lim = j_policy.PeerRateLimiter(rps=rps, burst=burst)
        charge, forget = lim.charge, lim.forget
        lim.charge = lambda peer: charge(peer, clock())
        lim.forget = lambda peer: forget(peer, clock())
        return lim

    got = _limiter_trace(port)
    assert got == _limiter_trace(jax)
    if rps:
        assert -1.0 in got[0] and any(isinstance(v, float) and v > 0 for v in got[0])
    else:
        assert set(got[0]) == {None}


# ---------------------------------------------------------------------------
# socket epochs


def _epochs(pkg, keys, config, jdir, epochs):
    """Drive `epochs` [(epoch, tampered sender or None)] of one committee
    over `pkg`'s socket path. Returns ([per-epoch outcome], every
    response received, the ingress counters' change)."""
    ns = PKGS[pkg]
    svc = _service(pkg, workers=1, journal=str(jdir), deadline_s=600.0)
    svc.admit("c1", keys, config)
    svc.start()
    srv = ns.ingress.IngressServer(svc).start()
    _quiet(srv)
    before = _snap(pkg)
    cli = ns.ingress.IngressClient("127.0.0.1", srv.port, timeout=600)
    out, responses = [], []
    try:
        for epoch, tamper in epochs:
            if pkg == "port":
                _wait(lambda: not precompute.deficit_total(), 120, "the producer's fill")
            r = cli.submit("c1", epoch=epoch, timeout=600)
            responses.append(r)
            assert r["type"] == "submitted", r
            bcasts = r.get("broadcasts")
            if bcasts is None:
                got = cli.fetch(r["sid"])
                responses.append(got)
                bcasts = got["broadcasts"]
            acks = []
            for snd, wire in bcasts:
                if snd == tamper:
                    msg = ns.faults.tamper_message(ns.ser.refresh_message_from_json(wire))
                    responses.append(cli.broadcast(r["sid"], ns.ser.refresh_message_to_json(msg)))
                    acks.append(responses[-1]["result"])
                responses.append(cli.broadcast(r["sid"], wire))
                acks.append(responses[-1]["result"])
            term = cli.wait(r["sid"], 600)
            responses.append(term)
            out.append((r["sid"], r["state"], r["senders"], acks, term["type"],
                        term["state"], term["blame"], term["error"], term["retries"]))
    finally:
        cli.close()
        _quiet(srv)
        after = _snap(pkg)
        srv.stop()
        svc.stop()
    return out, responses, _delta(after, before)


def _segments(jdir):
    return [p.read_bytes() for p in sorted(jdir.glob("wal-*.seg"))]


def test_socket_epochs_match_jax(samplers, committee3, tmp_path):
    jreset, preset = samplers
    epochs = ((1, None), (2, 2))
    jreset()
    jkeys = copy.deepcopy(committee3)
    want, jresp, jcounts = _epochs("jax", jkeys, JAX_CONFIG, tmp_path / "jax", epochs)
    preset()
    _clear_both()
    pkeys = from_reference(committee3)
    got, presp, pcounts = _epochs("port", pkeys, HOST, tmp_path / "port", epochs)

    assert [w[5:7] for w in want] == [("done", False), ("aborted", True)]
    assert want[1][3] == ["accepted", "accepted", "duplicate", "accepted"]
    assert want[1][7].startswith("PDLwSlackProofError")
    assert got == want
    assert [to_fields(k) for k in pkeys] == [to_fields(from_reference(k)) for k in jkeys]
    assert _segments(tmp_path / "port") == _segments(tmp_path / "jax")
    # the counters: the same frames and inbound bytes; the outbound
    # bytes are the responses each client received (the terminal
    # frames' latency differs between the runs)
    out_j, out_p = jcounts["bytes"].pop("out"), pcounts["bytes"].pop("out")
    assert pcounts == jcounts
    assert pcounts["frames"] == {"in": len(presp), "out": len(presp)}
    assert pcounts["connections"] == {"closed": 1}
    assert out_p == sum(len(ingress.encode_frame(r)) for r in presp)
    assert out_j == sum(len(j_ingress.encode_frame(r)) for r in jresp)


def test_socket_epoch_on_the_plain_versions_matches_jax(samplers, committee2, tmp_path):
    """backend "cuda" on device "cpu": the kernels' plain versions."""
    import torch

    jreset, preset = samplers
    jreset()
    jkeys = copy.deepcopy(committee2)
    want, _, _ = _epochs("jax", jkeys, JAX_CONFIG, tmp_path / "jax", ((1, None),))
    preset()
    _clear_both()
    pkeys = from_reference(committee2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got, _, _ = _epochs("port", pkeys, TEST_CONFIG, tmp_path / "port", ((1, None),))
    finally:
        torch.set_num_threads(threads)
    assert got == want and want[0][5:7] == ("done", False)
    assert [to_fields(k) for k in pkeys] == [to_fields(from_reference(k)) for k in jkeys]


# ---------------------------------------------------------------------------
# hostile bytes


def _hostile(port, blob):
    """Send `blob` and half-close: the server parses every byte, then
    sees EOF. Waits for the server's close."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        try:
            s.sendall(blob)
            s.shutdown(socket.SHUT_WR)
        except OSError:
            return  # closed mid-send
        s.settimeout(10)
        while True:
            try:
                if not s.recv(1 << 16):
                    return
            except OSError:
                return
    finally:
        s.close()


def _mutations(seed, count):
    rng = random.Random(seed)
    base = j_ingress.encode_frame({"op": "ping", "rid": 1}) + j_ingress.encode_frame(
        {"op": "exec", "rid": 2})
    out = []
    for _ in range(count):
        blob = bytearray(base)
        for _k in range(rng.randint(1, 6)):
            mode = rng.randrange(3)
            if mode == 0 and blob:
                blob[rng.randrange(len(blob))] ^= 1 << rng.randrange(8)
            elif mode == 1 and blob:
                del blob[rng.randrange(len(blob)):]
            else:
                blob += rng.randbytes(rng.randint(1, 32))
        out.append(bytes(blob))
    return out


def _hostile_run(pkg, blobs):
    ns = PKGS[pkg]
    svc = _service(pkg)
    srv = ns.ingress.IngressServer(svc).start()
    _quiet(srv)
    before = _snap(pkg)
    cli = ns.ingress.IngressClient("127.0.0.1", srv.port, timeout=10)
    alive = []
    try:
        for blob in blobs:
            _hostile(srv.port, blob)
            alive.append(cli.ping()["type"])
        cli.close()
        _quiet(srv)
        delta = _delta(_snap(pkg), before)
    finally:
        srv.stop()
    # responses to the frames that parsed race the half-close: not compared
    delta["frames"].pop("out", None)
    delta["bytes"].pop("out", None)
    return alive, delta


def test_seeded_mutations_close_with_the_same_causes():
    blobs = _mutations(99, 60)
    got = _hostile_run("port", blobs)
    assert got == _hostile_run("jax", blobs)
    alive, delta = got
    assert set(alive) == {"pong"}
    assert sum(delta["frames_rejected"].values()) >= 20


def test_defective_frames_close_only_their_connection():
    bad = bytearray(j_ingress.encode_frame({"op": "ping", "rid": 9}))
    bad[-1] ^= 0x5A
    blobs = [
        random.Random(1234).randbytes(512),
        struct.pack("<II", 1 << 31, 7),
        _crc_frame(b"\xff\xfe garbage payload"),
        _crc_frame(b"[1, 2, 3]"),
        _crc_frame(b'{"op": "exec", "rid": 1}'),
        bytes(bad),
        j_ingress.encode_frame({"op": "ping"})[:-3],
    ]
    got = _hostile_run("port", blobs)
    assert got == _hostile_run("jax", blobs)
    alive, delta = got
    assert alive == ["pong"] * len(blobs)
    for cause in ("oversize", "malformed", "bad_op", "crc"):
        assert delta["frames_rejected"].get(cause, 0) >= 1, delta


# ---------------------------------------------------------------------------
# fault sites, redirect, backpressure, hygiene, drain


def _pings(ns, port, count, timeout=5):
    """`count` pings, each on a fresh connection: the response type or
    "ConnectionError"."""
    out = []
    for _ in range(count):
        cli = ns.ingress.IngressClient("127.0.0.1", port, timeout=timeout)
        try:
            out.append(cli.ping()["type"])
        except ConnectionError:
            out.append("ConnectionError")
        finally:
            cli.close()
    return out


def scenario_conn_drop(pkg, ns, srv):
    plan = ns.faults.configure("seed=3,conn_drop=1.0,conn_drop_max=1")
    return _pings(ns, srv.port, 3), plan.injected()


def scenario_frame_truncate(pkg, ns, srv):
    plan = ns.faults.configure("seed=3,frame_truncate=1.0,frame_truncate_max=1")
    return _pings(ns, srv.port, 3), plan.injected()


def scenario_net_dup(pkg, ns, srv):
    plan = ns.faults.configure("seed=5,net_dup=1.0")
    cli = ns.ingress.IngressClient("127.0.0.1", srv.port, timeout=10)
    try:
        got = [cli.ping()["type"] for _ in range(4)]
        parked = dict(cli._pending)
    finally:
        cli.close()
    return got, parked, plan.injected()


def scenario_net_delay_drain(pkg, ns, srv):
    """A response held by net_delay is in flight when stop() drains: it
    is still answered, then the listener is gone."""
    plan = ns.faults.configure("seed=6,net_delay=1.0,net_delay_max=1,delay_s=0.5")
    cli = ns.ingress.IngressClient("127.0.0.1", srv.port, timeout=30)
    try:
        rid = cli.send({"op": "ping"})
        time.sleep(0.1)
        stopper = threading.Thread(target=srv.stop, args=(10.0,))
        stopper.start()
        got = cli.recv(rid, timeout=30)["type"]
        stopper.join(timeout=20)
        try:
            socket.create_connection(("127.0.0.1", srv.port), timeout=2).close()
            refused = False
        except OSError:
            refused = True
    finally:
        cli.close()
    return got, refused, srv.draining, plan.injected()


def scenario_redirect(pkg, ns, srv):
    srv.router = lambda cid: ({"ports": {"0": 12345, "1": 23456}, "hint": 23456}
                              if cid != "mine" else None)
    cli = ns.ingress.IngressClient("127.0.0.1", srv.port, timeout=10)
    try:
        red = cli.submit("not-mine")
        red.pop("rid")
        unknown = cli.submit("mine")
        unknown.pop("rid")
    finally:
        cli.close()
    return red, unknown


def scenario_backpressure(pkg, ns, srv):
    """Pipelined frames past the per-connection budget pause reads, and
    every response still arrives; one frame past the whole budget is
    released by its own response."""
    srv.conn_inflight_budget, srv.inflight_budget = 160, 320
    cli = ns.ingress.IngressClient("127.0.0.1", srv.port, timeout=30)
    try:
        rids = [cli.send({"op": "ping", "pad": "x" * 40}) for _ in range(8)]
        got = [cli.recv(rid, timeout=30)["type"] for rid in rids]
        big = cli.request({"op": "ping", "pad": "x" * 600}, timeout=10)["type"]
        after = cli.ping()["type"]
    finally:
        cli.close()
    return got, big, after, _snap(pkg)["paused_reads"].get("conn", 0) > 0


def scenario_idle(pkg, ns, srv):
    srv.idle_s = 0.6
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    s.settimeout(10)
    try:
        closed = s.recv(1024) == b""
    except OSError:
        closed = True
    finally:
        s.close()
    return closed


def scenario_slow_loris(pkg, ns, srv):
    srv.idle_s = 0.6
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    frame = ns.ingress.encode_frame({"op": "ping", "rid": 1, "pad": "x" * 40})
    closed = False
    try:
        for b in frame[:-1]:  # drip, never completing the frame
            s.sendall(bytes([b]))
            time.sleep(0.1)
    except OSError:
        closed = True
    if not closed:
        s.settimeout(5)
        try:
            closed = s.recv(64) == b""
        except OSError:
            closed = True
    s.close()
    return closed


SCENARIOS = {
    "conn_drop": scenario_conn_drop,
    "frame_truncate": scenario_frame_truncate,
    "net_dup": scenario_net_dup,
    "net_delay_drain": scenario_net_delay_drain,
    "redirect": scenario_redirect,
    "backpressure": scenario_backpressure,
    "idle": scenario_idle,
    "slow_loris": scenario_slow_loris,
}


def _scenario(pkg, name):
    ns = PKGS[pkg]
    svc = _service(pkg)
    srv = ns.ingress.IngressServer(svc).start()
    _quiet(srv)
    before = _snap(pkg)
    try:
        out = SCENARIOS[name](pkg, ns, srv)
        ns.faults.reset()
        _quiet(srv)
        delta = _delta(_snap(pkg), before)
    finally:
        ns.faults.reset()
        srv.stop()
    # byte counts carry the responses' own sizes; the outcome is the rest
    delta.pop("bytes", None)
    if name == "backpressure":
        delta.pop("paused_reads", None)  # how often reads pause is timing
    return out, delta


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_network_scenario_gives_the_jax_packages_outcome(name):
    got = _scenario("port", name)
    if name != "net_delay_drain":
        assert got == _scenario("jax", name)
    # the drain holds the port alone: the JAX package's awaits
    # `Server.wait_closed` first, which on Python 3.12 waits for every
    # connection to drop, so its stop() runs out its drain_s + 5 s and
    # the loop dies with the connection open (no "drained" outcome)
    out, delta = got
    if name in ("conn_drop", "frame_truncate"):
        assert out[0] == ["ConnectionError", "pong", "pong"]
        assert delta["connections"].get("faulted") == 1
    elif name == "net_dup":
        assert out[0] == ["pong"] * 4 and not out[1]
        assert delta["frames"] == {"in": 4, "out": 8}
    elif name == "net_delay_drain":
        assert out[:3] == ("pong", True, True)
        assert delta["connections"] == {"drained": 1}
    elif name == "idle":
        assert out is True and delta["connections"] == {"idle": 1}
    elif name == "slow_loris":
        assert out is True and delta["frames_rejected"] == {"slow_read": 1}
    elif name == "backpressure":
        assert out == (["pong"] * 8, "pong", "pong", True)
