"""The port's memory plan (backend.memplan, FSDKRC_MEM_BUDGET_MB) and its
tiled pair verify
(`CudaBatchVerifier._verify_pairs_streamed`, `rlc.StreamFold`,
`utils.pipeline.prefetch_tiles`) and Feldman rows (`_feldman_streamed`)
on device="cpu", against the JAX package's (FSDKR_MEM_PLAN,
FSDKR_MEM_BUDGET_MB; its TpuBatchVerifier on host engines), n=3, t=1,
TEST_CONFIG sizes.

- `plan_rows` and `pair_row_bytes` give the JAX package's tiles and
  estimates over a grid of rows and budgets, the shapes of a 2048-bit
  collect at n=16, of 16 and 64 fused n=16 sessions and of n=256 among
  them; without FSDKRC_MEM_BUDGET_MB the budget is half the free device
  memory on a CUDA device and the JAX package's 256 MiB elsewhere.
- A collect under a budget of two tiles gives the JAX package's
  monolithic verdicts, blame and LocalKey, honest and tampered, at
  FSDKRC_RLC 1 and 0, with the JAX package's `stream_tiles` and
  `fullwidth_ladders` at the same budget; no rho a tile draws reaches a
  key of the precompute cache.
- `_feldman_streamed` over three tiles gives the untiled verdicts.
- `StreamFold` and `prefetch_tiles` behave as the JAX package's.

Every comparison is exact.
"""

import copy
import dataclasses
import random
import threading

import pytest
import torch

from fsdkr_tpu.backend import memplan as jmemplan
from fsdkr_tpu.backend import powm as jpowm
from fsdkr_tpu.backend import rlc as jrlc
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu.utils import pipeline as jpipeline
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.backend import get_backend, memplan, rlc
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.protocol.refresh import _feldman_streamed
from fsdkr_tpu_torch.utils import pipeline
from fsdkr_tpu_torch.utils.lru import global_cache

N, T = 3, 1
MB = 1 << 20
# a pair row at TEST_CONFIG's widths: 768-bit n (n^2 1536-bit), 768-bit N~
ROW_B = memplan.pair_row_bytes(2 * 768, 768)
# two tiles of the 9 pair rows, (5, 4): 5 rows a tile, two in flight
TWO_TILES_MB = 5 * ROW_B * 2 / MB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_defaults(monkeypatch):
    for knob in ("FSDKRC_RLC", "FSDKRC_MULTIEXP", "FSDKRC_RANGEOPT", "FSDKRC_MEM_BUDGET_MB"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def reference_round():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        keys = jax_keygen(T, N, JAX_CONFIG)
        out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], N, JAX_CONFIG)
    return keys, [m for m, _ in out], [dk for _, dk in out]


def _both_plans(monkeypatch, rows, row_bytes, budget_mb, label="pairs"):
    monkeypatch.setenv("FSDKRC_MEM_BUDGET_MB", repr(budget_mb))
    monkeypatch.setenv("FSDKR_MEM_BUDGET_MB", repr(budget_mb))
    monkeypatch.setenv("FSDKR_MEM_PLAN", "1")
    monkeypatch.delenv("FSDKR_PIPELINE", raising=False)
    monkeypatch.setattr(jpowm, "_MESH", None)  # the port's plan has no mesh-aligned cut
    return memplan.plan_rows(rows, row_bytes, label), jmemplan.plan_rows(rows, row_bytes, label)


def _fields(plan):
    return (plan.rows, plan.row_bytes, plan.budget, plan.inflight, plan.tile_rows, plan.tiles)


# (rows, (n^2 bits, N~ bits), budget MiB, the tiles' rows where the
# Motivation of the port's plan gives them)
COLLECT_SHAPES = [
    (256, (4096, 2048), 256, [256]),  # one n=16 collect
    (4096, (4096, 2048), 256, [4096]),  # 16 same-committee n=16 sessions
    (16384, (4096, 2048), 256, [10485, 5899]),  # 64 n=16 sessions (config 5)
    (65536, (4096, 2048), 256, [10485] * 6 + [2626]),  # n=256 (config 4)
    (256, (4096, 2048), 2, [81, 81, 81, 13]),  # chip_smoke's sessions phase (c)
]


@pytest.mark.parametrize("rows,widths,budget_mb,tile_rows", COLLECT_SHAPES,
                         ids=["n16", "16_sessions", "64_sessions", "n256", "n16_at_2MB"])
def test_collect_shapes_plan_as_the_reference(monkeypatch, rows, widths, budget_mb, tile_rows):
    assert memplan.pair_row_bytes(*widths) == jmemplan.pair_row_bytes(*widths) == 12800
    got, want = _both_plans(monkeypatch, rows, memplan.pair_row_bytes(*widths), budget_mb)
    assert _fields(got) == _fields(want)
    assert [hi - lo for lo, hi in got.tiles] == tile_rows
    assert got.tile_bytes(got.tile_rows) * got.inflight <= got.budget


@pytest.mark.parametrize("rows", [1, 7, 100, 1000])
@pytest.mark.parametrize("budget_mb", [0.0001, 0.004, 0.02, 1.5, 64.0])
def test_plan_rows_gives_the_reference_tiles(monkeypatch, rows, budget_mb):
    got, want = _both_plans(monkeypatch, rows, 1000, budget_mb, "t")
    assert _fields(got) == _fields(want)
    assert got.tile_rows >= 1 and got.tiles[-1][1] == rows


@pytest.mark.parametrize("nn_bits,nt_bits", [(1, 1), (1535, 768), (1536, 768), (4095, 2041),
                                             (4096, 2048), (4097, 2049), (8192, 4096)])
def test_pair_row_bytes_gives_the_reference_estimate(nn_bits, nt_bits):
    assert memplan.pair_row_bytes(nn_bits, nt_bits) == jmemplan.pair_row_bytes(nn_bits, nt_bits)
    assert memplan.ec_row_bytes() == jmemplan.ec_row_bytes()


def test_plan_off_and_gauges(monkeypatch):
    """A budget that holds the batch is one tile (the monolithic path, the
    plan's "off"); nothing to cut is no plan. The gauges and counters
    over a 10-tile plan and a streamed call."""
    monkeypatch.setenv("FSDKRC_MEM_BUDGET_MB", repr(200 * 1000 / MB))
    assert not memplan.plan_rows(100, 1000).multi_tile
    assert memplan.plan_rows(0, 1000) is None
    monkeypatch.setenv("FSDKRC_MEM_BUDGET_MB", repr(20 * 1000 / MB))
    memplan.stats_reset()
    plan = memplan.plan_rows(100, 1000, "t")
    assert plan.tile_rows == 10 and len(plan.tiles) == 10
    out = memplan.streamed_rows(lambda items: [x * 3 for x in items], list(range(100)), 1000, "t")
    assert out == [x * 3 for x in range(100)]
    stats = memplan.mem_stats()
    assert stats["tiles"] == {"t": 10} and stats["tile_rows"]["t"] == 10
    assert stats["plans"] == 2 and stats["multi_tile_plans"] == 2
    assert stats["peak_staged_bytes_est"] == 10 * 1000 and stats["staged_bytes_est"] == 0


def test_default_budget_is_half_the_free_device_memory(monkeypatch):
    """Without FSDKRC_MEM_BUDGET_MB: half the free memory of a CUDA device
    (torch.cuda.mem_get_info, here stubbed), the JAX package's 256 MiB on
    the CPU or with no device; the knob wins over both."""
    calls = []

    def mem_get_info(device):
        calls.append(device)
        return 80 * 1000 * MB, 81 * 1000 * MB

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert memplan.mem_budget_bytes("cuda") == 40 * 1000 * MB
    assert calls == [torch.device("cuda")]
    assert memplan.mem_budget_bytes("cpu") == memplan.mem_budget_bytes() == 256 * MB
    # at 40 GB the benchmark's shapes are one tile each
    row_b = memplan.pair_row_bytes(4096, 2048)
    for rows in (256, 16384, 65536):
        assert not memplan.plan_rows(rows, row_b, "pairs", device="cuda").multi_tile
    monkeypatch.setenv("FSDKRC_MEM_BUDGET_MB", "2")
    assert memplan.mem_budget_bytes("cuda") == 2 * MB
    assert len(calls) == 4


def _tamper(msgs, case):
    bad = copy.deepcopy(msgs)
    if case == "pdl":
        p = bad[1].pdl_proof_vec[2]
        bad[1].pdl_proof_vec[2] = dataclasses.replace(p, s2=p.s2 + 1)
    elif case == "range":
        p = bad[2].range_proofs[0]
        bad[2].range_proofs[0] = dataclasses.replace(p, s=p.s + 1)
    return bad


def _outcome(collect):
    try:
        collect()
    except Exception as e:  # noqa: BLE001 - compared by class and fields
        return (type(e).__name__,
                tuple(getattr(e, f, None) for f in ("is_u1_eq", "is_u2_eq", "is_u3_eq")))
    return None


def _jax_collect(msgs, key, dk, rlc_on, plan, budget_mb=None):
    with pytest.MonkeyPatch.context() as mp:
        for knob, value in (("FSDKR_DEVICE_POWM", "0"), ("FSDKR_DEVICE_EC", "0"),
                            ("FSDKR_RLC", rlc_on), ("FSDKR_MEM_PLAN", plan)):
            mp.setenv(knob, value)
        mp.delenv("FSDKR_PIPELINE", raising=False)
        mp.setattr(jpowm, "_MESH", None)
        if budget_mb is not None:
            mp.setenv("FSDKR_MEM_BUDGET_MB", repr(budget_mb))
        key = copy.deepcopy(key)
        jrlc.stats_reset()
        out = _outcome(lambda: JaxRefresh.collect(copy.deepcopy(msgs), key, copy.deepcopy(dk),
                                                  (), JAX_CONFIG.with_backend("tpu")))
        return out, key, jrlc.stats()


@pytest.mark.parametrize("rlc_on,case", [("1", "honest"), ("1", "pdl"), ("1", "range"),
                                         ("0", "honest"), ("0", "pdl")])
def test_tiled_collect_matches_monolithic(reference_round, monkeypatch, rlc_on, case):
    keys, msgs, dks = reference_round
    msgs = _tamper(msgs, case)
    want, want_key, _ = _jax_collect(msgs, keys[0], dks[0], rlc_on, "0")
    tiled, tiled_key, tiled_stats = _jax_collect(msgs, keys[0], dks[0], rlc_on, "1",
                                                 TWO_TILES_MB)
    assert tiled == want and tiled_stats["stream_tiles"] == 2

    monkeypatch.setenv("FSDKRC_RLC", rlc_on)
    monkeypatch.setenv("FSDKRC_MEM_BUDGET_MB", repr(TWO_TILES_MB))
    drawn = []
    raw = rlc.sample_rhos

    def recorded(count):
        rho = raw(count)
        drawn.extend(rho)
        return rho

    monkeypatch.setattr(rlc, "sample_rhos", recorded)
    memplan.stats_reset()
    rlc.stats_reset()
    key = from_reference(keys[0])
    got = _outcome(lambda: RefreshMessage.collect(from_reference(msgs), key,
                                                  from_reference(dks[0]), config=PORT_CONFIG))
    assert got == want
    if case == "honest":
        assert to_fields(key) == to_fields(from_reference(want_key))
    else:
        assert want[0] == {"pdl": "PDLwSlackProofError", "range": "RangeProofError"}[case]
    stats = rlc.stats()
    for counter in ("stream_tiles", "fullwidth_ladders", "rlc_groups", "rows_folded",
                    "bisect_fallbacks"):
        assert stats[counter] == tiled_stats[counter], counter
    mem = memplan.mem_stats()
    assert mem["tile_rows"]["pairs"] == 5 and mem["tiles"]["pairs"] == 2
    assert 0 < mem["peak_staged_bytes_est"] <= mem["budget_bytes"]
    # the rho of every tile is fresh and reaches no key of the cache
    assert bool(drawn) == (rlc_on == "1")

    def flat(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                yield from flat(y)
        else:
            yield x

    cache = global_cache()
    with cache._lock:
        keys_seen = list(cache._d)
    assert not {v for k in keys_seen for v in flat(k) if isinstance(v, int)} & set(drawn)


def test_feldman_streamed_gives_the_untiled_verdicts(reference_round, monkeypatch):
    keys, msgs, _ = reference_round
    msgs = from_reference(msgs)
    # one bad committed point, in the middle tile
    msgs[1].points_committed_vec[1] = msgs[1].points_committed_vec[1] + GENERATOR
    items = [(m.coefficients_committed_vec, m.points_committed_vec[i], i + 1)
             for m in msgs for i in range(N)]
    backend = get_backend(PORT_CONFIG)
    # the untiled verdicts: a budget that holds every row
    monkeypatch.setenv("FSDKRC_MEM_BUDGET_MB", "64")
    memplan.stats_reset()
    base = _feldman_streamed(backend, items)
    assert memplan.mem_stats()["tiles"] == {}
    # three rows a tile at 1024 bytes a row, two tiles in flight
    monkeypatch.setenv("FSDKRC_MEM_BUDGET_MB", repr(3 * 1024 * 2 / MB))
    memplan.stats_reset()
    got = _feldman_streamed(backend, items)
    assert got == base
    assert [i for i, ok in enumerate(got) if not ok] == [4]
    assert memplan.mem_stats()["tiles"] == {"feldman": 3}


@pytest.mark.parametrize("tiles", [1, 2, 5])
def test_stream_fold_absorbs_as_the_reference(tiles):
    rng = random.Random(7300 + tiles)
    m = rng.getrandbits(768) | 1
    folds = [rlc.StreamFold(m, n_prods=2, n_exps=1), jrlc.StreamFold(m, n_prods=2, n_exps=1)]
    row = 0
    for _ in range(tiles):
        prods = [rng.getrandbits(800), rng.getrandbits(800)]
        exps = [rng.getrandbits(300)]
        rows = list(range(row, row + rng.randint(1, 4)))
        row = rows[-1] + 1
        for fold in folds:
            fold.absorb(prods, exps, rows)
    got, want = ((f.modulus, f.prods, f.exp_sums, f.rows) for f in folds)
    assert got == want
    assert not hasattr(folds[0], "__dict__")  # slots only: no room for a rho


@pytest.mark.parametrize("spans", [0, 1, 4])
def test_prefetch_tiles_consumes_in_order_on_the_calling_thread(spans):
    tiles = [(k * 10, k * 10 + 10) for k in range(spans)]
    results = []
    for impl in (pipeline, jpipeline):
        seen = []
        impl.prefetch_tiles(
            tiles, lambda lo, hi: (lo, hi, sum(range(lo, hi))),
            lambda prep: seen.append((prep, threading.current_thread() is threading.main_thread())))
        results.append(seen)
    assert results[0] == results[1]
    assert [p for p, _ in results[0]] == [(lo, hi, sum(range(lo, hi))) for lo, hi in tiles]
    assert all(on_main for _, on_main in results[0])


def test_prefetch_tiles_raises_the_first_failing_tile():
    def prepare(lo, hi):
        if lo == 20:
            raise ValueError("tile 2")
        return lo

    consumed = []
    with pytest.raises(ValueError, match="tile 2"):
        pipeline.prefetch_tiles([(0, 10), (10, 20), (20, 30), (30, 40)], prepare, consumed.append)
    assert consumed == [0, 10]
