"""The port's RLC batch verification (FSDKRC_RLC: backend.rlc, the fold
functions of the proof classes, the RLC arms of CudaBatchVerifier) on
device="cpu", against the JAX package (FSDKR_RLC), n=3, TEST_CONFIG sizes.

- The four fold functions give the JAX package's exact rows for the same
  rows and rho.
- `bisect_rows` walks as the JAX package's does (the same sub-checks in
  the same order, the same verdicts) on synthetic predicates.
- `sample_rhos` draws from `secrets`, in [1, 2^128).
- `CudaBatchVerifier` at FSDKRC_RLC=1 gives `TpuBatchVerifier`'s per-row
  verdicts at FSDKR_RLC=1 under FSDKRC_MULTIEXP and FSDKRC_RANGEOPT both
  on and both off, for verify_pairs, verify_ring_pedersen and
  verify_correct_key on honest and tampered items, with equal fold
  counters. The JAX verifier takes its host engines (FSDKR_DEVICE_POWM=0,
  FSDKR_DEVICE_EC=0), as its own RLC tests do.
- No rho drawn in an RLC collect appears in a key of the precompute
  cache.

Every comparison is exact.
"""

import copy
import dataclasses
import random

import pytest
import torch

from fsdkr_tpu.backend import rlc as jrlc
from fsdkr_tpu.backend.tpu_verifier import TpuBatchVerifier
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.core import paillier as jpaillier
from fsdkr_tpu.core import secp256k1 as jsecp
from fsdkr_tpu.core import vss as jvss
from fsdkr_tpu.proofs import alice_range as jalice
from fsdkr_tpu.proofs import composite_dlog as jdlog
from fsdkr_tpu.proofs import correct_key as jck
from fsdkr_tpu.proofs import pdl_slack as jpdl
from fsdkr_tpu.proofs import ring_pedersen as jrp
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import local_key as jlk
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.backend import rlc
from fsdkr_tpu_torch.backend.cuda_verifier import CudaBatchVerifier
from fsdkr_tpu_torch.carry import from_fields, from_reference, to_fields
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
from fsdkr_tpu_torch.ops import montgomery_kernels
from fsdkr_tpu_torch.proofs.correct_key import NiCorrectKeyProof
from fsdkr_tpu_torch.proofs.pdl_slack import PDLwSlackProof, PDLwSlackStatement
from fsdkr_tpu_torch.proofs.ring_pedersen import RingPedersenProof
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.utils.lru import global_cache

N_PARTIES, T = 3, 1
COUNTERS = ("rlc_groups", "rows_folded", "fullwidth_ladders", "bisect_fallbacks")

JAX_CLASSES = {
    cls.__name__: cls
    for cls in (
        jsecp.Point, jsecp.Scalar, jpaillier.EncryptionKey,
        jpaillier.DecryptionKey, jvss.ShamirSecretSharing, jvss.VerifiableSS,
        jdlog.DLogStatement, jdlog.CompositeDLogProof,
        jck.NiCorrectKeyProof, jpdl.PDLwSlackProof, jalice.AliceProof,
        jrp.RingPedersenStatement, jrp.RingPedersenProof, jlk.SharedKeys,
        jlk.PaillierKeyPair, jlk.LocalKey, JaxRefresh,
    )
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_reference(obj):
    return from_fields(to_fields(obj), JAX_CLASSES)


@pytest.fixture(scope="module")
def port_round():
    """One JAX-package round, n=3, on its host engines, carried into the
    port's classes: (keys after distribute, messages, new dks)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        keys = jax_keygen(T, N_PARTIES, JAX_CONFIG)
        out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], N_PARTIES, JAX_CONFIG)
    return (from_reference(keys), from_reference([m for m, _ in out]),
            from_reference([dk for _, dk in out]))


# -- fold rows ----------------------------------------------------------


def _ints(rng, count, bits):
    return [rng.getrandbits(bits) | 1 for _ in range(count)]


@pytest.mark.parametrize("rows", [1, 3, 16])
def test_pdl_folds_give_the_reference_rows(rows):
    rng = random.Random(7100 + rows)
    h1, h2, nt, n = _ints(rng, 4, 768)
    nn = n * n
    rho = [1 + rng.getrandbits(127) for _ in range(rows)]
    nt_rows = [tuple(_ints(rng, 2, 768)) + (rng.getrandbits(256), rng.getrandbits(770),
                                             rng.getrandbits(1600)) for _ in range(rows)]
    nn_rows = [tuple(_ints(rng, 2, 1536)) + (rng.getrandbits(256), rng.getrandbits(770),
                                              rng.getrandbits(1536)) for _ in range(rows)]
    assert PDLwSlackProof.rlc_fold_nt(h1, h2, nt, nt_rows, rho) == \
        jpdl.PDLwSlackProof.rlc_fold_nt(h1, h2, nt, nt_rows, rho)
    assert PDLwSlackProof.rlc_fold_nn(n, nn, nn_rows, rho) == \
        jpdl.PDLwSlackProof.rlc_fold_nn(n, nn, nn_rows, rho)


def test_ring_pedersen_and_correct_key_folds_give_the_reference_rows(port_round):
    keys, msgs, _ = port_round
    rng = random.Random(7200)
    for msg, jmsg in zip(msgs, to_reference(msgs)):
        m = len(msg.ring_pedersen_proof.Z)
        rho = [1 + rng.getrandbits(127) for _ in range(m)]
        bits = [rng.getrandbits(1) for _ in range(m)]
        got = RingPedersenProof.rlc_fold(msg.ring_pedersen_statement, msg.ring_pedersen_proof,
                                         bits, rho)
        want = jrp.RingPedersenProof.rlc_fold(jmsg.ring_pedersen_statement,
                                              jmsg.ring_pedersen_proof, bits, rho)
        assert got == want
        sigma = msg.dk_correctness_proof.sigma_vec
        targets = _ints(rng, len(sigma), 700)
        rho = rho[: len(sigma)]
        assert NiCorrectKeyProof.rlc_fold(sigma, targets, msg.ek.n, rho) == \
            jck.NiCorrectKeyProof.rlc_fold(sigma, targets, msg.ek.n, rho)


# -- bisection -----------------------------------------------------------


def _walk(bisect, rows, bad):
    log = []

    def combined(sub):
        log.append(("combined", tuple(sub)))
        return not any(i in bad for i in sub)

    def row_check(i):
        log.append(("row", i))
        return i not in bad

    return bisect(range(rows), combined, row_check), log


@pytest.mark.parametrize("rows", [16, 33])
@pytest.mark.parametrize("bad_at", ["one", "ends", "three"])
def test_bisect_rows_walks_as_the_reference(rows, bad_at):
    bad = {"one": {rows // 3}, "ends": {0, rows - 1}, "three": {1, 2, rows - 2}}[bad_at]
    got, got_log = _walk(rlc.bisect_rows, rows, bad)
    want, want_log = _walk(jrlc.bisect_rows, rows, bad)
    assert got == want and got_log == want_log
    assert sorted(got) == list(range(rows))
    assert {i for i, ok in got.items() if not ok} == bad
    # every INVALID verdict came from the exact row check
    assert bad <= {i for kind, i in got_log if kind == "row"}


def test_sample_rhos_draws_from_secrets_in_range(monkeypatch):
    calls = []
    raw = rlc.secrets.randbelow
    monkeypatch.setattr(rlc.secrets, "randbelow", lambda top: calls.append(top) or raw(top))
    rhos = rlc.sample_rhos(2000)
    assert len(calls) == 2000 and set(calls) == {(1 << rlc.RLC_BITS) - 1}
    assert all(1 <= r < 1 << rlc.RLC_BITS for r in rhos)
    assert max(rhos).bit_length() == rlc.RLC_BITS  # the top bit is reached
    assert len(set(rhos)) == len(rhos)
    assert rlc.RLC_BITS == jrlc.RLC_BITS == 128


# -- the verifier against TpuBatchVerifier ------------------------------


def _tampered(msgs):
    """Pair rows (sender j, receiver i): PDL s1 + 1 at (0, 1), s2 + 1 at
    (1, 0), u3 + 1 at (2, 1), s3 = -5 at (1, 2) (out of domain); range s +
    1 at (0, 2). Ring-Pedersen Z[0] + 1 in message 1; correct-key
    sigma[0] + 1 in message 2."""
    bad = copy.deepcopy(msgs)

    def bump(j, i, family, field, value=None):
        vec = bad[j].pdl_proof_vec if family == "pdl" else bad[j].range_proofs
        old = getattr(vec[i], field)
        vec[i] = dataclasses.replace(vec[i], **{field: old + 1 if value is None else value})

    bump(0, 1, "pdl", "s1")
    bump(1, 0, "pdl", "s2")
    bump(2, 1, "pdl", "u3")
    bump(1, 2, "pdl", "s3", -5)
    bump(0, 2, "range", "s")
    rp = bad[1].ring_pedersen_proof
    bad[1].ring_pedersen_proof = dataclasses.replace(rp, Z=[rp.Z[0] + 1] + list(rp.Z[1:]))
    ck = bad[2].dk_correctness_proof
    bad[2].dk_correctness_proof = dataclasses.replace(
        ck, sigma_vec=[ck.sigma_vec[0] + 1] + list(ck.sigma_vec[1:]))
    return bad


def _items(msgs, key, statement_cls, generator):
    pdl, rng = [], []
    for msg in msgs:
        for i in range(len(msgs)):
            st = statement_cls(
                ciphertext=msg.points_encrypted_vec[i], ek=key.paillier_key_vec[i],
                Q=msg.points_committed_vec[i], G=generator, h1=key.h1_h2_n_tilde_vec[i].g,
                h2=key.h1_h2_n_tilde_vec[i].ni, N_tilde=key.h1_h2_n_tilde_vec[i].N)
            pdl.append((msg.pdl_proof_vec[i], st))
            rng.append((msg.range_proofs[i], msg.points_encrypted_vec[i],
                        key.paillier_key_vec[i], key.h1_h2_n_tilde_vec[i]))
    rp = [(m.ring_pedersen_proof, m.ring_pedersen_statement) for m in msgs]
    ck = [(m.dk_correctness_proof, m.ek) for m in msgs]
    return pdl, rng, rp, ck


@pytest.fixture(scope="module", params=["honest", "tampered"])
def family_items(request, port_round):
    """The first party's collect items of the honest or tampered round, in
    both packages' classes."""
    keys, msgs, _ = port_round
    if request.param == "tampered":
        msgs = _tampered(msgs)
    port = _items(msgs, keys[0], PDLwSlackStatement, GENERATOR)
    jax = _items(to_reference(msgs), to_reference(keys[0]), jpdl.PDLwSlackStatement,
                 jsecp.GENERATOR)
    return request.param, port, jax


def _verify_all(verifier, items):
    pdl, rng, rp, ck = items
    return (verifier.verify_pairs(list(pdl), list(rng)),
            verifier.verify_ring_pedersen(list(rp), PORT_CONFIG.m_security),
            verifier.verify_correct_key(list(ck), PORT_CONFIG.correct_key_rounds))


@pytest.mark.parametrize("layout", ["1", "0"], ids=["multiexp_rangeopt", "columns"])
def test_rlc_verdicts_and_counters_match_reference(family_items, monkeypatch, layout):
    case, port_items, jax_items = family_items
    with pytest.MonkeyPatch.context() as mp:
        for knob, value in (("FSDKR_RLC", "1"), ("FSDKR_DEVICE_POWM", "0"),
                            ("FSDKR_DEVICE_EC", "0"), ("FSDKR_MULTIEXP", layout),
                            ("FSDKR_RANGEOPT", layout)):
            mp.setenv(knob, value)
        jrlc.stats_reset()
        want = _verify_all(TpuBatchVerifier(JAX_CONFIG), jax_items)
        want_counts = {k: jrlc.stats()[k] for k in COUNTERS}
    monkeypatch.setenv("FSDKRC_RLC", "1")
    monkeypatch.setenv("FSDKRC_MULTIEXP", layout)
    monkeypatch.setenv("FSDKRC_RANGEOPT", layout)
    straus = []
    raw = montgomery_kernels.multi_modexp
    monkeypatch.setattr(montgomery_kernels, "multi_modexp",
                        lambda *a, **kw: straus.append(1) or raw(*a, **kw))
    rlc.stats_reset()
    got = _verify_all(CudaBatchVerifier(PORT_CONFIG), port_items)
    assert got == want
    assert {k: rlc.stats()[k] for k in COUNTERS} == want_counts
    # 3 receivers x (mod N~, mod n^2) PDL groups, 3 ring-Pedersen and 3
    # correct-key proofs; the gated s3 row folds into no group
    assert want_counts["rlc_groups"] == 12
    assert want_counts["fullwidth_ladders"] == want_counts["rlc_groups"]
    assert straus  # the folds' aggregated rows ran on the Straus kernel
    (pdl_v, range_v), rp_v, ck_v = got
    if case == "honest":
        assert want_counts["bisect_fallbacks"] == 0
        assert pdl_v == [None] * 9 and all(range_v) and all(rp_v) and all(ck_v)
    else:
        assert want_counts["bisect_fallbacks"] >= 4
        assert [v is None for v in pdl_v] == [True, False, True, False, True, False, True,
                                              False, True]
        assert range_v == [True, True, False, True, True, True, True, True, True]
        assert rp_v == [True, False, True] and ck_v == [True, True, False]


def test_rlc_collect_keeps_no_rho_in_the_cache(port_round, monkeypatch):
    """Every rho drawn in a port collect under the defaults is recorded;
    none of them appears in a key of the precompute cache."""
    keys, msgs, dks = port_round
    for knob in ("FSDKRC_RLC", "FSDKRC_MULTIEXP", "FSDKRC_RANGEOPT"):
        monkeypatch.delenv(knob, raising=False)
    drawn = []
    raw = rlc.sample_rhos

    def recorded(count):
        rho = raw(count)
        drawn.extend(rho)
        return rho

    monkeypatch.setattr(rlc, "sample_rhos", recorded)
    rlc.stats_reset()
    key = copy.deepcopy(keys[0])
    RefreshMessage.collect(copy.deepcopy(msgs), key, copy.deepcopy(dks[0]),
                           config=PORT_CONFIG)
    assert rlc.stats()["rlc_groups"] > 0 and rlc.stats()["bisect_fallbacks"] == 0
    assert len(drawn) == rlc.stats()["rows_folded"]

    def flat(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                yield from flat(y)
        else:
            yield x

    cache = global_cache()
    assert cache.budget > 0
    with cache._lock:
        keys_seen = list(cache._d)
    assert keys_seen
    ints = {v for k in keys_seen for v in flat(k) if isinstance(v, int)}
    assert not ints & set(drawn)
