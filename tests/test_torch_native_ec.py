"""The port's native secp256k1 host core (fsdkr_tpu_torch/native/ec.py over
fsdkr_tpu_torch/csrc/fsdkr_ec.cpp) against the JAX package's bridge
(fsdkr_tpu/native/ec.py) and the Python points, and the two checks
routed through it.

- `horner_batch` and `lincomb2_batch` give the JAX bridge's points and
  the Python points' (the port's and the JAX package's), on numpy-seeded
  inputs with the edges of tests/test_native_ec.py (identity
  commitments, index 0, scalars 0, 1 and q-1, identity points, a
  negation and a+b=0), at 1 thread and at 4.
- The guards the JAX bridge lacks: sequences of different lengths and a
  scalar outside [0, 2^256) raise ValueError; an index outside [0, 2^32)
  returns None, as the JAX bridge does.
- The host backend's `validate_feldman` is one Horner launch a scheme
  with the JAX host verifier's verdicts (a scheme the core cannot take
  goes to the Python points); a host-backend collect with one tampered
  Feldman share raises the JAX package's error with its blame.
- A cuda-backend collect (the plain versions) with one tampered PDL u1
  takes `_pdl_u1_host`'s native launch and raises the JAX package's
  error, the port's naming the sender.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from fsdkr_tpu.backend.batch_verifier import HostBatchVerifier as JaxHostVerifier
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.core import secp256k1 as JE
from fsdkr_tpu.core import vss as jvss
from fsdkr_tpu.native import ec as jec
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG, native
from fsdkr_tpu_torch.backend.batch_verifier import HostBatchVerifier
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.core import secp256k1 as E
from fsdkr_tpu_torch.native import ec
from fsdkr_tpu_torch.protocol import RefreshMessage

RNG = np.random.default_rng(0xEC25)
Q = E.N
HOST = dataclasses.replace(TEST_CONFIG, backend="host")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op pool
    only spins there, and under pytest-xdist it takes other workers'
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scalar():
    words = RNG.integers(0, 1 << 32, size=8, dtype=np.uint64)
    x = 0
    for w in words:
        x = (x << 32) | int(w)
    return x % (Q - 1) + 1


def _point():
    return E.GENERATOR * E.Scalar.from_int(_scalar())


def _xy(p):
    return None if p.infinity else (p.x, p.y)


def _jpoint(xy):
    return JE.Point.identity() if xy is None else JE.Point(*xy)


def _horner_oracle(commits, u, pkg=E):
    acc = pkg.Point.identity()
    for a in reversed(commits):
        acc = acc * u + a
    return _xy(acc)


@pytest.mark.parametrize("threads", [1, 4])
def test_horner_matches_jax_and_oracle(threads):
    cases = []
    for t1 in (1, 2, 9, 33):
        commits = [_point() for _ in range(t1)]
        cases.append(commits)
    with_identity = [_point() for _ in range(5)]
    with_identity[2] = E.Point.identity()
    cases.append(with_identity)
    top_identity = [_point() for _ in range(4)] + [E.Point.identity()]
    cases.append(top_identity)
    idxs = [0, 1, 2, 7, 16, 255, 65535, (1 << 32) - 1]
    native.set_threads(threads)
    try:
        for commits in cases:
            xy = [_xy(c) for c in commits]
            got = ec.horner_batch(xy, idxs)
            assert got == [_horner_oracle(commits, u) for u in idxs]
            assert got == jec.horner_batch(xy, idxs)
            assert got[:6] == [_horner_oracle([_jpoint(p) for p in xy], u, JE) for u in idxs[:6]]
    finally:
        native.set_threads(0)
    assert ec.horner_batch([_xy(_point())], []) == []


def test_horner_out_of_domain_rows_return_none_like_jax():
    xy = [_xy(_point()) for _ in range(3)]
    for idxs in ([1 << 32], [3, (1 << 32) + 5], [-1]):
        assert ec.horner_batch(xy, idxs) is None
    assert jec.horner_batch(xy, [1 << 32]) is None
    assert ec.horner_batch([], [1, 2]) is None


@pytest.mark.parametrize("threads", [1, 4])
def test_lincomb2_matches_jax_and_oracle(threads):
    P, R = _point(), _point()
    rows = [
        (P, 0, R, _scalar()),              # a = 0
        (P, 1, R, 0),                      # b = 0
        (P, Q - 1, R, 1),
        (P, _scalar(), E.Point.identity(), _scalar()),  # identity Q
        (E.Point.identity(), _scalar(), R, _scalar()),  # identity P
        (P, 5, -P, 5),                     # negation: 5P - 5P
        (P, 17, P, Q - 17),                # a + b = 0
        (P, 9, P, 9),                      # a doubling
        (E.GENERATOR, _scalar(), R, _scalar()),
    ] + [(_point(), _scalar(), _point(), _scalar()) for _ in range(7)]
    Ps, a, Rs, b = (list(c) for c in zip(*rows))
    want = [_xy(p * E.Scalar.from_int(x) + r * E.Scalar.from_int(y)) for p, x, r, y in rows]
    native.set_threads(threads)
    try:
        ec.stats_reset()
        got = ec.lincomb2_batch([_xy(p) for p in Ps], a, [_xy(r) for r in Rs], b)
        assert ec.stats()["lincomb2_batches"] == 1
    finally:
        native.set_threads(0)
    assert got == want
    assert got[5] is None and got[6] is None
    assert got == jec.lincomb2_batch([_xy(p) for p in Ps], a, [_xy(r) for r in Rs], b)
    assert ec.lincomb2_batch([], [], [], []) == []


def test_guards_the_jax_bridge_lacks():
    P = _xy(_point())
    # sequences of different lengths: the C core would read past the end
    for args in (([P, P], [1], [P, P], [2, 3]), ([P], [1], [P, P], [2]), ([P], [1], [P], [])):
        with pytest.raises(ValueError):
            ec.lincomb2_batch(*args)
    # scalars outside [0, 2^256): refused before they are staged
    for bad in (1 << 256, -1):
        with pytest.raises(ValueError):
            ec.lincomb2_batch([P], [bad], [P], [1])
        with pytest.raises(ValueError):
            ec.lincomb2_batch([P], [1], [P], [bad])
        assert jec.lincomb2_batch([P], [bad], [P], [1]) is None


def _feldman_items(pkg, vss_mod, n=8, t=3, tamper=True):
    secret = pkg.Scalar.from_int(_scalar())
    scheme, shares = vss_mod.share(t, n, secret)
    pub = [pkg.GENERATOR * s for s in shares]
    items = [(scheme, pub[i], i + 1) for i in range(n)]
    if tamper:
        items.append((scheme, pub[0] + pkg.GENERATOR, 2))
        items.append((scheme, pkg.Point.identity(), 3))
    return items


def test_host_feldman_is_one_launch_a_scheme_like_jax():
    jitems = _feldman_items(JE, jvss) + _feldman_items(JE, jvss, n=5, t=2)
    # one port scheme a JAX scheme: rows of a message share its object
    schemes = {id(s): from_reference(s) for s, _, _ in jitems}
    items = [(schemes[id(s)], from_reference(p), i) for s, p, i in jitems]
    want = JaxHostVerifier().validate_feldman(jitems)
    ec.stats_reset()
    got = HostBatchVerifier().validate_feldman(items)
    assert got == want == [s.validate_share_public(p, i) for s, p, i in items]
    assert got.count(False) == 4
    st = ec.stats()
    assert (st["horner_batches"], st["horner_rows"]) == (2, len(items))
    # an index the core cannot take: that scheme's rows on the Python points
    scheme, point, _ = items[0]
    odd = [(scheme, point, 1 << 32), (scheme, point, 1)]
    ec.stats_reset()
    assert HostBatchVerifier().validate_feldman(odd) == [
        scheme.validate_share_public(p, i) for _, p, i in odd]
    assert ec.stats()["horner_batches"] == 0
    assert HostBatchVerifier().validate_feldman([]) == []


@pytest.fixture(scope="module")
def jax_round():
    keys = jax_keygen(1, 3, JAX_CONFIG)
    out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], 3, JAX_CONFIG)
    return keys, [m for m, _ in out], [dk for _, dk in out]


def _collect_errors(jax_round, mutate, config):
    keys, msgs, dks = jax_round
    bad = copy.deepcopy(msgs)
    mutate(bad)
    with pytest.raises(Exception) as jerr:
        JaxRefresh.collect(copy.deepcopy(bad), copy.deepcopy(keys[0]), copy.deepcopy(dks[0]),
                           (), JAX_CONFIG)
    with pytest.raises(Exception) as perr:
        RefreshMessage.collect(from_reference(bad), from_reference(keys[0]),
                               from_reference(dks[0]), (), config)
    return bad, jerr.value, perr.value


def _key(e):
    return (type(e).__name__, getattr(e, "is_u1_eq", None), getattr(e, "is_u2_eq", None),
            getattr(e, "is_u3_eq", None))


def test_host_collect_with_a_tampered_feldman_share_blames_like_jax(jax_round):
    def mutate(msgs):
        msgs[1].points_committed_vec[0] = msgs[1].points_committed_vec[0] + JE.GENERATOR

    ec.stats_reset()
    bad, jerr, perr = _collect_errors(jax_round, mutate, HOST)
    assert _key(perr) == _key(jerr) and type(perr).__name__ == "PublicShareValidationError"
    assert getattr(perr, "party_index", None) == getattr(jerr, "party_index", None)
    assert ec.stats()["horner_batches"] >= 1


def test_cuda_collect_with_a_tampered_pdl_u1_blames_like_jax(jax_round):
    def mutate(msgs):
        p = msgs[1].pdl_proof_vec[0]
        msgs[1].pdl_proof_vec[0] = dataclasses.replace(p, u1=p.u1 + JE.GENERATOR)

    ec.stats_reset()
    bad, jerr, perr = _collect_errors(jax_round, mutate, TEST_CONFIG)
    assert _key(perr) == _key(jerr) and type(perr).__name__ == "PDLwSlackProofError"
    assert perr.is_u1_eq is False and perr.party_index == bad[1].party_index
    # the combined u1 MSM failed: the rows took one native launch
    assert ec.stats()["lincomb2_batches"] >= 1
