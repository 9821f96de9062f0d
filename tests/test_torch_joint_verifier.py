"""The verifier's and provers' layouts under FSDKRC_MULTIEXP and
FSDKRC_RANGEOPT (backend.cuda_verifier, proofs.pdl_slack,
proofs.alice_range), on device="cpu", against the JAX package, with
FSDKRC_RLC=0: the per-row layouts these knobs choose (the RLC arms are
held in tests/test_torch_rlc.py).

- `CudaBatchVerifier.verify_pairs`, `verify_pdl` and `verify_range`
  under all four combinations of the two knobs give the per-row verdicts
  of the JAX package's `TpuBatchVerifier` at FSDKR_RLC=0 with
  FSDKR_MULTIEXP and FSDKR_RANGEOPT set alike, on the pair items of one
  collect (n=3, TEST_CONFIG sizes) with honest rows and rows tampered in
  s1, s2 or z, a ciphertext with gcd(c, n^2) > 1 (its inverse fails) and
  out-of-domain s1 (the domain gates). The JAX verifier takes its host
  engines here (FSDKR_DEVICE_POWM=0): its verdicts do not depend on the
  engine, and the port's own engines are held against the JAX package's
  kernels in tests/test_torch_multiexp.py.
- With the same nonces, the provers' joint layout gives the column
  layout's commitments: z and u3 (PDL), z and w (Alice range).

Every comparison is exact.
"""

import copy
import dataclasses

import pytest
import torch

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
from fsdkr_tpu_torch.backend import powm
from fsdkr_tpu_torch.backend.cuda_verifier import CudaBatchVerifier
from fsdkr_tpu_torch.carry import from_fields, from_reference, to_fields
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, Scalar
from fsdkr_tpu_torch.ops import montgomery_kernels
from fsdkr_tpu_torch.proofs.alice_range import AliceProof
from fsdkr_tpu_torch.proofs.pdl_slack import (
    PDLwSlackProof,
    PDLwSlackStatement,
    PDLwSlackWitness,
)

N_PARTIES, T = 3, 1
Q = jsecp.N

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
    """One JAX-package round, n=3, on its host engines (FSDKR_DEVICE_POWM
    and FSDKR_DEVICE_EC off: the messages do not depend on the engine),
    carried into the port's classes: (keys, messages)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        keys = jax_keygen(T, N_PARTIES, JAX_CONFIG)
        out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], N_PARTIES, JAX_CONFIG)
    return from_reference(keys), from_reference([m for m, _ in out])


def _tampered(msgs):
    """Pair rows (sender j, receiver i) at row 3j + i: 0, 7, 8 honest; 1
    PDL s1 + 1; 2 range s2 + 1; 3 PDL s2 + 1 and range z + 1; 4 the
    ciphertext a multiple of the receiver's n (no inverse mod n^2); 5
    out-of-domain s1 in both proofs; 6 PDL z + 1 and range s1 + 1."""
    bad = copy.deepcopy(msgs)

    def edit(j, i, family, **fields):
        vec = bad[j].pdl_proof_vec if family == "pdl" else bad[j].range_proofs
        vec[i] = dataclasses.replace(vec[i], **fields)

    def bump(j, i, family, field):
        vec = bad[j].pdl_proof_vec if family == "pdl" else bad[j].range_proofs
        edit(j, i, family, **{field: getattr(vec[i], field) + 1})

    bump(0, 1, "pdl", "s1")
    bump(0, 2, "range", "s2")
    bump(1, 0, "pdl", "s2")
    bump(1, 0, "range", "z")
    bad[1].points_encrypted_vec[1] = bad[1].ek.n * 7
    edit(1, 2, "pdl", s1=1 << 1100)
    edit(1, 2, "range", s1=Q**3 + 1)
    bump(2, 0, "pdl", "z")
    bump(2, 0, "range", "s1")
    return bad


def _items(msgs, key, statement_cls, generator):
    pdl, rng = [], []
    for msg in msgs:
        for i in range(len(msgs)):
            st = statement_cls(
                ciphertext=msg.points_encrypted_vec[i],
                ek=key.paillier_key_vec[i],
                Q=msg.points_committed_vec[i],
                G=generator,
                h1=key.h1_h2_n_tilde_vec[i].g,
                h2=key.h1_h2_n_tilde_vec[i].ni,
                N_tilde=key.h1_h2_n_tilde_vec[i].N,
            )
            pdl.append((msg.pdl_proof_vec[i], st))
            rng.append((msg.range_proofs[i], msg.points_encrypted_vec[i],
                        key.paillier_key_vec[i], key.h1_h2_n_tilde_vec[i]))
    return pdl, rng


@pytest.fixture(scope="module")
def pair_items(port_round):
    """The tampered round's pair items for the first party's collect, in
    both packages' classes."""
    keys, msgs = port_round
    bad = _tampered(msgs)
    port = _items(bad, keys[0], PDLwSlackStatement, GENERATOR)
    jax = _items(to_reference(bad), to_reference(keys[0]), jpdl.PDLwSlackStatement,
                 jsecp.GENERATOR)
    return port, jax


@pytest.fixture(scope="module")
def reference_verdicts(pair_items):
    """TpuBatchVerifier's (PDL, range) verdicts at FSDKR_RLC=0, host
    engines, under each combination of its two knobs."""
    _, (jpdl_items, jrange_items) = pair_items
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_RLC", "0")
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        for multiexp in (True, False):
            for rangeopt in (True, False):
                mp.setenv("FSDKR_MULTIEXP", "1" if multiexp else "0")
                mp.setenv("FSDKR_RANGEOPT", "1" if rangeopt else "0")
                out[multiexp, rangeopt] = TpuBatchVerifier(JAX_CONFIG).verify_pairs(
                    list(jpdl_items), list(jrange_items))
    return out


@pytest.mark.parametrize("multiexp", [True, False], ids=["multiexp", "columns"])
@pytest.mark.parametrize("rangeopt", [True, False], ids=["rangeopt", "range_columns"])
def test_pair_verdicts_match_reference_under_each_layout(pair_items, reference_verdicts,
                                                         monkeypatch, multiexp, rangeopt):
    (pdl_items, range_items), _ = pair_items
    monkeypatch.setenv("FSDKRC_RLC", "0")
    monkeypatch.setenv("FSDKRC_MULTIEXP", "1" if multiexp else "0")
    monkeypatch.setenv("FSDKRC_RANGEOPT", "off" if not rangeopt else "on")
    calls = {}
    for name in ("multi_modexp", "shared_exp_segments"):
        raw = getattr(montgomery_kernels, name)
        monkeypatch.setattr(montgomery_kernels, name,
                            lambda *a, _raw=raw, _n=name, **kw:
                            calls.setdefault(_n, []).append(1) or _raw(*a, **kw))
    want_pdl, want_range = reference_verdicts[multiexp, rangeopt]
    # the tampered rows fail, the honest ones pass, in every layout
    assert [v is None for v in want_pdl] == [True, False, True, False, False, False, False,
                                             True, True]
    assert want_range == [True, True, False, False, False, False, False, True, True]
    assert reference_verdicts[multiexp, rangeopt] == reference_verdicts[True, True]
    verifier = CudaBatchVerifier(PORT_CONFIG)
    assert verifier.verify_pairs(pdl_items, range_items) == (want_pdl, want_range)
    # the Straus kernel under MULTIEXP, the shared-exponent one under RANGEOPT
    assert ("multi_modexp" in calls) == multiexp
    assert ("shared_exp_segments" in calls) == rangeopt
    # the range family alone, through verify_range's dispatch: its joint
    # layout, and its own engines (verify_pdl's joint layout runs in
    # tests/test_torch_ec.py)
    if multiexp != rangeopt:
        assert verifier.verify_range(range_items) == want_range


def test_joint_prover_layout_gives_the_column_commitments(port_round, monkeypatch):
    """Same nonces, both layouts of stage 1 through powm_columns (on the
    host: the joint columns' device route is held in
    tests/test_torch_multiexp.py): equal z and u3 (PDL), z and w (range),
    and so equal challenges."""
    keys, _ = port_round
    key = keys[0]
    rows = range(N_PARTIES)
    h1v = [key.h1_h2_n_tilde_vec[i].g for i in rows]
    h2v = [key.h1_h2_n_tilde_vec[i].ni for i in rows]
    ntv = [key.h1_h2_n_tilde_vec[i].N for i in rows]
    nv = [key.paillier_key_vec[i].n for i in rows]
    nnv = [key.paillier_key_vec[i].nn for i in rows]
    xs = [Scalar.from_int(0xC0FFEE + 977 * i) for i in rows]
    rs = [3 + 2 * i for i in rows]
    ciphers = [(1 + x.to_int() * n) * pow(r, n, nn) % nn for x, r, n, nn in zip(xs, rs, nv, nnv)]
    statements = [
        PDLwSlackStatement(ciphertext=c, ek=key.paillier_key_vec[i], Q=GENERATOR * xs[i],
                           G=GENERATOR, h1=h1v[i], h2=h2v[i], N_tilde=ntv[i])
        for i, c in zip(rows, ciphers)
    ]
    witnesses = [PDLwSlackWitness(x=x, r=r) for x, r in zip(xs, rs)]
    pdl_nonces = PDLwSlackProof.sample_stage1(ntv, nv)
    alice_nonces = AliceProof.sample_stage1(ntv, nv)
    monkeypatch.setattr(PDLwSlackProof, "sample_stage1", staticmethod(lambda *a: pdl_nonces))
    monkeypatch.setattr(AliceProof, "sample_stage1", staticmethod(lambda *a, **kw: alice_nonces))
    got = {}
    for joint in ("1", "0"):
        monkeypatch.setenv("FSDKRC_MULTIEXP", joint)
        state, cols = PDLwSlackProof.prove_stage1(witnesses, h1v, h2v, ntv, nv, nnv)
        assert len(cols) == (3 if joint == "1" else 5)
        assert cols[-1][1] == nv  # beta^n last in either layout
        state, _ = PDLwSlackProof.prove_stage2(state, powm.powm_columns(powm.host_powm, *cols),
                                               statements, device="cpu")
        astate, acols = AliceProof.generate_stage1(
            [x.to_int() for x in xs], rs, h1v, h2v, ntv, nv, nnv)
        ares = powm.powm_columns(powm.host_powm, *acols)
        w = ares[1] if joint == "1" else [a * b % m for a, b, m in zip(ares[2], ares[3], ntv)]
        astate, _ = AliceProof.generate_stage2(astate, ares, ciphers)
        got[joint] = (state["z"], state["u3"], state["e"], astate["z"], w, astate["e"])
    assert got["1"] == got["0"]
