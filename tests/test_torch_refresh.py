"""The port's refresh round (fsdkr_tpu_torch.protocol) against the JAX
package's, at TEST_CONFIG-sized parameters (768-bit Paillier, M=32, 3
correct-key rounds), n=3, t=1, with the port on device="cpu" (its
kernels' plain versions).

- JAX-package messages and keys carried across by carry.from_reference:
  the port's collect must yield the same new LocalKey, field for field,
  as the JAX collect on deep copies of the same inputs.
- A tampered PDL row must raise the same exception class with the same
  (u1, u2, u3) tuple as the JAX host verifier, naming the sender.
- Port distribute_batch messages, rebuilt as JAX objects from
  carry.to_fields, must pass the JAX collect, and both packages'
  collects must adopt identical keys.
- A tampered range, ring-Pedersen or correct-key proof raises what the
  JAX collect raises, naming the same party; composite-dlog verdicts and
  the host batch inverse match their references.

Every comparison is exact (integers, points, verdict tuples).
"""

import contextlib
import copy
import dataclasses

import pytest
import torch

from fsdkr_tpu.backend.batch_verifier import HostBatchVerifier
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.core import paillier as jpaillier
from fsdkr_tpu.core import secp256k1 as jsecp
from fsdkr_tpu.core import vss as jvss
from fsdkr_tpu.errors import PDLwSlackProofError as JaxPDLError
from fsdkr_tpu.proofs import alice_range as jalice
from fsdkr_tpu.proofs import composite_dlog as jdlog
from fsdkr_tpu.proofs import correct_key as jck
from fsdkr_tpu.proofs import pdl_slack as jpdl
from fsdkr_tpu.proofs import ring_pedersen as jrp
from fsdkr_tpu.protocol import local_key as jlk
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.carry import from_fields, from_reference, to_fields
from fsdkr_tpu_torch.core import vss
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR
from fsdkr_tpu_torch.errors import PDLwSlackProofError
from fsdkr_tpu_torch.protocol import RefreshMessage

N, T = 3, 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op thread
    pool only spins there, and under pytest-xdist it would take cores
    from the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def to_reference(obj):
    return from_fields(to_fields(obj), JAX_CLASSES)


def key_fields(key):
    """A LocalKey of either package as plain fields, in the port's shape
    (the JAX VSS scheme's unset delegate certificate dropped)."""
    if type(key).__module__.startswith("fsdkr_tpu."):
        key = from_reference(key)
    return to_fields(key)


def test_config_parameters_agree():
    assert (
        PORT_CONFIG.paillier_bits, PORT_CONFIG.m_security,
        PORT_CONFIG.correct_key_rounds, PORT_CONFIG.hash_alg,
    ) == (
        JAX_CONFIG.paillier_bits, JAX_CONFIG.m_security,
        JAX_CONFIG.correct_key_rounds, JAX_CONFIG.hash_alg,
    )
    assert PORT_CONFIG.device == "cpu" and PORT_CONFIG.backend == "cuda"


@pytest.fixture(scope="module")
def reference_round():
    """One honest JAX-package round: (keys after distribute, messages,
    new dks). Consumers deep-copy before mutating."""
    keys = jax_keygen(T, N, JAX_CONFIG)
    out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], N, JAX_CONFIG)
    return keys, [m for m, _ in out], [dk for _, dk in out]


def test_carry_round_trips(reference_round):
    keys, msgs, dks = reference_round
    port = from_reference(msgs)
    assert type(port[0]) is RefreshMessage
    assert to_fields(to_reference(port)) == to_fields(copy.deepcopy(msgs))
    assert key_fields(to_reference(from_reference(keys[0]))) == key_fields(keys[0])


def _collect_like_reference(reference_round, config):
    keys, msgs, dks = reference_round
    for i in range(N):
        jax_key = copy.deepcopy(keys[i])
        JaxRefresh.collect(
            copy.deepcopy(msgs), jax_key, copy.deepcopy(dks[i]),
            config=JAX_CONFIG,
        )
        port_key = from_reference(keys[i])
        RefreshMessage.collect(
            from_reference(msgs), port_key, from_reference(dks[i]), config=config
        )
        assert key_fields(port_key) == key_fields(jax_key)
        assert port_key.keys_linear.x_i != from_reference(keys[i]).keys_linear.x_i


def test_port_collect_matches_reference_collect(reference_round, monkeypatch):
    """Under the defaults (FSDKRC_RLC, FSDKRC_MULTIEXP and FSDKRC_RANGEOPT
    on) against the JAX package's default collect (FSDKR_RLC on): the PDL,
    ring-Pedersen and correct-key rows folded (their aggregated rows on
    the Straus kernel's plain version, no bisection), the range u-powers
    on the shared-exponent one."""
    from fsdkr_tpu.backend import rlc as jrlc
    from fsdkr_tpu_torch.backend import rlc
    from fsdkr_tpu_torch.ops import montgomery_kernels

    for knob in ("FSDKRC_RLC", "FSDKRC_MULTIEXP", "FSDKRC_RANGEOPT", "FSDKR_RLC"):
        monkeypatch.delenv(knob, raising=False)
    assert rlc.rlc_enabled() and jrlc.rlc_enabled()
    calls = []
    for name in ("multi_modexp", "shared_exp_segments"):
        raw = getattr(montgomery_kernels, name)
        monkeypatch.setattr(montgomery_kernels, name,
                            lambda *a, _raw=raw, _n=name, **kw: calls.append(_n) or _raw(*a, **kw))
    rlc.stats_reset()
    _collect_like_reference(reference_round, PORT_CONFIG)
    assert sorted(set(calls)) == ["multi_modexp", "shared_exp_segments"]
    # a collect: n receivers x (mod N~, mod n^2) PDL groups, n ring-Pedersen
    # and n correct-key proofs; one full-width ladder a group
    stats = rlc.stats()
    assert stats["rlc_groups"] == stats["fullwidth_ladders"] == N * 4 * N
    assert stats["bisect_fallbacks"] == 0


@pytest.mark.parametrize("route", ["cios", "rns", "comb"])
def test_port_collect_through_each_route_matches_reference(
    reference_round, route, monkeypatch
):
    """One collect with every launch on one device arithmetic family (the
    CIOS engine, as routed, or the RNS route inside
    `powm.forced_rns_route()`; the batch inverse always takes the CIOS
    engine's tree) adopts the key the JAX collect adopts. `comb`: the
    CIOS engine with the JAX package's grouping rule (groups of 4 rows,
    any count), so the ring-Pedersen column's groups take the fixed-base
    comb at this size. On the column path (FSDKRC_RLC, FSDKRC_MULTIEXP
    and FSDKRC_RANGEOPT off): the Straus and shared-exponent kernels,
    which the RLC folds and the joint layouts launch, have no RNS form,
    and the ring-Pedersen comb rows fold away under RLC."""
    from fsdkr_tpu_torch.backend import powm
    from fsdkr_tpu_torch.ops import montgomery, montgomery_kernels, rns

    monkeypatch.setenv("FSDKRC_RLC", "0")
    monkeypatch.setenv("FSDKRC_MULTIEXP", "0")
    monkeypatch.setenv("FSDKRC_RANGEOPT", "0")

    def refuse(*args, **kwargs):
        raise AssertionError("a launch left the forced route")

    combs = []
    if route == "rns":
        monkeypatch.setattr(montgomery.BatchModExp, "modexp", refuse)
        monkeypatch.setattr(montgomery.BatchModExp, "modmul", refuse)
    else:
        monkeypatch.setattr(rns, "rns_modexp", refuse)
        monkeypatch.setattr(rns, "rns_modmul", refuse)
    if route == "comb":
        monkeypatch.setattr(powm, "_SHARED_MIN_ROWS", 4)
        raw = montgomery_kernels.comb
        monkeypatch.setattr(montgomery_kernels, "comb",
                            lambda *a, **kw: combs.append(1) or raw(*a, **kw))
    keys, msgs, dks = reference_round
    jax_key = copy.deepcopy(keys[0])
    JaxRefresh.collect(
        copy.deepcopy(msgs), jax_key, copy.deepcopy(dks[0]), config=JAX_CONFIG
    )
    port_key = from_reference(keys[0])
    with powm.forced_rns_route() if route == "rns" else contextlib.nullcontext():
        RefreshMessage.collect(
            from_reference(msgs), port_key, from_reference(dks[0]), config=PORT_CONFIG
        )
    assert key_fields(port_key) == key_fields(jax_key)
    assert bool(combs) == (route == "comb")


def test_host_backend_collect_matches_reference_collect(reference_round):
    """The port's pure-Python verifier (backend="host": HostBatchVerifier
    and CPython pow columns) adopts the same keys as the JAX collect."""
    from fsdkr_tpu_torch.backend import HostBatchVerifier as PortHost
    from fsdkr_tpu_torch.backend import get_backend

    config = dataclasses.replace(PORT_CONFIG, backend="host")
    assert type(get_backend(config)._inner) is PortHost
    _collect_like_reference(reference_round, config)


def _tamper(proof, field):
    return dataclasses.replace(proof, **{field: getattr(proof, field) + 1})


@pytest.mark.parametrize("field", ["s1", "s2", "u3"])
def test_tampered_pdl_row_blames_like_reference(reference_round, field):
    keys, msgs, dks = reference_round
    sender, row = 1, 2
    bad = copy.deepcopy(msgs)
    bad[sender].pdl_proof_vec[row] = _tamper(bad[sender].pdl_proof_vec[row], field)

    # the JAX host verifier's verdict on the tampered row, and JAX collect
    key = keys[0]
    st = jpdl.PDLwSlackStatement(
        ciphertext=bad[sender].points_encrypted_vec[row],
        ek=key.paillier_key_vec[row],
        Q=bad[sender].points_committed_vec[row],
        G=jsecp.GENERATOR,
        h1=key.h1_h2_n_tilde_vec[row].g,
        h2=key.h1_h2_n_tilde_vec[row].ni,
        N_tilde=key.h1_h2_n_tilde_vec[row].N,
    )
    (verdict,) = HostBatchVerifier(JAX_CONFIG.hash_alg).verify_pdl(
        [(bad[sender].pdl_proof_vec[row], st)]
    )
    assert verdict is not None
    with pytest.raises(JaxPDLError) as jax_err:
        JaxRefresh.collect(
            copy.deepcopy(bad), copy.deepcopy(key), copy.deepcopy(dks[0]),
            config=JAX_CONFIG,
        )

    with pytest.raises(PDLwSlackProofError) as port_err:
        RefreshMessage.collect(
            from_reference(bad), from_reference(key), from_reference(dks[0]),
            config=PORT_CONFIG,
        )
    e, j = port_err.value, jax_err.value
    assert type(e).__name__ == type(j).__name__
    assert (e.is_u1_eq, e.is_u2_eq, e.is_u3_eq) == (
        j.is_u1_eq, j.is_u2_eq, j.is_u3_eq
    ) == tuple(verdict)
    assert e.party_index == bad[sender].party_index


def test_port_distribute_passes_reference_collect():
    keys = jax_keygen(T, N, JAX_CONFIG)
    port_keys = from_reference(keys)
    out = RefreshMessage.distribute_batch(
        [(k.i, k) for k in port_keys], N, PORT_CONFIG
    )
    port_msgs = [m for m, _ in out]
    jax_msgs = to_reference(port_msgs)
    for i in range(N):
        jax_key = to_reference(port_keys[i])
        JaxRefresh.collect(
            jax_msgs, jax_key, to_reference(out[i][1]), config=JAX_CONFIG
        )
        RefreshMessage.collect(port_msgs, port_keys[i], out[i][1], config=PORT_CONFIG)
        assert key_fields(port_keys[i]) == key_fields(jax_key)
    # t+1 refreshed shares interpolate to the unchanged group key
    secret = vss.VerifiableSS(vss.ShamirSecretSharing(T, N)).reconstruct(
        [0, 1], [port_keys[0].keys_linear.x_i, port_keys[1].keys_linear.x_i]
    )
    assert GENERATOR * secret == port_keys[0].y_sum_s


def _tamper_family(msgs, family):
    """Break one proof of one family in message 1 (list items replaced,
    dataclasses rebuilt)."""
    bad = copy.deepcopy(msgs)
    msg = bad[1]
    if family == "range":
        msg.range_proofs[2] = _tamper(msg.range_proofs[2], "s")
    elif family == "ring_pedersen":
        proof = msg.ring_pedersen_proof
        msg.ring_pedersen_proof = dataclasses.replace(
            proof, Z=[proof.Z[0] + 1] + list(proof.Z[1:])
        )
    else:  # correct_key
        proof = msg.dk_correctness_proof
        msg.dk_correctness_proof = dataclasses.replace(
            proof, sigma_vec=[proof.sigma_vec[0] + 1] + list(proof.sigma_vec[1:])
        )
    return bad


@pytest.mark.parametrize("family", ["range", "ring_pedersen", "correct_key"])
def test_tampered_family_raises_like_reference(reference_round, family):
    """The range, ring-Pedersen and correct-key columns: same error class,
    same blamed party, and the key left as the reference leaves it."""
    keys, msgs, dks = reference_round
    bad = _tamper_family(msgs, family)
    jax_key = copy.deepcopy(keys[0])
    with pytest.raises(Exception) as jax_err:
        JaxRefresh.collect(
            copy.deepcopy(bad), jax_key, copy.deepcopy(dks[0]),
            config=JAX_CONFIG,
        )
    port_key = from_reference(keys[0])
    with pytest.raises(Exception) as port_err:
        RefreshMessage.collect(
            from_reference(bad), port_key, from_reference(dks[0]), config=PORT_CONFIG
        )
    e, j = port_err.value, jax_err.value
    assert type(e).__name__ == type(j).__name__
    assert type(e).__name__ in (
        "RangeProofError", "RingPedersenProofError", "PaillierVerificationError"
    )
    assert getattr(e, "party_index", None) == getattr(j, "party_index", None)
    assert key_fields(port_key) == key_fields(jax_key)


def _replace_item(vec, i, **fields):
    vec[i] = dataclasses.replace(vec[i], **fields)


# the JAX package's RLC tamper set (tests/test_tamper.py's RLC_CASES): every
# folded family, the range family (never folded) and a domain-gated row
RLC_TAMPERS = {
    "pdl_proof_s1": lambda m: _replace_item(m[1].pdl_proof_vec, 0,
                                            s1=m[1].pdl_proof_vec[0].s1 + 1),
    "range_proof_s": lambda m: _replace_item(m[1].range_proofs, 0,
                                             s=m[1].range_proofs[0].s + 1),
    "ring_pedersen_Z": lambda m: m[1].ring_pedersen_proof.Z.__setitem__(
        0, m[1].ring_pedersen_proof.Z[0] + 1),
    "correct_key_sigma": lambda m: m[1].dk_correctness_proof.sigma_vec.__setitem__(
        0, m[1].dk_correctness_proof.sigma_vec[0] + 1),
    "negative_pdl_s3": lambda m: _replace_item(m[1].pdl_proof_vec, 0, s3=-5),
}


def _err_key(e):
    return (type(e).__name__, getattr(e, "is_u1_eq", None), getattr(e, "is_u2_eq", None),
            getattr(e, "is_u3_eq", None), getattr(e, "party_index", None))


@pytest.mark.parametrize("case", sorted(RLC_TAMPERS))
def test_rlc_tamper_cases_raise_like_reference(reference_round, case, monkeypatch):
    """Each of the JAX package's RLC tamper cases raises the same error
    (class and attribution fields) in the port's collect at FSDKRC_RLC=1
    and at 0, and in the JAX package's collect at FSDKR_RLC=1 (its host
    engines, as its own RLC tests run it); the PDL error names the
    tampered sender."""
    from fsdkr_tpu.backend import rlc as jrlc
    from fsdkr_tpu_torch.backend import rlc

    keys, msgs, dks = reference_round
    bad = copy.deepcopy(msgs)
    RLC_TAMPERS[case](bad)
    with pytest.MonkeyPatch.context() as mp:
        for knob, value in (("FSDKR_RLC", "1"), ("FSDKR_DEVICE_POWM", "0"),
                            ("FSDKR_DEVICE_EC", "0")):
            mp.setenv(knob, value)
        with pytest.raises(Exception) as jax_err:
            JaxRefresh.collect(copy.deepcopy(bad), copy.deepcopy(keys[0]),
                               copy.deepcopy(dks[0]), config=JAX_CONFIG)
        assert jrlc.rlc_enabled()
    got = {}
    for leg in ("1", "0"):
        monkeypatch.setenv("FSDKRC_RLC", leg)
        rlc.stats_reset()
        with pytest.raises(Exception) as port_err:
            RefreshMessage.collect(from_reference(bad), from_reference(keys[0]),
                                   from_reference(dks[0]), config=PORT_CONFIG)
        got[leg] = _err_key(port_err.value)
        assert (rlc.stats()["rlc_groups"] > 0) == (leg == "1")
    assert got["1"] == got["0"]
    j = _err_key(jax_err.value)
    assert got["1"][0] in ("PDLwSlackProofError", "RangeProofError",
                           "RingPedersenProofError", "PaillierVerificationError")
    if got["1"][0] == "PDLwSlackProofError":
        # the port's PDL error also names the sender (the JAX package's
        # carries the verdict tuple alone)
        assert got["1"][:4] == j[:4] and got["1"][4] == bad[1].party_index
    else:
        assert got["1"] == j


def test_composite_dlog_verdicts_match_host_verifier():
    """verify_composite_dlog (the join path's check, not on collect's
    path yet) against the JAX host verifier, honest and tampered rows."""
    from fsdkr_tpu.protocol.keygen import generate_dlog_statement_proofs
    from fsdkr_tpu_torch.backend import get_backend

    st, p1, p2 = generate_dlog_statement_proofs(JAX_CONFIG)
    inverse = jdlog.DLogStatement(N=st.N, g=st.ni, ni=st.g)
    items = [
        (p1, st),
        (p2, inverse),
        (dataclasses.replace(p1, y=p1.y + 1), st),
        (p2, st),
    ]
    want = HostBatchVerifier(JAX_CONFIG.hash_alg).verify_composite_dlog(items)
    assert want == [True, True, False, False]
    got = get_backend(PORT_CONFIG).verify_composite_dlog(from_reference(items))
    assert got == want


def test_batch_inverse_fails_exactly_where_pow_does():
    from fsdkr_tpu_torch.backend.cuda_verifier import batch_inv

    m1, m2 = 3 * 5 * 7 * 1009, 2**61 - 1
    values = [2, 15, 4, 0, 11, 5, 2**61 - 2, 0, 3]
    moduli = [m1, m1, m1, m1, m2, m2, m2, m2, 7]
    want = []
    for v, m in zip(values, moduli):
        try:
            want.append(pow(v, -1, m))
        except ValueError:
            want.append(None)
    assert batch_inv(values, moduli, device="cpu") == want
    assert None in want and want.count(None) < len(want)
