"""The port's wire format (`protocol.serialization`) against the JAX
package's: for the same object both packages write the same bytes, each
decodes the other's, and malformed bytes fail at decode with the same
exception class, at TEST_CONFIG sizes (t=1, n=3).

- A RefreshMessage without and with an MSM-delegation certificate, a
  JoinMessage and a LocalKey: the port's JSON of the carried object is
  the JAX package's, byte for byte, and decoding it again in either
  package writes the same bytes.
- The JAX package's JSON of a round, decoded by the port and collected,
  adopts the key the JAX collect adopts; with certificates (the JAX
  package's FSDKR_DELEGATE), honest, forged or beside a tampered share
  point, the port (which checks no certificate) gives the verdict the
  JAX collect gives at FSDKR_DELEGATE=1.
- The decode-time cases of tests/test_wire_negative.py (off-curve point,
  non-canonical x, bad prefix, truncated JSON, missing field, the
  non-canonical integers) as one parametrised test.
"""

import copy
import dataclasses
import json

import pytest

from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.core.secp256k1 import P
from fsdkr_tpu.protocol import JoinMessage as JaxJoin
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import serialization as jser
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.carry import from_reference, to_fields
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.protocol import serialization as ser

N, T = 3, 1
PORT_HOST = dataclasses.replace(PORT_CONFIG, backend="host")


def _jax_round(delegate):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        mp.setenv("FSDKR_DELEGATE", delegate)
        keys = jax_keygen(T, N, JAX_CONFIG)
        pre = copy.deepcopy(keys)
        out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], N, JAX_CONFIG)
    return pre, keys, [m for m, _ in out], [dk for _, dk in out]


@pytest.fixture(scope="module")
def reference_round():
    """(keys before distribute, keys after, messages, new dks), no
    certificates."""
    return _jax_round("0")


@pytest.fixture(scope="module")
def delegated_round():
    return _jax_round("1")


@pytest.fixture(scope="module")
def join_message():
    join, _pair = JaxJoin.distribute(JAX_CONFIG)
    join.set_party_index(N + 1)
    return join


CODECS = {
    "refresh": (ser.refresh_message_to_json, ser.refresh_message_from_json,
                jser.refresh_message_to_json, jser.refresh_message_from_json),
    "join": (ser.join_message_to_json, ser.join_message_from_json,
             jser.join_message_to_json, jser.join_message_from_json),
    "local_key": (ser.local_key_to_json, ser.local_key_from_json,
                  jser.local_key_to_json, jser.local_key_from_json),
}


def _wire_objects(reference_round, delegated_round, join_message):
    _, keys, msgs, _ = reference_round
    return {
        "refresh": msgs[1],
        "refresh_with_cert": delegated_round[2][1],
        "join": join_message,
        "local_key": keys[0],
    }


@pytest.mark.parametrize("what", ["refresh", "refresh_with_cert", "join", "local_key"])
def test_port_writes_the_reference_bytes(reference_round, delegated_round, join_message, what):
    obj = _wire_objects(reference_round, delegated_round, join_message)[what]
    enc, dec, jenc, jdec = CODECS[what.replace("_with_cert", "")]
    want = jenc(obj)
    assert ("delegate_cert" in want) == (what == "refresh_with_cert")
    port_obj = from_reference(obj)
    assert enc(port_obj) == want
    # each package decodes the other's bytes into the same object
    back = dec(want)
    assert to_fields(back) == to_fields(port_obj)
    assert enc(back) == want
    assert jenc(jdec(enc(port_obj))) == want


def test_reference_json_collected_by_the_port(reference_round):
    """Every broadcast crosses the JAX package's wire; the port decodes
    and collects it and adopts what the JAX collect adopts."""
    _, keys, msgs, dks = reference_round
    wire = [jser.refresh_message_to_json(m) for m in msgs]
    port_msgs = [ser.refresh_message_from_json(w) for w in wire]
    key = ser.local_key_from_json(jser.local_key_to_json(keys[2]))
    dk = from_reference(dks[2])
    RefreshMessage.collect(port_msgs, key, dk, config=PORT_HOST)

    want = copy.deepcopy(keys[2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        JaxRefresh.collect([jser.refresh_message_from_json(w) for w in wire], want,
                           copy.deepcopy(dks[2]), (), JAX_CONFIG)
    assert ser.local_key_to_json(key) == jser.local_key_to_json(want)


@pytest.mark.parametrize("case", ["honest", "forged_cert", "tampered_point"])
def test_certified_json_collected_by_the_port(delegated_round, case):
    """Messages carrying the JAX package's delegation certificates cross
    its wire; the port's collect, which validates every share by its own
    Feldman path, adopts the key or raises the error that the JAX
    collect at FSDKR_DELEGATE=1 does."""
    from fsdkr_tpu.core.secp256k1 import GENERATOR as JAX_G
    from fsdkr_tpu.proofs import msm_delegate as jdel

    _, keys, msgs, dks = delegated_round
    msgs = copy.deepcopy(msgs)
    if case == "forged_cert":
        vss = msgs[0].coefficients_committed_vec
        vss.delegate_cert = vss.delegate_cert + JAX_G
    elif case == "tampered_point":
        msgs[1].points_committed_vec[2] = msgs[1].points_committed_vec[2] + JAX_G
    wire = [jser.refresh_message_to_json(m) for m in msgs]
    assert all("delegate_cert" in w for w in wire)

    key = ser.local_key_from_json(jser.local_key_to_json(keys[2]))
    want = copy.deepcopy(keys[2])
    outcome = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDKR_DELEGATE", "1")
        mp.setenv("FSDKR_DEVICE_POWM", "0")
        mp.setenv("FSDKR_DEVICE_EC", "0")
        jdel.stats_reset()
        for collect in (
            lambda: RefreshMessage.collect([ser.refresh_message_from_json(w) for w in wire],
                                           key, from_reference(dks[2]), config=PORT_HOST),
            lambda: JaxRefresh.collect([jser.refresh_message_from_json(w) for w in wire],
                                       want, copy.deepcopy(dks[2]), (), JAX_CONFIG),
        ):
            try:
                collect()
                outcome.append(None)
            except Exception as e:  # noqa: BLE001 - compared below
                outcome.append((type(e).__name__, str(e)))
        stats = jdel.stats()
    assert outcome[0] == outcome[1]
    assert (outcome[0] is None) == (case != "tampered_point")
    assert stats["certs_rejected"] == (0 if case == "honest" else 1)
    if outcome[0] is None:
        assert ser.local_key_to_json(key) == jser.local_key_to_json(want)


def _off_curve_x():
    """The first x whose x^3 + 7 is a non-residue mod P."""
    for x in range(2, 40):
        if pow((x ** 3 + 7) % P, (P - 1) // 2, P) != 1:
            return x
    raise AssertionError("no non-residue below 40")


# each mutates the decoded JSON dict of a RefreshMessage (a dict -> a dict),
# or the text itself (a str -> a str)
WIRE_NEGATIVES = {
    "off_curve_point": lambda d: d.__setitem__(
        "public_key", "02" + _off_curve_x().to_bytes(32, "big").hex()),
    "non_canonical_x": lambda d: d.__setitem__(
        "public_key", "02" + (P + 1).to_bytes(32, "big").hex()),
    "bad_prefix": lambda d: d["points_committed_vec"].__setitem__(
        0, "07" + (5).to_bytes(32, "big").hex()),
    "truncated_json": lambda text: text[: len(text) // 2],
    "missing_field": lambda d: d.pop("ek"),
    "neg_range_s1": lambda d: d["range_proofs"][0].__setitem__(
        "s1", "-" + d["range_proofs"][0]["s1"]),
    "neg_pdl_s3": lambda d: d["pdl_proof_vec"][0].__setitem__(
        "s3", "-" + d["pdl_proof_vec"][0]["s3"]),
    "neg_ringped_Z": lambda d: d["ring_pedersen_proof"]["Z"].__setitem__(
        0, "-" + d["ring_pedersen_proof"]["Z"][0]),
    "neg_ciphertext": lambda d: d["points_encrypted_vec"].__setitem__(
        0, "-" + d["points_encrypted_vec"][0]),
    "neg_statement_N": lambda d: d["ring_pedersen_statement"].__setitem__(
        "N", "-" + d["ring_pedersen_statement"]["N"]),
    "prefixed_hex": lambda d: d["pdl_proof_vec"][0].__setitem__("z", "0xAB"),
    "underscore_hex": lambda d: d["ek"].__setitem__("n", "12_34"),
    "empty_hex": lambda d: d["range_proofs"][0].__setitem__("e", ""),
}


@pytest.mark.parametrize("name", list(WIRE_NEGATIVES))
def test_malformed_wire_fails_at_decode_as_reference(reference_round, name):
    _, _, msgs, _ = reference_round
    text = jser.refresh_message_to_json(msgs[1])
    if name == "truncated_json":
        bad = WIRE_NEGATIVES[name](text)
    else:
        d = json.loads(text)
        WIRE_NEGATIVES[name](d)
        bad = json.dumps(d, sort_keys=True)
    raised = []
    for decode in (ser.refresh_message_from_json, jser.refresh_message_from_json):
        with pytest.raises(Exception) as info:
            decode(bad)
        raised.append(info.type)
    port, jax = raised
    assert port.__name__ == jax.__name__
    assert issubclass(port, (ValueError, KeyError))
