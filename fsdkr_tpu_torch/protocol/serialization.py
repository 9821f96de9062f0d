"""Canonical wire serialization for protocol messages and key material.

The reference derives serde on every broadcast message
(`src/refresh_message.rs:29-30`, `src/add_party_message.rs:34-35`) and on
`LocalKey`; the refresh state surface is exactly the checkpoint/resume
surface. This module is the JAX package's canonical JSON encoding, byte
for byte: integers as lowercase hex strings, points as hex compressed
SEC1, field names matching the dataclasses, keys sorted. Type-level
parameters such as the hash choice are not wire data (reference quirk
7). Decoding is strict: a non-canonical integer, a bad point prefix, an
off-curve or non-canonical point raises ValueError; truncated JSON
raises json's ValueError, a missing field KeyError.
"""

from __future__ import annotations

import json

from ..core.paillier import DecryptionKey, EncryptionKey
from ..core.secp256k1 import Point, Scalar
from ..core.vss import ShamirSecretSharing, VerifiableSS
from ..proofs.alice_range import AliceProof
from ..proofs.composite_dlog import CompositeDLogProof, DLogStatement
from ..proofs.correct_key import NiCorrectKeyProof
from ..proofs.pdl_slack import PDLwSlackProof
from ..proofs.ring_pedersen import RingPedersenProof, RingPedersenStatement
from .join import JoinMessage
from .local_key import LocalKey, SharedKeys
from .refresh import RefreshMessage

__all__ = [
    "refresh_message_to_json",
    "refresh_message_from_json",
    "join_message_to_json",
    "join_message_from_json",
    "local_key_to_json",
    "local_key_from_json",
]


# ---- primitives -----------------------------------------------------------
def _int_enc(x: int) -> str:
    return format(x, "x")


_HEX = frozenset("0123456789abcdef")


def _int_dec(s: str) -> int:
    """Strict canonical decode: lowercase hex magnitude only. int(s, 16)
    would admit a leading minus (letting an attacker smuggle negative
    values into exponent/transcript positions), '+', underscores, and
    whitespace — none of which the encoder ever emits. Malformed wire
    bytes fail closed HERE, at message decode, where the caller knows
    exactly which party sent them."""
    if not isinstance(s, str) or not s or not _HEX.issuperset(s):
        raise ValueError(f"non-canonical wire integer: {s!r:.40}")
    return int(s, 16)


def _point_enc(p: Point) -> str:
    return p.to_bytes(compressed=True).hex()


def _point_dec(s: str) -> Point:
    return Point.from_bytes(bytes.fromhex(s))


def _ek_enc(ek: EncryptionKey) -> dict:
    return {"n": _int_enc(ek.n)}


def _ek_dec(d: dict) -> EncryptionKey:
    n = _int_dec(d["n"])
    return EncryptionKey(n=n, nn=n * n)


def _vss_enc(v: VerifiableSS) -> dict:
    # the delegation certificate (VerifiableSS.delegate_cert) is optional
    # on the wire: the key is emitted ONLY when present, so
    # certificate-free messages byte-match the pre-delegation encoding
    out = {
        "threshold": v.parameters.threshold,
        "share_count": v.parameters.share_count,
        "commitments": [_point_enc(c) for c in v.commitments],
    }
    if v.delegate_cert is not None:
        out["delegate_cert"] = _point_enc(v.delegate_cert)
    return out


def _vss_dec(d: dict) -> VerifiableSS:
    cert = d.get("delegate_cert")
    return VerifiableSS(
        parameters=ShamirSecretSharing(d["threshold"], d["share_count"]),
        commitments=[_point_dec(c) for c in d["commitments"]],
        delegate_cert=_point_dec(cert) if cert is not None else None,
    )


def _dlog_enc(st: DLogStatement) -> dict:
    return {"N": _int_enc(st.N), "g": _int_enc(st.g), "ni": _int_enc(st.ni)}


def _dlog_dec(d: dict) -> DLogStatement:
    return DLogStatement(N=_int_dec(d["N"]), g=_int_dec(d["g"]), ni=_int_dec(d["ni"]))


def _pdl_enc(p: PDLwSlackProof) -> dict:
    return {
        "z": _int_enc(p.z),
        "u1": _point_enc(p.u1),
        "u2": _int_enc(p.u2),
        "u3": _int_enc(p.u3),
        "s1": _int_enc(p.s1),
        "s2": _int_enc(p.s2),
        "s3": _int_enc(p.s3),
    }


def _pdl_dec(d: dict) -> PDLwSlackProof:
    return PDLwSlackProof(
        z=_int_dec(d["z"]),
        u1=_point_dec(d["u1"]),
        u2=_int_dec(d["u2"]),
        u3=_int_dec(d["u3"]),
        s1=_int_dec(d["s1"]),
        s2=_int_dec(d["s2"]),
        s3=_int_dec(d["s3"]),
    )


def _alice_enc(p: AliceProof) -> dict:
    return {k: _int_enc(getattr(p, k)) for k in ("z", "e", "s", "s1", "s2")}


def _alice_dec(d: dict) -> AliceProof:
    return AliceProof(**{k: _int_dec(d[k]) for k in ("z", "e", "s", "s1", "s2")})


def _rp_st_enc(st: RingPedersenStatement) -> dict:
    return {"S": _int_enc(st.S), "T": _int_enc(st.T), "N": _int_enc(st.N)}


def _rp_st_dec(d: dict) -> RingPedersenStatement:
    n = _int_dec(d["N"])
    return RingPedersenStatement(
        S=_int_dec(d["S"]), T=_int_dec(d["T"]), N=n, ek=EncryptionKey.from_n(n)
    )


def _rp_proof_enc(p: RingPedersenProof) -> dict:
    return {"A": [_int_enc(a) for a in p.A], "Z": [_int_enc(z) for z in p.Z]}


def _rp_proof_dec(d: dict) -> RingPedersenProof:
    return RingPedersenProof(
        A=[_int_dec(a) for a in d["A"]], Z=[_int_dec(z) for z in d["Z"]]
    )


def _ck_enc(p: NiCorrectKeyProof) -> dict:
    return {"sigma_vec": [_int_enc(s) for s in p.sigma_vec]}


def _ck_dec(d: dict) -> NiCorrectKeyProof:
    return NiCorrectKeyProof(sigma_vec=[_int_dec(s) for s in d["sigma_vec"]])


def _cdl_enc(p: CompositeDLogProof) -> dict:
    return {"x_commit": _int_enc(p.x_commit), "y": _int_enc(p.y)}


def _cdl_dec(d: dict) -> CompositeDLogProof:
    return CompositeDLogProof(x_commit=_int_dec(d["x_commit"]), y=_int_dec(d["y"]))


# ---- RefreshMessage -------------------------------------------------------
def refresh_message_to_json(m: RefreshMessage) -> str:
    return json.dumps(
        {
            "old_party_index": m.old_party_index,
            "party_index": m.party_index,
            "pdl_proof_vec": [_pdl_enc(p) for p in m.pdl_proof_vec],
            "range_proofs": [_alice_enc(p) for p in m.range_proofs],
            "coefficients_committed_vec": _vss_enc(m.coefficients_committed_vec),
            "points_committed_vec": [_point_enc(p) for p in m.points_committed_vec],
            "points_encrypted_vec": [_int_enc(c) for c in m.points_encrypted_vec],
            "dk_correctness_proof": _ck_enc(m.dk_correctness_proof),
            "dlog_statement": _dlog_enc(m.dlog_statement),
            "ek": _ek_enc(m.ek),
            "remove_party_indices": list(m.remove_party_indices),
            "public_key": _point_enc(m.public_key),
            "ring_pedersen_statement": _rp_st_enc(m.ring_pedersen_statement),
            "ring_pedersen_proof": _rp_proof_enc(m.ring_pedersen_proof),
        },
        sort_keys=True,
    )


def refresh_message_from_json(s: str) -> RefreshMessage:
    d = json.loads(s)
    return RefreshMessage(
        old_party_index=d["old_party_index"],
        party_index=d["party_index"],
        pdl_proof_vec=[_pdl_dec(p) for p in d["pdl_proof_vec"]],
        range_proofs=[_alice_dec(p) for p in d["range_proofs"]],
        coefficients_committed_vec=_vss_dec(d["coefficients_committed_vec"]),
        points_committed_vec=[_point_dec(p) for p in d["points_committed_vec"]],
        points_encrypted_vec=[_int_dec(c) for c in d["points_encrypted_vec"]],
        dk_correctness_proof=_ck_dec(d["dk_correctness_proof"]),
        dlog_statement=_dlog_dec(d["dlog_statement"]),
        ek=_ek_dec(d["ek"]),
        remove_party_indices=list(d["remove_party_indices"]),
        public_key=_point_dec(d["public_key"]),
        ring_pedersen_statement=_rp_st_dec(d["ring_pedersen_statement"]),
        ring_pedersen_proof=_rp_proof_dec(d["ring_pedersen_proof"]),
    )


# ---- JoinMessage ----------------------------------------------------------
def join_message_to_json(m: JoinMessage) -> str:
    return json.dumps(
        {
            "ek": _ek_enc(m.ek),
            "dk_correctness_proof": _ck_enc(m.dk_correctness_proof),
            "party_index": m.party_index,
            "dlog_statement": _dlog_enc(m.dlog_statement),
            "composite_dlog_proof_base_h1": _cdl_enc(m.composite_dlog_proof_base_h1),
            "composite_dlog_proof_base_h2": _cdl_enc(m.composite_dlog_proof_base_h2),
            "ring_pedersen_statement": _rp_st_enc(m.ring_pedersen_statement),
            "ring_pedersen_proof": _rp_proof_enc(m.ring_pedersen_proof),
        },
        sort_keys=True,
    )


def join_message_from_json(s: str) -> JoinMessage:
    d = json.loads(s)
    return JoinMessage(
        ek=_ek_dec(d["ek"]),
        dk_correctness_proof=_ck_dec(d["dk_correctness_proof"]),
        party_index=d["party_index"],
        dlog_statement=_dlog_dec(d["dlog_statement"]),
        composite_dlog_proof_base_h1=_cdl_dec(d["composite_dlog_proof_base_h1"]),
        composite_dlog_proof_base_h2=_cdl_dec(d["composite_dlog_proof_base_h2"]),
        ring_pedersen_statement=_rp_st_dec(d["ring_pedersen_statement"]),
        ring_pedersen_proof=_rp_proof_dec(d["ring_pedersen_proof"]),
    )


# ---- LocalKey (checkpoint surface; contains secrets — caller handles) -----
def local_key_to_json(k: LocalKey) -> str:
    return json.dumps(
        {
            "paillier_dk": {"p": _int_enc(k.paillier_dk.p), "q": _int_enc(k.paillier_dk.q)},
            "pk_vec": [_point_enc(p) for p in k.pk_vec],
            "keys_linear": {
                "x_i": _int_enc(k.keys_linear.x_i.to_int()),
                "y": _point_enc(k.keys_linear.y),
            },
            "paillier_key_vec": [_ek_enc(e) for e in k.paillier_key_vec],
            "y_sum_s": _point_enc(k.y_sum_s),
            "h1_h2_n_tilde_vec": [_dlog_enc(s) for s in k.h1_h2_n_tilde_vec],
            "vss_scheme": _vss_enc(k.vss_scheme),
            "i": k.i,
            "t": k.t,
            "n": k.n,
        },
        sort_keys=True,
    )


def local_key_from_json(s: str) -> LocalKey:
    d = json.loads(s)
    return LocalKey(
        paillier_dk=DecryptionKey(
            p=_int_dec(d["paillier_dk"]["p"]), q=_int_dec(d["paillier_dk"]["q"])
        ),
        pk_vec=[_point_dec(p) for p in d["pk_vec"]],
        keys_linear=SharedKeys(
            x_i=Scalar.from_int(_int_dec(d["keys_linear"]["x_i"])),
            y=_point_dec(d["keys_linear"]["y"]),
        ),
        paillier_key_vec=[_ek_dec(e) for e in d["paillier_key_vec"]],
        y_sum_s=_point_dec(d["y_sum_s"]),
        h1_h2_n_tilde_vec=[_dlog_dec(x) for x in d["h1_h2_n_tilde_vec"]],
        vss_scheme=_vss_dec(d["vss_scheme"]),
        i=d["i"],
        t=d["t"],
        n=d["n"],
    )
