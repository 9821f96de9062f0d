"""Carrying state across from the JAX package, and back.

`from_reference(obj)` turns the JAX package's protocol objects —
`LocalKey`, `RefreshMessage`, `JoinMessage`, Paillier keys, proofs,
statements, VSS schemes, `Point`, `Scalar` — into this package's. It
works by class name and attribute names (duck typing) and never imports
the JAX package.

`to_fields(obj)` is the converse direction's first half: plain nested
dicts of ints (each tagged with its class name), from which
`from_fields(fields, classes)` rebuilds objects with any class table —
this package's (what `from_reference` does) or the JAX package's (what a
differential test does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .core.paillier import DecryptionKey, EncryptionKey
from .core.secp256k1 import Point, Scalar
from .core.vss import ShamirSecretSharing, VerifiableSS
from .proofs.alice_range import AliceProof
from .proofs.composite_dlog import CompositeDLogProof, DLogStatement
from .proofs.correct_key import NiCorrectKeyProof
from .proofs.pdl_slack import PDLwSlackProof
from .proofs.ring_pedersen import RingPedersenProof, RingPedersenStatement
from .protocol.join import JoinMessage
from .protocol.local_key import LocalKey, PaillierKeyPair, SharedKeys
from .protocol.refresh import RefreshMessage

__all__ = ["from_reference", "to_fields", "from_fields", "PORT_CLASSES"]

_CLASS = "__class__"

PORT_CLASSES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (
        Point, Scalar, EncryptionKey, DecryptionKey, ShamirSecretSharing,
        VerifiableSS, DLogStatement, CompositeDLogProof, NiCorrectKeyProof,
        PDLwSlackProof, AliceProof, RingPedersenStatement, RingPedersenProof,
        SharedKeys, PaillierKeyPair, LocalKey, RefreshMessage, JoinMessage,
    )
}


def to_fields(obj: Any) -> Any:
    """Plain nested dicts / lists of ints: dataclasses by their fields,
    points by (x, y, infinity); each dict carries its class name."""
    if obj is None or isinstance(obj, (bool, int, str, bytes)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [to_fields(v) for v in obj]
    name = type(obj).__name__
    if name == "Point":
        return {_CLASS: name, "x": obj.x, "y": obj.y, "infinity": obj.infinity}
    if dataclasses.is_dataclass(obj):
        out = {_CLASS: name}
        for f in dataclasses.fields(obj):
            out[f.name] = to_fields(getattr(obj, f.name))
        return out
    raise TypeError(f"cannot carry a {name}")


def from_fields(fields: Any, classes: Dict[str, type]) -> Any:
    """Rebuild objects from `to_fields` output with the class table
    `classes` (class name -> class). A field the target class lacks is
    dropped when its value is None (an unset optional) and refused
    otherwise. A VSS scheme's delegation certificate (`delegate_cert`)
    is a field of both packages' VerifiableSS, so it carries both ways."""
    if isinstance(fields, list):
        return [from_fields(v, classes) for v in fields]
    if not isinstance(fields, dict):
        return fields
    name = fields[_CLASS]
    cls = classes[name]
    if name == "Point":
        if fields["infinity"]:
            return cls(None, None)
        return cls(fields["x"], fields["y"])
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in fields.items():
        if key == _CLASS:
            continue
        if key not in known:
            if value is None:
                continue
            raise ValueError(f"{name}.{key} has no counterpart in {cls}")
        kwargs[key] = from_fields(value, classes)
    return cls(**kwargs)


def from_reference(obj: Any) -> Any:
    """The JAX package's object (or list of them) as this package's."""
    return from_fields(to_fields(obj), PORT_CLASSES)
