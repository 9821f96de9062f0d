"""secp256k1 elliptic-curve arithmetic (host oracle).

The capability surface the reference gets from
`curv::elliptic::curves::{Point, Scalar, Secp256k1}` (SURVEY.md §2b):
generator mul, point add, scalar arithmetic mod the group order, compressed
encoding, coordinate access, `Scalar::from(BigInt)` reduction (usage sites
`src/refresh_message.rs:67-69,443,455-463`,
`src/zk_pdl_with_slack.rs:124-127`, `src/range_proofs.rs:428-431`).

Implementation: Jacobian coordinates over CPython ints. This is the host
oracle; the protocol's batched EC (the generator fan-outs of distribute,
the PDL u1, Feldman and pk_vec checks of collect) runs on the device
through `ops.ec_batch`, and its tests hold that against this module.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

__all__ = ["P", "N", "Scalar", "Point", "GENERATOR", "CURVE_ORDER"]

# Curve parameters: y^2 = x^3 + 7 over F_P.
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

CURVE_ORDER = N


def _inv(x: int, m: int) -> int:
    return pow(x, -1, m)


@dataclass(frozen=True)
class Scalar:
    """Element of Z_N (the scalar field). Immutable."""

    v: int

    def __post_init__(self):
        object.__setattr__(self, "v", self.v % N)

    @staticmethod
    def random() -> "Scalar":
        while True:
            v = secrets.randbelow(N)
            if v:
                return Scalar(v)

    @staticmethod
    def from_int(x: int) -> "Scalar":
        return Scalar(x % N)

    @staticmethod
    def zero() -> "Scalar":
        return Scalar(0)

    def to_int(self) -> int:
        return self.v

    def __add__(self, other: "Scalar") -> "Scalar":
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar(self.v + other.v)

    def __sub__(self, other: "Scalar") -> "Scalar":
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar(self.v - other.v)

    def __mul__(self, other):
        # Scalar * Point defers to Point.__rmul__ via NotImplemented.
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar(self.v * other.v)

    def __neg__(self) -> "Scalar":
        return Scalar(-self.v)

    def invert(self) -> "Scalar":
        return Scalar(_inv(self.v, N))

    def __bool__(self) -> bool:
        return self.v != 0


class Point:
    """Curve point (affine, with identity). Immutable by convention."""

    __slots__ = ("x", "y", "infinity")

    def __init__(self, x: int | None, y: int | None):
        if x is None:
            self.x, self.y, self.infinity = 0, 0, True
        else:
            self.x, self.y, self.infinity = x, y, False

    # -- constructors ------------------------------------------------------
    @staticmethod
    def identity() -> "Point":
        return Point(None, None)

    @staticmethod
    def generator() -> "Point":
        return GENERATOR

    @staticmethod
    def from_bytes(b: bytes) -> "Point":
        if b == b"\x00":
            return Point.identity()
        if len(b) != 33 or b[0] not in (2, 3):
            raise ValueError("bad compressed point")
        x = int.from_bytes(b[1:], "big")
        if x >= P:
            raise ValueError("x coordinate not canonical")
        rhs = (pow(x, 3, P) + 7) % P
        y = pow(rhs, (P + 1) // 4, P)
        if (y * y) % P != rhs:
            raise ValueError("point not on curve")
        if (y & 1) != (b[0] & 1):
            y = P - y
        return Point(x, y)

    # -- encoding ----------------------------------------------------------
    def to_bytes(self, compressed: bool = True) -> bytes:
        if self.infinity:
            return b"\x00"
        if compressed:
            return bytes([2 | (self.y & 1)]) + self.x.to_bytes(32, "big")
        return b"\x04" + self.x.to_bytes(32, "big") + self.y.to_bytes(32, "big")

    def x_coord(self) -> int:
        if self.infinity:
            raise ValueError("identity has no coordinates")
        return self.x

    def y_coord(self) -> int:
        if self.infinity:
            raise ValueError("identity has no coordinates")
        return self.y

    # -- group law ---------------------------------------------------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, Point):
            return NotImplemented
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y

    def __hash__(self) -> int:
        return hash((self.infinity, self.x, self.y))

    def __add__(self, other: "Point") -> "Point":
        if self.infinity:
            return other
        if other.infinity:
            return self
        if self.x == other.x:
            if (self.y + other.y) % P == 0:
                return Point.identity()
            return self._double()
        lam = ((other.y - self.y) * _inv(other.x - self.x, P)) % P
        x3 = (lam * lam - self.x - other.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return Point(x3, y3)

    def _double(self) -> "Point":
        if self.infinity or self.y == 0:
            return Point.identity()
        lam = (3 * self.x * self.x * _inv(2 * self.y, P)) % P
        x3 = (lam * lam - 2 * self.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return Point(x3, y3)

    def __neg__(self) -> "Point":
        if self.infinity:
            return self
        return Point(self.x, (-self.y) % P)

    def __sub__(self, other: "Point") -> "Point":
        return self + (-other)

    def __mul__(self, scalar) -> "Point":
        k = scalar.v if isinstance(scalar, Scalar) else int(scalar) % N
        if k == 0 or self.infinity:
            return Point.identity()
        if self.x == _GX and self.y == _GY:
            # fixed-base comb for the generator: the protocol's host EC
            # cost is dominated by G-multiples (commit-point fan-out, PDL
            # u1, pk_vec interpolation, ECDSA) — the 64x16 nibble table
            # replaces ~256 doublings + ~128 adds with <= 64 mixed adds
            return _fixed_base_mul(k)
        # Jacobian double-and-add
        rx, ry, rz = 0, 1, 0  # identity in Jacobian (z=0)
        px, py, pz = self.x, self.y, 1
        for bit in bin(k)[2:]:
            rx, ry, rz = _jdouble(rx, ry, rz)
            if bit == "1":
                rx, ry, rz = _jadd(rx, ry, rz, px, py, pz)
        return _jac_to_affine(rx, ry, rz)

    __rmul__ = __mul__

    def __repr__(self) -> str:
        if self.infinity:
            return "Point(identity)"
        return f"Point(x={hex(self.x)[:12]}..., y={hex(self.y)[:12]}...)"


def _jdouble(x, y, z):
    if z == 0 or y == 0:
        return 0, 1, 0
    a = (x * x) % P
    b = (y * y) % P
    c = (b * b) % P
    d = (2 * ((x + b) * (x + b) - a - c)) % P
    e = (3 * a) % P
    f = (e * e) % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = (2 * y * z) % P
    return x3, y3, z3


def _jadd(x1, y1, z1, x2, y2, z2):
    if z1 == 0:
        return x2, y2, z2
    if z2 == 0:
        return x1, y1, z1
    z1z1 = (z1 * z1) % P
    z2z2 = (z2 * z2) % P
    u1 = (x1 * z2z2) % P
    u2 = (x2 * z1z1) % P
    s1 = (y1 * z2 * z2z2) % P
    s2 = (y2 * z1 * z1z1) % P
    if u1 == u2:
        if s1 != s2:
            return 0, 1, 0
        return _jdouble(x1, y1, z1)
    h = (u2 - u1) % P
    i = (4 * h * h) % P
    j = (h * i) % P
    r = (2 * (s2 - s1)) % P
    v = (u1 * i) % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = (2 * h * z1 * z2) % P
    return x3, y3, z3


# ---------------------------------------------------------------------------
# Fixed-base comb table for the generator: T[w][d-1] = d * 2^(4w) * G in
# affine, for 64 4-bit windows. Built lazily on the first G-multiple (~1024
# Jacobian ops + one batched inversion chain, tens of ms, once per process).
# Like the rest of this host oracle it is NOT constant-time — the oracle
# trades side-channel hardening for auditability; see README security notes.

_G_TABLE: list | None = None


def _jac_to_affine(x, y, z) -> "Point":
    """Jacobian (x, y, z) -> affine Point; the single conversion shared by
    both scalar-mul paths (auditability: one place to get it right)."""
    if z == 0:
        return Point.identity()
    zinv = _inv(z, P)
    z2 = (zinv * zinv) % P
    return Point((x * z2) % P, (y * z2 % P) * zinv % P)


def _build_g_table():
    rows = []  # Jacobian triples, 64 rows x 15 entries (d = 1..15)
    bx, by, bz = _GX, _GY, 1  # B_w = 2^(4w) * G
    for _ in range(64):
        row = [(bx, by, bz)]
        for _d in range(14):
            row.append(_jadd(*row[-1], bx, by, bz))
        rows.append(row)
        for _s in range(4):
            bx, by, bz = _jdouble(bx, by, bz)
    # batch-normalize all 960 points to affine with one inversion chain
    flat = [pt for row in rows for pt in row]
    zs = [z for _, _, z in flat]
    prefix = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * z % P
    acc = _inv(prefix[-1], P)
    zinvs = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        zinvs[i] = prefix[i] * acc % P
        acc = acc * zs[i] % P
    affine = []
    for (x, y, _z), zi in zip(flat, zinvs):
        z2 = zi * zi % P
        affine.append((x * z2 % P, y * z2 % P * zi % P))
    return [affine[w * 15 : (w + 1) * 15] for w in range(64)]


def _fixed_base_mul(k: int) -> "Point":
    global _G_TABLE
    if _G_TABLE is None:
        _G_TABLE = _build_g_table()
    rx, ry, rz = 0, 1, 0
    for w in range(64):
        d = (k >> (4 * w)) & 0xF
        if d:
            ax, ay = _G_TABLE[w][d - 1]
            rx, ry, rz = _jadd(rx, ry, rz, ax, ay, 1)
    return _jac_to_affine(rx, ry, rz)


GENERATOR = Point(_GX, _GY)
