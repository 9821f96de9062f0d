"""The deterministic sampling harness the port's tests share: every
sampling surface of a package's distribute (the VSS polynomial, Paillier
units, both provers' stage-1 nonces, the ring-Pedersen commitments, and
the key material, canned) patched to pure functions of what they sample
for, so the JAX package and the port give the same bytes whatever order
their draws run in (tests/test_precompute.py's harness, for both
packages)."""

import hashlib
import math
from types import SimpleNamespace

import fsdkr_tpu.core.intops as j_intops
import fsdkr_tpu.core.paillier as j_paillier
import fsdkr_tpu.core.secp256k1 as j_secp
import fsdkr_tpu.core.vss as j_vss
from fsdkr_tpu.proofs.alice_range import AliceProof as JAlice
from fsdkr_tpu.proofs.pdl_slack import PDLwSlackProof as JPDL
from fsdkr_tpu.proofs.ring_pedersen import RingPedersenProof as JRPProof
from fsdkr_tpu.proofs.ring_pedersen import RingPedersenStatement as JRPStatement

import fsdkr_tpu_torch.core.intops as p_intops
import fsdkr_tpu_torch.core.paillier as p_paillier
import fsdkr_tpu_torch.core.secp256k1 as p_secp
import fsdkr_tpu_torch.core.vss as p_vss
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.proofs.alice_range import AliceProof
from fsdkr_tpu_torch.proofs.pdl_slack import PDLwSlackProof
from fsdkr_tpu_torch.proofs.ring_pedersen import (
    RingPedersenProof,
    RingPedersenStatement,
    RingPedersenWitness,
)

Q = p_secp.N
Q3 = Q**3

JAX = SimpleNamespace(
    vss=j_vss, intops=j_intops, paillier=j_paillier, Scalar=j_secp.Scalar,
    PDL=JPDL, Alice=JAlice, RPProof=JRPProof, RPStatement=JRPStatement,
)
PORT = SimpleNamespace(
    vss=p_vss, intops=p_intops, paillier=p_paillier, Scalar=p_secp.Scalar,
    PDL=PDLwSlackProof, Alice=AliceProof, RPProof=RingPedersenProof,
    RPStatement=RingPedersenStatement,
)




def _det_below(tag, key, idx, bound):
    """A pure function of (tag, key, idx) in [0, bound): any consumption
    ORDER of per-key streams gives the same values, which a global seed
    cannot (pooled and inline runs interleave their draws)."""
    nbytes = (bound.bit_length() + 7) // 8 + 16
    seed = repr((tag, key, idx)).encode()
    out = b""
    c = 0
    while len(out) < nbytes:
        out += hashlib.sha256(seed + c.to_bytes(4, "big")).digest()
        c += 1
    return int.from_bytes(out[:nbytes], "big") % bound


def _det_unit(tag, key, idx, modulus):
    j = 0
    while True:
        r = _det_below(tag, (key, j), idx, modulus)
        if r and math.gcd(r, modulus) == 1:
            return r
        j += 1


def canned_material(config, count):
    """Key material made once by the JAX package: `count` (ek, dk) pairs
    and ring-Pedersen (statement, witness) pairs at `config`'s width,
    and the port's carried copies."""
    kb = j_paillier.keygen_batch(config.paillier_bits, count)
    rp = JRPStatement.generate_batch(count, config)
    port_kb = [(from_reference(ek), from_reference(dk)) for ek, dk in kb]
    port_rp = [
        (from_reference(st), RingPedersenWitness(p=w.p, q=w.q, lam=w.lam, phi=w.phi))
        for st, w in rp
    ]
    return {"jax": (kb, rp), "port": (port_kb, port_rp)}


def install_samplers(monkeypatch, pkg, canned_pair, bits):
    """Patch every sampling surface of `pkg`'s distribute to the
    deterministic streams; returns a reset() for the next arm."""
    counters = {}
    kb, rp = canned_pair
    cursors = {"k": 0, "r": 0}

    def nxt(key):
        v = counters.get(key, 0)
        counters[key] = v + 1
        return v

    def det_sample_poly(t, n, secret):
        k = nxt(("poly", t, n, secret.v))
        coeffs = [secret] + [
            pkg.Scalar(_det_below("poly", (t, n, secret.v, k), j, Q)) for j in range(t)
        ]
        shares = []
        for i in range(1, n + 1):
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * i + c.v) % Q
            shares.append(pkg.Scalar(acc))
        return coeffs, shares

    def det_unit(modulus):
        return _det_unit("unit", modulus, nxt(("unit", modulus)), modulus)

    def det_pdl_sample(ntv, nv):
        alpha, beta, rho, gamma = [], [], [], []
        for nt, n_ in zip(ntv, nv):
            i = nxt(("pdl", nt, n_))
            alpha.append(_det_below("pdl.alpha", (nt, n_), i, Q3))
            beta.append(1 + _det_below("pdl.beta", (nt, n_), i, n_ - 1))
            rho.append(_det_below("pdl.rho", (nt, n_), i, Q * nt))
            gamma.append(_det_below("pdl.gamma", (nt, n_), i, Q3 * nt))
        return alpha, beta, rho, gamma

    def det_alice_sample(ntv, nv, q_=Q):
        alpha, beta, gamma, rho = [], [], [], []
        for nt, n_ in zip(ntv, nv):
            i = nxt(("alice", nt, n_))
            alpha.append(_det_below("alice.alpha", (nt, n_), i, Q3))
            beta.append(_det_unit("alice.beta", (nt, n_), i, n_))
            gamma.append(_det_below("alice.gamma", (nt, n_), i, Q3 * nt))
            rho.append(_det_below("alice.rho", (nt, n_), i, Q * nt))
        return alpha, beta, gamma, rho

    def det_rp_sample(witnesses, m_security=32):
        out = []
        for w in witnesses:
            i = nxt(("rp", w.phi))
            out.append([_det_below("rp.a", (w.phi, i), j, w.phi) for j in range(m_security)])
        return out

    def canned_keygen_batch(b, count):
        assert b == bits
        got = kb[cursors["k"] : cursors["k"] + count]
        cursors["k"] += count
        assert len(got) == count, "canned key material exhausted"
        # fresh dk objects: collect zeroizes them
        return [(ek, type(dk)(dk.p, dk.q)) for ek, dk in got]

    def canned_generate_batch(count, config=None):
        got = rp[cursors["r"] : cursors["r"] + count]
        cursors["r"] += count
        assert len(got) == count, "canned ring-Pedersen material exhausted"
        return list(got)

    monkeypatch.setattr(pkg.vss, "sample_poly", det_sample_poly)
    monkeypatch.setattr(pkg.intops, "sample_unit", det_unit)
    monkeypatch.setattr(pkg.PDL, "sample_stage1", staticmethod(det_pdl_sample))
    monkeypatch.setattr(pkg.Alice, "sample_stage1", staticmethod(det_alice_sample))
    monkeypatch.setattr(pkg.RPProof, "sample_commit", staticmethod(det_rp_sample))
    monkeypatch.setattr(pkg.paillier, "keygen_batch", canned_keygen_batch)
    monkeypatch.setattr(pkg.RPStatement, "generate_batch", staticmethod(canned_generate_batch))

    def reset():
        counters.clear()
        cursors["k"] = cursors["r"] = 0

    return reset
