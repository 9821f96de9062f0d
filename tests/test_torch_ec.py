"""The port's device EC (fsdkr_tpu_torch.ops.ec_batch, ops.ec_kernels and
their callers) against the JAX package's `ops/ec_batch.py` on XLA:CPU and
against the host oracles, with the port on device="cpu" (the kernels'
plain versions).

- `_fmul`, `_fadd`, `_fsub`, `_padd`, `_scalar_mul_kernel` and
  `_tree_sum_kernel`: the port's plain versions against the JAX
  functions, as projective limb tensors, bit for bit. The JAX kernels
  compile once per shape (about 20 s each here), so they run in
  module-scoped fixtures at three shapes: scalar mul at 8 rows of 256-
  and of 128-bit scalars, the tree at 2 groups of 4.
- `batch_scalar_mul`, `batch_generator_mul` and `batch_msm` against the
  port's host oracle (`core.secp256k1`), and the point conversions.
- The verifier's `_pdl_u1_batch` / `verify_pdl` and `validate_feldman`
  verdicts against the JAX package's HostBatchVerifier, row by row, on
  honest rows and rows with a tampered u1, s1 or share point;
  `combine_committed_points` against the JAX one; which EC calls a
  distribute and a collect make on the cuda backend.
- A CPU model of the kernels' word arithmetic (csrc/ec_kernels.cu): the
  8-word product and squaring, the Montgomery reduction on p's special
  form (edge operands, the branch that adds p back), the products by the
  small constants 3 and b3, the sum and the difference as complement
  carry chains, the complete addition one thread a pair (the tree) and
  on a row's 8 lanes (the scalar mul: which lane computes which product
  in which round and what it exchanges), the masked window select and
  the tree's in-place levels, against `_padd`'s statement values and the
  plain versions, with the kernel's constants read from its source.

Inputs come from numpy seeds. Every comparison is exact.
"""

import copy
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsdkr_tpu.backend.batch_verifier import HostBatchVerifier
from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.core import paillier as jpaillier
from fsdkr_tpu.core import secp256k1 as jsecp
from fsdkr_tpu.core import vss as jvss
from fsdkr_tpu.ops import ec_batch as jec
from fsdkr_tpu.proofs import alice_range as jalice
from fsdkr_tpu.proofs import composite_dlog as jdlog
from fsdkr_tpu.proofs import correct_key as jck
from fsdkr_tpu.proofs import pdl_slack as jpdl
from fsdkr_tpu.proofs import ring_pedersen as jrp
from fsdkr_tpu.protocol import local_key as jlk
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import refresh as jrefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG as PORT_CONFIG
from fsdkr_tpu_torch.backend import cuda_verifier
from fsdkr_tpu_torch.backend.batch_verifier import HostBatchVerifier as PortHost
from fsdkr_tpu_torch.carry import from_fields, from_reference, to_fields
from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, N, P, Point, Scalar
from fsdkr_tpu_torch.ops import ec_batch, ec_kernels
from fsdkr_tpu_torch.proofs.pdl_slack import PDLwSlackStatement
from fsdkr_tpu_torch.protocol import RefreshMessage
from fsdkr_tpu_torch.protocol import refresh

CU = Path(__file__).resolve().parent.parent / "fsdkr_tpu_torch" / "csrc" / "ec_kernels.cu"
R = 1 << 256
M32 = (1 << 32) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op thread
    pool only spins there, and under pytest-xdist it would take cores
    from the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rand_below(rng, n):
    return int.from_bytes(rng.bytes(48), "little") % n


def rand_point(rng):
    return GENERATOR * Scalar(1 + rand_below(rng, N - 1))


def limbs(values):
    """Python ints < 2^256 -> (rows, 16) int64 limb tensor."""
    return torch.as_tensor(ec_batch.ints_to_limbs(values, 16).astype(np.int64))


def to_jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def same(port, jax_out):
    return np.array_equal(port.numpy().astype(np.int64), np.asarray(jax_out).astype(np.int64))


def proj(points):
    """Host points as (rows, 3, 16) int64 Montgomery projective limbs."""
    return ec_batch.points_to_device(points, "cpu").to(torch.int64)


def host_msm(ps, ss):
    acc = Point.identity()
    for p, s in zip(ps, ss):
        acc = acc + p * Scalar.from_int(s)
    return acc


# ---------------------------------------------------------------------------
# field and point arithmetic against the JAX package


FIELD_VALUES = [0, 1, 2, P - 1, P - 2, R % P, (1 << 255) % P]


def _field_rows():
    rng = np.random.default_rng(11)
    vals = FIELD_VALUES + [rand_below(rng, P) for _ in range(3)]
    xs = [a for a in vals for _ in vals]
    ys = [b for _ in vals for b in vals]
    return xs, ys


@pytest.mark.parametrize("op", ["_fmul", "_fadd", "_fsub"])
def test_field_ops_match_jax(op):
    xs, ys = _field_rows()
    x, y = limbs(xs), limbs(ys)
    got = getattr(ec_batch, op)(x, y)
    want = getattr(jec, op)(to_jax(x), to_jax(y))
    assert same(got, want)
    ref = {"_fmul": lambda a, b: a * b * pow(R, -1, P) % P,
           "_fadd": lambda a, b: (a + b) % P,
           "_fsub": lambda a, b: (a - b) % P}[op]
    assert ec_batch.limbs_to_ints(got.numpy()) == [ref(a, b) for a, b in zip(xs, ys)]


def _padd_rows():
    """(p1, p2) projective rows: P+P, P+(-P), the identity on either side
    and both, distinct points, and projective inputs with Z != R (the
    outputs of a first addition)."""
    rng = np.random.default_rng(12)
    a, b, c = rand_point(rng), rand_point(rng), rand_point(rng)
    ident = Point.identity()
    first = [a, a, a, ident, ident, b, a, c]
    second = [a, -a, ident, a, ident, c, b, -c]
    p1, p2 = proj(first), proj(second)
    mixed = ec_batch._padd(p1, p2)  # Z of every kind: R-scaled, 0, other
    return torch.cat([p1, mixed]), torch.cat([p2, mixed.flip(0)]), first, second


def test_padd_matches_jax_and_the_host():
    p1, p2, first, second = _padd_rows()
    got = ec_batch._padd(p1, p2)
    assert same(got, jec._padd(to_jax(p1), to_jax(p2)))
    affine = ec_batch.device_to_points(got[: len(first)])
    assert affine == [a + b for a, b in zip(first, second)]
    assert affine[1].infinity and affine[4].infinity


def test_points_to_device_round_trip_matches_jax():
    rng = np.random.default_rng(13)
    pts = [rand_point(rng) for _ in range(4)] + [Point.identity(), GENERATOR]
    t = ec_batch.points_to_device(pts, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (6, 3, 16)
    jpts = [jsecp.Point(None, None) if p.infinity else jsecp.Point(p.x, p.y) for p in pts]
    assert same(t, jec.points_to_device(jpts))
    assert ec_batch.device_to_points(t) == pts
    assert ec_batch.device_to_points(ec_batch._identity_rows(3, "cpu")) == [Point.identity()] * 3


# ---------------------------------------------------------------------------
# the two kernels' plain versions against the JAX kernels


def _scalar_case(bits):
    """8 rows: edge scalars 0, 1, 7, N - 1 (256-bit only), 2^128 - 1, and
    random ones; an identity point row and G."""
    rng = np.random.default_rng(14 + bits)
    pts = [rand_point(rng) for _ in range(5)] + [Point.identity(), GENERATOR, rand_point(rng)]
    if bits == 256:
        scs = [0, 1, 7, N - 1, (1 << 128) - 1, rand_below(rng, N), 5, rand_below(rng, N)]
    else:
        scs = [0, 1, 7, (1 << 128) - 1, rand_below(rng, 1 << 128), 9,
               rand_below(rng, 1 << 128), 3]
    return pts, scs


@pytest.fixture(scope="module", params=[256, 128])
def scalar_case(request):
    """The JAX `_scalar_mul_kernel` once per width, on the port's inputs."""
    bits = request.param
    pts, scs = _scalar_case(bits)
    points = ec_batch.points_to_device(pts, "cpu")
    scalars = torch.as_tensor(ec_batch._scalars_to_limbs(scs, bits).astype(np.int32))
    want = np.asarray(jec._scalar_mul_kernel(to_jax(points), to_jax(scalars), scalar_bits=bits))
    return bits, pts, scs, points, scalars, want


def test_scalar_mul_matches_jax_kernel(scalar_case):
    bits, pts, scs, points, scalars, want = scalar_case
    got = ec_batch._scalar_mul_kernel(points, scalars, scalar_bits=bits)
    assert same(got, want)
    # the wrapper on a CPU tensor is the plain version
    assert same(ec_kernels.scalar_mul(points, scalars, bits), want)
    assert ec_batch.device_to_points(got) == [p * Scalar.from_int(s) for p, s in zip(pts, scs)]


@pytest.fixture(scope="module")
def tree_case():
    """2 groups of 4: a cancelling pair, a doubling, identity pads; the
    JAX `_tree_sum_kernel` once."""
    rng = np.random.default_rng(15)
    a, b, c = rand_point(rng), rand_point(rng), rand_point(rng)
    ident = Point.identity()
    groups = [[a, -a, b, ident], [c, c, ident, b]]
    points = ec_batch.points_to_device([p for g in groups for p in g], "cpu").view(2, 4, 3, 16)
    return groups, points, np.asarray(jec._tree_sum_kernel(to_jax(points)))


def test_tree_sum_matches_jax_kernel(tree_case):
    groups, points, want = tree_case
    got = ec_batch._tree_sum_kernel(points)
    assert same(got, want)
    assert same(ec_kernels.tree_sum(points.contiguous()), want)
    assert ec_batch.device_to_points(got) == [host_msm(g, [1] * 4) for g in groups]


# ---------------------------------------------------------------------------
# entry points against the host oracle


def test_batch_scalar_mul_and_generator_mul_match_host():
    rng = np.random.default_rng(16)
    pts = [rand_point(rng), Point.identity(), GENERATOR]
    scs = [rand_below(rng, N), 5, N + 3]  # reduced mod N
    assert ec_batch.batch_scalar_mul(pts, scs, device="cpu") == [
        p * Scalar.from_int(s) for p, s in zip(pts, scs)]
    scs = [0, 1, rand_below(rng, N)]
    assert ec_batch.batch_generator_mul(scs, device="cpu") == [
        GENERATOR * Scalar.from_int(s) for s in scs]
    assert ec_batch.batch_scalar_mul([], [], device="cpu") == []


def test_batch_msm_ragged_groups_match_host():
    rng = np.random.default_rng(17)
    groups_p = [
        [rand_point(rng) for _ in range(5)],
        [GENERATOR, Point.identity(), rand_point(rng)],
        [rand_point(rng)],
    ]
    groups_s = [[rand_below(rng, N) for _ in g] for g in groups_p]
    p = groups_p[2][0]
    groups_p.append([p, p])  # a cancelling group: the identity
    groups_s.append([3, N - 3])
    got = ec_batch.batch_msm(groups_p, groups_s, device="cpu")
    assert got == [host_msm(p, s) for p, s in zip(groups_p, groups_s)]
    assert got[3].infinity
    with pytest.raises(ValueError, match="group length mismatch"):
        ec_batch.batch_msm([[GENERATOR, GENERATOR]], [[1]], device="cpu")
    assert ec_batch.batch_msm([], [], device="cpu") == []


def test_scalar_staging_is_wiped(monkeypatch):
    """The scalars' numpy staging array and tensor are zeroed once the
    results are downloaded."""
    seen = []
    raw = ec_kernels.scalar_mul

    def spy(points, scalars, bits):
        seen.append(scalars)
        return raw(points, scalars, bits)

    staged = []
    raw_limbs = ec_batch._scalars_to_limbs

    def spy_limbs(scs, bits):
        staged.append(raw_limbs(scs, bits))
        return staged[-1]

    monkeypatch.setattr(ec_kernels, "scalar_mul", spy)
    monkeypatch.setattr(ec_batch, "_scalars_to_limbs", spy_limbs)
    out = ec_batch.batch_generator_mul([12345, 678], device="cpu")
    assert out == [GENERATOR * Scalar(12345), GENERATOR * Scalar(678)]
    assert not seen[0].any() and not staged[0].any()


def test_wrappers_check_their_inputs():
    pts = ec_batch.points_to_device([GENERATOR], "cpu")
    sc = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        ec_kernels.scalar_mul(pts.to(torch.int64), sc, 256)
    with pytest.raises(ValueError, match="scalar_bits"):
        ec_kernels.scalar_mul(pts, sc, 258)
    with pytest.raises(ValueError, match="scalar_bits"):
        ec_kernels.scalar_mul(pts, sc[:, :8], 256)
    with pytest.raises(ValueError, match="shape"):
        ec_kernels.scalar_mul(pts, torch.zeros((2, 16), dtype=torch.int32), 256)
    with pytest.raises(ValueError, match="2\\^j rows"):
        ec_kernels.tree_sum(torch.zeros((1, 3, 3, 16), dtype=torch.int32))
    # CPU calls run the plain version and launch nothing
    ec_kernels.reset_launch_counts()
    ec_kernels.tree_sum(pts.view(1, 1, 3, 16))
    assert ec_kernels.launch_counts() == {"ec_scalar_mul": 0, "ec_tree_sum": 0}


# ---------------------------------------------------------------------------
# the callers: verifier verdicts, pk_vec, and the EC calls a round makes

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


class _Counter:
    """Counts the calls of the EC entry points and kernel wrappers (the
    names their callers look up) while active."""

    NAMES = ((ec_batch, "batch_msm"), (ec_batch, "batch_generator_mul"),
             (ec_kernels, "scalar_mul"), (ec_kernels, "tree_sum"))

    def __init__(self, mp):
        self.calls = {name: [] for _, name in self.NAMES}
        for owner, name in self.NAMES:
            raw = getattr(owner, name)

            def spy(*args, _raw=raw, _name=name, **kwargs):
                shape = tuple(args[0].shape) if isinstance(args[0], torch.Tensor) else len(args[0])
                self.calls[_name].append(shape)
                return _raw(*args, **kwargs)

            mp.setattr(owner, name, spy)

    def counts(self):
        return {name: len(v) for name, v in self.calls.items()}


N_PARTIES, T = 3, 1


@pytest.fixture(scope="module")
def port_round():
    """One port round at TEST_CONFIG sizes on the cuda backend, device
    "cpu": keys from the JAX keygen, the port's distribute_batch with its
    EC calls counted. Consumers deep-copy before mutating."""
    keys = from_reference(jax_keygen(T, N_PARTIES, JAX_CONFIG))
    with pytest.MonkeyPatch.context() as mp:
        counter = _Counter(mp)
        out = RefreshMessage.distribute_batch([(k.i, k) for k in keys], N_PARTIES, PORT_CONFIG)
    return keys, [m for m, _ in out], [dk for _, dk in out], counter.calls


def test_distribute_makes_its_generator_muls_on_the_device(port_round):
    """The Feldman commitments (n(t+1) rows), the commit points (n^2) and
    the PDL prover's u1 (n^2): three `ec_scalar_mul` calls, no tree."""
    *_, calls = port_round
    n2 = N_PARTIES * N_PARTIES
    assert calls["batch_generator_mul"] == [N_PARTIES * (T + 1), n2, n2]
    assert calls["scalar_mul"] == [(8, 3, 16), (16, 3, 16), (16, 3, 16)]
    assert calls["tree_sum"] == [] and calls["batch_msm"] == []


def _pdl_items(msgs, key, statement_cls, generator):
    return [
        (
            msg.pdl_proof_vec[i],
            statement_cls(
                ciphertext=msg.points_encrypted_vec[i],
                ek=key.paillier_key_vec[i],
                Q=msg.points_committed_vec[i],
                G=generator,
                h1=key.h1_h2_n_tilde_vec[i].g,
                h2=key.h1_h2_n_tilde_vec[i].ni,
                N_tilde=key.h1_h2_n_tilde_vec[i].N,
            ),
        )
        for msg in msgs
        for i in range(len(msgs))
    ]


def _tampered(msgs, field):
    """Message 1's proof to receiver 2 with u1 moved by G, or s1 + 1; or
    message 2's share point for receiver 0 moved by G (Feldman)."""
    bad = copy.deepcopy(msgs)
    if field == "share":
        bad[2].points_committed_vec[0] = bad[2].points_committed_vec[0] + GENERATOR
    elif field == "u1":
        p = bad[1].pdl_proof_vec[2]
        bad[1].pdl_proof_vec[2] = dataclasses.replace(p, u1=p.u1 + GENERATOR)
    elif field == "s1":
        p = bad[1].pdl_proof_vec[2]
        bad[1].pdl_proof_vec[2] = dataclasses.replace(p, s1=p.s1 + 1)
    return bad


@pytest.mark.parametrize("field", ["honest", "u1", "s1"])
def test_pdl_verdicts_match_jax_host_verifier(port_round, field, monkeypatch):
    keys, msgs, _, _ = port_round
    bad = _tampered(msgs, field)
    key = keys[0]
    items = _pdl_items(bad, key, PDLwSlackStatement, GENERATOR)
    jax_items = _pdl_items(to_reference(bad), to_reference(key), jpdl.PDLwSlackStatement,
                           jsecp.GENERATOR)
    want = HostBatchVerifier(JAX_CONFIG.hash_alg).verify_pdl(jax_items)
    assert (want == [None] * len(items)) == (field == "honest")

    host_calls = []
    raw = cuda_verifier.CudaBatchVerifier._pdl_u1_host
    monkeypatch.setattr(cuda_verifier.CudaBatchVerifier, "_pdl_u1_host",
                        staticmethod(lambda it, e: host_calls.append(len(it)) or raw(it, e)))
    counter = _Counter(monkeypatch)
    verifier = cuda_verifier.CudaBatchVerifier(PORT_CONFIG)
    assert verifier.verify_pdl(items) == want
    # one combined MSM: u1_j, Q_j and G, 2 * 9 + 1 rows padded to 32
    assert counter.calls["batch_msm"] == [1]
    assert counter.calls["tree_sum"] == [(1, 32, 3, 16)]
    # the host per-row check runs only where the combined check failed
    assert host_calls == ([] if field == "honest" else [len(items)])
    _, state = verifier._pdl_prepare(items)
    u1_want = [v is None or v[0] for v in want]
    assert verifier._pdl_u1_batch(items, state[0]) == u1_want


@pytest.mark.parametrize("field", ["honest", "share"])
def test_feldman_verdicts_match_jax_host_verifier(port_round, field, monkeypatch):
    _, msgs, _, _ = port_round
    bad = _tampered(msgs, field)
    items = [(m.coefficients_committed_vec, m.points_committed_vec[i], i + 1)
             for m in bad for i in range(len(bad))]
    jax_items = [(m.coefficients_committed_vec, m.points_committed_vec[i], i + 1)
                 for m in to_reference(bad) for i in range(len(bad))]
    want = HostBatchVerifier(JAX_CONFIG.hash_alg).validate_feldman(jax_items)
    assert all(want) == (field == "honest")

    horner = []
    raw = PortHost.validate_feldman
    monkeypatch.setattr(PortHost, "validate_feldman",
                        lambda self, it: horner.append(len(it)) or raw(self, it))
    counter = _Counter(monkeypatch)
    got = cuda_verifier.CudaBatchVerifier(PORT_CONFIG).validate_feldman(items)
    assert got == want
    # one MSM over the 3 schemes' groups of 3 shares + 2 commitments
    assert counter.calls["tree_sum"] == [(3, 8, 3, 16)]
    # host Horner only for the failing scheme's rows
    assert horner == ([] if field == "honest" else [N_PARTIES])


def test_combine_committed_points_matches_jax(port_round):
    _, msgs, _, _ = port_round
    rng = np.random.default_rng(18)
    li = [Scalar(rand_below(rng, N)) for _ in range(T + 1)]
    want = jrefresh.combine_committed_points(
        to_reference(msgs), [jsecp.Scalar(s.v) for s in li], T, N_PARTIES)
    got = refresh.combine_committed_points(msgs, li, T, N_PARTIES, device="cpu")
    assert to_fields(got) == to_fields(from_reference(want))
    assert got == refresh.combine_committed_points(msgs, li, T, N_PARTIES)


def test_collect_gets_its_ec_from_the_device(port_round, monkeypatch):
    """An honest collect on the cuda backend: three MSMs (Feldman, PDL u1,
    pk_vec), each one scalar-mul and one tree-sum call; no per-row host
    u1 check and no host Horner. The adopted key is the host backend's
    (which tests/test_torch_refresh.py holds against the JAX collect)."""
    keys, msgs, dks, _ = port_round
    host_u1 = []
    monkeypatch.setattr(cuda_verifier.CudaBatchVerifier, "_pdl_u1_host",
                        staticmethod(lambda *a: host_u1.append(1)))
    monkeypatch.setattr(PortHost, "validate_feldman", lambda *a: host_u1.append(2))
    counter = _Counter(monkeypatch)
    key, host_key = copy.deepcopy(keys[1]), copy.deepcopy(keys[1])
    RefreshMessage.collect(msgs, key, copy.deepcopy(dks[1]), config=PORT_CONFIG)
    assert host_u1 == []
    # Feldman: 3 groups of 3 + 2, padded to 8; PDL u1: 2 * 9 + 1 rows,
    # padded to 32; pk_vec: 3 groups of t + 1 = 2
    assert counter.calls["tree_sum"] == [(3, 8, 3, 16), (1, 32, 3, 16), (3, 2, 3, 16)]
    assert counter.calls["scalar_mul"] == [(24, 3, 16), (32, 3, 16), (6, 3, 16)]
    assert counter.counts()["batch_generator_mul"] == 0
    monkeypatch.undo()
    RefreshMessage.collect(msgs, host_key, copy.deepcopy(dks[1]),
                           config=dataclasses.replace(PORT_CONFIG, backend="host"))
    assert to_fields(key) == to_fields(host_key)


def test_host_backend_takes_no_device_ec():
    host = dataclasses.replace(PORT_CONFIG, backend="host")
    assert refresh._ec_device(host) is None
    assert refresh._ec_device(PORT_CONFIG) == torch.device("cpu")


# ---------------------------------------------------------------------------
# a CPU model of the kernels' word arithmetic


def _cu_constants():
    """The kernel's constants, read from its source: p^{-1} mod 2^32, p's
    kC0 (p = 2^256 - 2^32 - kC0), b3, and the words of p and R mod p."""
    src = CU.read_text()

    def const(name):
        return int(re.search(name + r" = (0x[0-9A-Fa-f]+|\d+)u;", src).group(1), 0)

    def words(fn):
        m = re.search(fn + r"\(int j\) \{\s*return j == 0 \? (0x[0-9A-Fa-f]+)u : "
                      r"\(j == 1 \? (0x[0-9A-Fa-f]+)u : (0x[0-9A-Fa-f]+|0)u\);", src)
        w0, w1, rest = (int(g, 16) if g != "0" else 0 for g in m.groups())
        return [w0, w1] + [rest] * 6

    return (const("kPInv"), const("kC0"), const("kB3"), words("p_word"),
            words("one_m_word"))


P_INV32, C0, B3, P_WORDS, ONE_WORDS = _cu_constants()


def _u64(v):
    assert 0 <= v < 1 << 64  # a 64-bit intermediate of the kernel
    return v


def _i64(v):
    assert -(1 << 63) <= v < 1 << 63  # a signed 64-bit intermediate
    return v


def w_value(words):
    return sum(w << (32 * j) for j, w in enumerate(words))


def w_sub_chain(x, y, carries=None):
    """x - y as x + ~y + 1 over 8 words: (difference words, carry out: 1
    where x >= y); `carries` gets each word's carry out."""
    d, c = [], 1
    for j in range(8):
        c += x[j] + (~y[j] & M32)
        d.append(c & M32)
        c >>= 32
        if carries is not None:
            carries.append(c)
    return d, c


def w_add_masked_p(d, mask):
    r, c = [], 0
    for j in range(8):
        c += d[j] + (P_WORDS[j] & mask)
        r.append(c & M32)
        c >>= 32
    return r


def w_reduce_once(t):
    assert w_value(t) < 2 * P and t[8] <= 1
    d, c = w_sub_chain(t[:8], P_WORDS)
    keep = (-((c ^ 1) & (t[8] ^ 1))) & M32
    return [(t[j] & keep) | (d[j] & ~keep & M32) for j in range(8)]


def w_mul_wide(x, y):
    t = [0] * 16
    for i in range(8):
        c = 0
        for j in range(8):
            s = _u64(x[j] * y[i] + t[i + j] + c)
            t[i + j], c = s & M32, s >> 32
        t[i + 8] = c
    return t


def w_sqr_wide(x):
    """The products above the diagonal once, doubled by a funnel shift,
    then the squares on the diagonal."""
    t = [0] * 16
    for i in range(7):
        c = 0
        for j in range(i + 1, 8):
            s = _u64(x[i] * x[j] + t[i + j] + c)
            t[i + j], c = s & M32, s >> 32
        t[i + 8] = c
    assert t[15] >> 31 == 0  # the doubling loses no bit
    t = [((t[j] << 1) | (t[j - 1] >> 31)) & M32 if j else 0 for j in range(16)]
    c = 0
    for i in range(8):
        s = _u64(x[i] * x[i] + t[2 * i] + c)
        t[2 * i] = s & M32
        s = _u64(t[2 * i + 1] + (s >> 32))
        t[2 * i + 1], c = s & M32, s >> 32
    assert c == 0
    return t


def w_mont_reduce(t, borrows=None):
    """The kernel's reduction on p's special form: word i's m = T_i p^{-1}
    adds m kC0 to word i and m to word i + 1 (an unsigned running carry c);
    then T_hi + c - M in (-p, p) as T_hi + c + ~M + 1, plus p where it is
    negative. `borrows` gets the carries out of the ~M chain's words."""
    m, c = [], 0
    for i in range(8):
        w = _u64(t[i] + c)
        mi = ((w & M32) * P_INV32) & M32
        s = _u64(w + mi * C0)
        assert s & M32 == 0  # word i vanishes
        c = _u64((s >> 32) + mi)
        m.append(mi)
    u, c = [], c + 1
    for i in range(8):
        c = _u64(c + t[8 + i] + (~m[i] & M32))
        u.append(c & M32)
        c >>= 32
        if borrows is not None:
            borrows.append(c)
    assert c <= 1
    return w_add_masked_p(u, (-(c ^ 1)) & M32)


def w_fmul(x, y):
    return w_mont_reduce(w_mul_wide(x, y))


def w_fsqr(x):
    return w_mont_reduce(w_sqr_wide(x))


def w_fmul_small(k, x):
    """k x mod p: 9 words, the ninth h folded back as h c (2^256 = 2^32 +
    kC0 mod p), one conditional subtraction."""
    t, c = [], 0
    for j in range(8):
        c = _u64(c + x[j] * k)
        t.append(c & M32)
        c >>= 32
    c = _u64(t[0] + c * C0 + ((c & M32) << 32))
    t[0] = c & M32
    c >>= 32
    for j in range(1, 8):
        c += t[j]
        t[j] = c & M32
        c >>= 32
    return w_reduce_once(t + [c])


def w_fadd(x, y):
    t, c = [], 0
    for j in range(8):
        s = x[j] + y[j] + c
        t.append(s & M32)
        c = s >> 32
    return w_reduce_once(t + [c])


def w_fsub(x, y):
    d, c = w_sub_chain(x, y)
    return w_add_masked_p(d, (-(c ^ 1)) & M32)


def w_padd_values(p, q, same=False):
    """`_padd`'s statement values on 32-bit words, by name: the round-1
    products (squarings where q is p, as the kernel's doubling instance
    computes them), the round-2 values (3 t0 and the products by b3 as
    products by small constants) and the six round-3 products."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    mul = (lambda a, b: w_fsqr(a)) if same else w_fmul  # noqa: E731
    if same:
        assert p == q
    v = {"t0": mul(x1, x2), "t1": mul(y1, y2), "t2": mul(z1, z2),
         "s0": mul(w_fadd(x1, y1), w_fadd(x2, y2)), "s1": mul(w_fadd(y1, z1), w_fadd(y2, z2)),
         "s2": mul(w_fadd(x1, z1), w_fadd(x2, z2))}
    v["t3"] = w_fsub(v["s0"], w_fadd(v["t0"], v["t1"]))
    v["t4"] = w_fsub(v["s1"], w_fadd(v["t1"], v["t2"]))
    v["y3"] = w_fsub(v["s2"], w_fadd(v["t0"], v["t2"]))
    v["x3"] = w_fmul_small(3, v["t0"])
    v["b3t2"] = w_fmul_small(B3, v["t2"])
    v["z3"] = w_fadd(v["t1"], v["b3t2"])
    v["t1'"] = w_fsub(v["t1"], v["b3t2"])
    v["b3y3"] = w_fmul_small(B3, v["y3"])
    pairs = [("t3", "t1'"), ("t4", "b3y3"), ("b3y3", "x3"), ("t1'", "z3"), ("z3", "t4"),
             ("x3", "t3")]
    v["round3"] = [w_fmul(v[a], v[b]) for a, b in pairs]
    r3 = v["round3"]
    v["out"] = (w_fsub(r3[0], r3[1]), w_fadd(r3[2], r3[3]), w_fadd(r3[4], r3[5]))
    return v


def w_padd(p, q):
    """The kernel's one-thread `padd` (the tree's), in `_padd`'s statement
    order."""
    return w_padd_values(p, q)["out"]


LANES = 8  # a row's lane group in the scalar mul


def w_padd_lanes(p, q, same=False, trace=None):
    """The kernel's `padd_lanes` on one row's 8 lanes, step by step: lane g
    holds coordinate c = g mod 3 of P and Q; a shuffle reads a value of
    another lane of the group. `trace` gets each lane's round-1 product,
    T_c, W_c and round-3 product. Returns coordinate c of P + Q of every
    lane."""
    cs = [g % 3 for g in range(LANES)]
    nxt = [(c + 1) % 3 for c in cs]
    js = [g if g < 6 else g - 6 for g in range(LANES)]

    def shfl(vals, src):
        return [vals[src[g]] for g in range(LANES)]

    def each(fn, *cols):
        return [fn(*args) for args in zip(*cols)]

    def sel(cond, a, b):
        return [a[g] if cond[g] else b[g] for g in range(LANES)]

    pc, qc = [p[c] for c in cs], [q[c] for c in cs]
    s_lane = [3 <= g < 6 for g in range(LANES)]
    # round 1: lanes 0-2 D_c = P_c Q_c, lanes 3-5 S_c, lanes 6, 7 repeat 0, 1
    x = sel(s_lane, each(w_fadd, pc, shfl(pc, nxt)), pc)
    if same:
        x = each(w_fsqr, x)
    else:
        x = each(w_fmul, x, sel(s_lane, each(w_fadd, qc, shfl(qc, nxt)), qc))
    # T_c = S_c - (D_c + D_c+1); W_c = 3 D_0, b3 T_2, b3 D_2
    tc = each(w_fsub, shfl(x, [c + 3 for c in cs]), each(w_fadd, shfl(x, cs), shfl(x, nxt)))
    w = sel([c == 1 for c in cs], shfl(tc, [2] * LANES), shfl(x, cs))
    w = [w_fmul_small(3 if c == 0 else B3, w[g]) for g, c in enumerate(cs)]
    # z3 = D_1 + W_2, t1 = D_1 - W_2
    d1, w2 = shfl(x, [1] * LANES), shfl(w, [2] * LANES)
    z3, t1 = each(w_fadd, d1, w2), each(w_fsub, d1, w2)
    # round 3, lane j: A of t3, t4, y3, t1, z3, x3 (T_0, T_1, W_1, t1, z3,
    # W_0), B of t1, y3, x3, z3, t4, t3 (t1, W_1, W_0, z3, T_1, T_0)
    a_t = shfl(tc, [1 if j == 1 else 0 for j in js])
    a_w = shfl(w, [1 if j == 2 else 0 for j in js])
    a = [a_t[g] if j < 2 else a_w[g] if j in (2, 5) else t1[g] if j == 3 else z3[g]
         for g, j in enumerate(js)]
    b_t = shfl(tc, [1 if j == 4 else 0 for j in js])
    b_w = shfl(w, [1 if j == 1 else 0 for j in js])
    b = [b_t[g] if j >= 4 else b_w[g] if j in (1, 2) else t1[g] if j == 0 else z3[g]
         for g, j in enumerate(js)]
    prod = each(w_fmul, a, b)
    u, v = shfl(prod, [2 * c for c in cs]), shfl(prod, [2 * c + 1 for c in cs])
    out = [w_fsub(u[g], v[g]) if c == 0 else w_fadd(u[g], v[g]) for g, c in enumerate(cs)]
    if trace is not None:
        trace.update(round1=x, t=tc, w=w, round3=prod)
    return out


def w_padd_rows(p, q, same=False):
    """P + Q as the row's lanes leave it: lanes 0-2 hold X, Y, Z, and every
    other lane the same coordinate as the lane it repeats."""
    out = w_padd_lanes(p, q, same)
    assert all(out[g] == out[g % 3] for g in range(LANES))
    return tuple(out[:3])


def words_of(row16):
    """16 limbs -> 8 words, as the kernel's load (limb 2k | limb 2k+1 << 16)."""
    return [int(row16[2 * k]) | (int(row16[2 * k + 1]) << 16) for k in range(8)]


def point_words(t):
    return tuple(words_of(t[c]) for c in range(3))


def limbs_of_point(pw):
    return [[(w >> s) & 0xFFFF for w in coord for s in (0, 16)] for coord in pw]


def test_kernel_constants_are_the_fields():
    assert P_INV32 * P % (1 << 32) == 1
    assert P == R - (1 << 32) - C0 and C0 < 1 << 10
    assert B3 == 21  # 3b, b = 7: the product by b3 R mod p is the product by 21
    for words, value in ((P_WORDS, P), (ONE_WORDS, R % P)):
        assert w_value(words) == value
    assert ec_batch._N_PRIME == -P_INV32 & 0xFFFF  # the JAX digit's n'


@pytest.mark.parametrize("op", ["fmul", "fadd", "fsub"])
def test_word_model_field_ops_match_plain(op):
    xs, ys = _field_rows()
    plain = getattr(ec_batch, "_" + op)(limbs(xs), limbs(ys)).numpy()
    model = {"fmul": w_fmul, "fadd": w_fadd, "fsub": w_fsub}[op]
    x16, y16 = limbs(xs).numpy(), limbs(ys).numpy()
    for i in range(len(xs)):
        assert model(words_of(x16[i]), words_of(y16[i])) == words_of(plain[i])


@pytest.mark.parametrize("op", ["fsqr", "times3", "times_b3"])
def test_word_model_squaring_and_small_products_match_plain(op):
    """The squaring against the plain x * x, the product by 3 against t0 +
    t0 + t0, the product by b3 = 21 against the plain product by b3 R mod
    p: the same canonical words."""
    xs, _ = _field_rows()
    xs = sorted(set(xs))
    x = limbs(xs)
    if op == "fsqr":
        plain, model = ec_batch._fmul(x, x), w_fsqr
    elif op == "times3":
        plain = ec_batch._fadd(ec_batch._fadd(x, x), x)
        model = lambda w: w_fmul_small(3, w)  # noqa: E731
    else:
        plain = ec_batch._fmul(limbs([21 * R % P] * len(xs)), x)
        model = lambda w: w_fmul_small(B3, w)  # noqa: E731
    x16 = x.numpy()
    for i in range(len(xs)):
        assert model(words_of(x16[i])) == words_of(plain.numpy()[i])


def _words(v, n):
    return [(v >> (32 * j)) & M32 for j in range(n)]


def test_word_model_reduction_on_the_special_form_at_edges():
    """The special-form reduction at the edge operands (0, 1, p - 1, (p -
    1)^2, the largest input below p^2, and others) and on inputs where the
    subtraction of M borrows through every word (T_hi + c - M < 0, the
    branch that adds p back) or through none: the canonical T R^{-1} mod
    p, the value of the generic CIOS reduction."""
    r_inv = pow(R, -1, P)
    edges = [0, 1, 3, P - 1, P, (P - 1) ** 2, P * P - 1, (1 << 256) - 1, R % P * (P - 1),
             (1 << 32) + C0]
    rng = np.random.default_rng(23)
    edges += [rand_below(rng, P * P) for _ in range(6)]
    through_all = through_none = 0
    for t in edges:
        borrows = []
        got = w_mont_reduce(_words(t, 16), borrows)
        assert w_value(got) == t * r_inv % P
        through_all += not any(borrows)
        through_none += all(borrows)
    # 1 and 3 (M near 2^256, T_hi 0) borrow through all eight words; 0 none
    assert through_all >= 2 and through_none >= 1
    # and through the products: x * y with x or y at 0, 1 and p - 1
    for x, y in [(0, P - 1), (1, 1), (1, P - 1), (P - 1, P - 1), (R % P, P - 1)]:
        assert w_value(w_fmul(_words(x, 8), _words(y, 8))) == x * y * r_inv % P
        assert w_value(w_fsqr(_words(x, 8))) == x * x * r_inv % P
        assert w_value(w_fmul_small(B3, _words(x, 8))) == 21 * x % P


def test_word_model_padd_matches_plain():
    p1, p2, _, _ = _padd_rows()
    plain = ec_batch._padd(p1, p2).numpy()
    for i in range(p1.shape[0]):
        got = w_padd(point_words(p1[i].numpy()), point_words(p2[i].numpy()))
        assert limbs_of_point(got) == plain[i].tolist()


def test_word_model_doubling_instance_matches_plain():
    """padd_lanes<true> (the round-1 products as squarings) on P + P
    against the plain complete addition of a row with itself."""
    p1, _, _, _ = _padd_rows()
    plain = ec_batch._padd(p1, p1).numpy()
    for i in range(p1.shape[0]):
        pw = point_words(p1[i].numpy())
        assert limbs_of_point(w_padd_rows(pw, pw, same=True)) == plain[i].tolist()


@pytest.mark.parametrize("same", [False, True], ids=["add", "double"])
def test_word_model_lane_schedule_matches_padd(same):
    """The scalar mul's addition on a row's 8 lanes: which lane computes
    which product in which round and what it exchanges, on distinct points,
    a doubling, the identity on either side and P + (-P) (`_padd_rows`),
    against `_padd`'s statement values and the plain addition, bit for
    bit. Round 1: lane g < 3 D_g (t0, t1, t2), lanes 3-5 S_g-3 ((X+Y)(X'+Y'),
    (Y+Z)(Y'+Z'), (X+Z)(X'+Z')), lanes 6, 7 repeat 0, 1; every lane's T_c
    is t3, t4 or y3 and W_c 3 t0, b3 y3 or b3 t2; round 3 lane j the j-th
    of t3 t1, t4 y3, y3 x3, t1 z3, z3 t4, x3 t3."""
    p1, p2, _, _ = _padd_rows()
    if same:
        p2 = p1
    plain = ec_batch._padd(p1, p2).numpy()
    for i in range(p1.shape[0]):
        pw, qw = point_words(p1[i].numpy()), point_words(p2[i].numpy())
        v = w_padd_values(pw, qw, same)
        trace = {}
        out = w_padd_lanes(pw, qw, same, trace)
        names = ["t0", "t1", "t2", "s0", "s1", "s2", "t0", "t1"]
        assert trace["round1"] == [v[n] for n in names]
        assert trace["t"] == [v[("t3", "t4", "y3")[g % 3]] for g in range(LANES)]
        assert trace["w"] == [v[("x3", "b3y3", "b3t2")[g % 3]] for g in range(LANES)]
        assert trace["round3"] == [v["round3"][g if g < 6 else g - 6] for g in range(LANES)]
        assert out == [v["out"][g % 3] for g in range(LANES)]
        assert limbs_of_point(tuple(out[:3])) == plain[i].tolist()


def w_scalar_mul(base, digit_of, windows):
    """The kernel's row on its lanes: the table (entry 0 the identity,
    entry e = entry e-1 + P), then per window 4 doublings and the masked OR
    over all 16 entries."""
    ident = ([0] * 8, ONE_WORDS, [0] * 8)
    table = [ident, base]
    for _ in range(2, 16):
        table.append(w_padd_rows(table[-1], base))
    acc = ident
    for wi in range(windows):
        d = digit_of(wi)
        for _ in range(4):
            acc = w_padd_rows(acc, acc, same=True)
        sel = [[0] * 8 for _ in range(3)]
        for e in range(16):
            mask = (-(d == e)) & M32
            for c in range(3):
                for k in range(8):
                    sel[c][k] |= table[e][c][k] & mask
        acc = w_padd_rows(acc, tuple(sel))
    return acc


def test_word_model_scalar_mul_and_tree_match_plain():
    """Two 128-bit rows of the kernel's lane model against the plain scalar
    mul, and the tree's in-place levels (one thread a pair, row i += row
    i + h, the buffer word-major) against the plain tree sum."""
    rng = np.random.default_rng(19)
    pts = [rand_point(rng), Point.identity()]
    scs = [rand_below(rng, 1 << 128), (1 << 128) - 1]
    points = ec_batch.points_to_device(pts, "cpu")
    scalars = ec_batch._scalars_to_limbs(scs, 128)
    plain = ec_batch._scalar_mul_kernel(points, torch.as_tensor(scalars.astype(np.int32)),
                                        scalar_bits=128).numpy()
    for r in range(2):
        def digit_of(wi, r=r):
            shift = 128 - 4 * (wi + 1)
            return (int(scalars[r, shift >> 4]) >> (shift & 15)) & 15

        got = w_scalar_mul(point_words(points[r].numpy()), digit_of, 32)
        assert limbs_of_point(got) == plain[r].tolist()

    group = [rand_point(rng), GENERATOR, Point.identity(), GENERATOR]
    t = ec_batch.points_to_device(group * 2, "cpu").view(2, 4, 3, 16)
    plain = ec_batch._tree_sum_kernel(t).numpy()
    for g in range(2):
        m = 4
        half = m // 2
        buf = [w_padd(point_words(t[g, i].numpy()), point_words(t[g, i + half].numpy()))
               for i in range(half)]
        h = half // 2
        while h >= 1:
            for i in range(h):
                buf[i] = w_padd(buf[i], buf[i + h])
            h //= 2
        assert limbs_of_point(buf[0]) == plain[g].tolist()
