"""The JAX package's tamper matrix (tests/test_tamper.py::CASES) against
the port's collect: every broadcast field of a RefreshMessage perturbed
after distribute, and the port must reject with the error class the JAX
collect raises, blaming the same party.

One honest round (t=1, n=3, TEST_CONFIG widths) is made once by the JAX
package for this module; each case deep-copies its messages, mutates
them with the case's own mutation, collects them in the JAX package
(host backend) and carries them to the port (fsdkr_tpu_torch.carry),
where the host backend collects them in every case, and the cuda backend
on the CPU (device="cpu": the kernels' plain versions, the default knobs:
RLC, MULTIEXP and RANGEOPT on; 12-18 s a collect) in the cases that end
before the pair verification and in those no other port test covers
(`CUDA_CASES`). The port's errors may name a party where the JAX
package's name none (its PDL error), never another one.
"""

import copy
import dataclasses

import pytest
import torch

from fsdkr_tpu.config import TEST_CONFIG as JAX_CONFIG
from fsdkr_tpu.protocol import RefreshMessage as JaxRefresh
from fsdkr_tpu.protocol import simulate_keygen as jax_keygen
from fsdkr_tpu_torch import TEST_CONFIG
from fsdkr_tpu_torch.carry import from_reference
from fsdkr_tpu_torch.protocol import RefreshMessage
from test_tamper import CASES

HOST = dataclasses.replace(TEST_CONFIG, backend="host")
# the cuda-backend cases: tests/test_torch_refresh.py covers the PDL,
# range, ring-Pedersen, correct-key and ciphertext tampers there
CUDA_CASES = ("public_key", "committed_point", "short_vector", "new_ek_too_small",
              "lagrange_index", "huge_range_s1_dos", "negative_range_s1",
              "negative_pdl_z", "negative_ringped_Z")
MATRIX = [
    pytest.param(name, err, mutate, backend, id=f"{name}-{backend}")
    for name, err, mutate in CASES
    for backend in ("host", "cuda")
    if backend == "host" or name in CUDA_CASES
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: torch's intra-op pool
    only spins there, and under pytest-xdist it takes other workers'
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def honest_round():
    keys = jax_keygen(1, 3, JAX_CONFIG)
    out = JaxRefresh.distribute_batch([(k.i, k) for k in keys], 3, JAX_CONFIG)
    return keys, [m for m, _ in out], [dk for _, dk in out]


def _verdict(err):
    return type(err).__name__, getattr(err, "party_index", None)


def _jax_verdict(honest_round, mutate):
    keys, msgs, dks = honest_round
    msgs = copy.deepcopy(msgs)
    mutate(msgs)
    with pytest.raises(Exception) as ei:
        JaxRefresh.collect(msgs, copy.deepcopy(keys[0]), copy.deepcopy(dks[0]), (), JAX_CONFIG)
    return msgs, _verdict(ei.value)


def _port_verdict(msgs, honest_round, config):
    keys, _, dks = honest_round
    with pytest.raises(Exception) as ei:
        RefreshMessage.collect(
            from_reference(msgs), from_reference(keys[0]), from_reference(dks[0]),
            (), config,
        )
    return _verdict(ei.value)


def _same_blame(port, jax):
    """The same class; the same party where the JAX package names one."""
    return port[0] == jax[0] and (jax[1] is None or port[1] == jax[1])


def test_matrix_covers_every_case():
    assert {c[0] for c in CASES} >= set(CUDA_CASES) and len(CASES) == 15


@pytest.mark.parametrize("name,err,mutate,backend", MATRIX)
def test_port_collect_blames_like_jax(honest_round, name, err, mutate, backend):
    msgs, want = _jax_verdict(honest_round, mutate)
    assert want[0] in {e.__name__ for e in (err if isinstance(err, tuple) else (err,))}
    got = _port_verdict(msgs, honest_round, HOST if backend == "host" else TEST_CONFIG)
    assert _same_blame(got, want), (got, want)
    if want[1] is None and got[1] is not None:
        # the port names the tampered sender
        assert got[1] == msgs[1].party_index


def test_honest_round_adopts_in_both(honest_round):
    keys, msgs, dks = honest_round
    jkey = copy.deepcopy(keys[0])
    JaxRefresh.collect(copy.deepcopy(msgs), jkey, copy.deepcopy(dks[0]), (), JAX_CONFIG)
    pkey = from_reference(keys[0])
    RefreshMessage.collect(from_reference(msgs), pkey, from_reference(dks[0]), (), HOST)
    assert pkey.keys_linear.x_i.v == jkey.keys_linear.x_i.v
