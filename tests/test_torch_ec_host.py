"""The device EC kernels' CUDA source (fsdkr_tpu_torch/csrc/ec_kernels.cu),
compiled for the CPU and run against the plain versions, bit for bit.

`tests/host_cuda/cuda_host.h` stands in for the CUDA runtime: a block's
threads are fibers on one host thread, run in turns from one
`__syncthreads` or warp shuffle to the next, `__shared__` arrays are
shared by the block's threads, and a launch runs its blocks one after
another. The source is compiled as it is, apart from the include and the
launch syntax, with the host's C++ compiler, and the C entry points are
called on host tensors. So the kernels' own code runs here: the lane
schedule of the scalar multiplication, the shuffles within a row's
group, the masked table select, a partly filled last block and the
tree's levels. What it cannot show is what only the card shows (the
compiler's code, timing, memory ordering between warps); `chip_smoke.py`
checks the kernels there.

Skipped where the host has no C++ compiler.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fsdkr_tpu_torch.core.secp256k1 import GENERATOR, N, P, Point, Scalar
from fsdkr_tpu_torch.ops import ec_batch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "fsdkr_tpu_torch" / "csrc" / "ec_kernels.cu"
SHIM = Path(__file__).resolve().parent / "host_cuda" / "cuda_host.h"
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,>]+)(?:,[^>]*)?>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = SRC.read_text().replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')
    text, launches = _LAUNCH.subn(
        lambda m: f"emu_launch({m[2]}, {m[3]}, [&] {{ {m[1]}({m[4]}); }});", text)
    assert launches == 2  # the scalar mul's and the tree's
    out = tmp_path_factory.mktemp("ec_host")
    cpp, so = out / "ec_kernels_host.cpp", out / "libec_kernels_host.so"
    cpp.write_text(text)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fsdkr_ec_scalar_mul.argtypes = [p, p, i, i, i, p, p]
    lib.fsdkr_ec_scalar_mul.restype = i
    lib.fsdkr_ec_tree_sum.argtypes = [p, i, i, p, p, p]
    lib.fsdkr_ec_tree_sum.restype = i
    return lib


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand_point(rng):
    return GENERATOR * Scalar(1 + int.from_bytes(rng.bytes(40), "little") % (N - 1))


@pytest.mark.parametrize("rows,bits", [(13, 128), (6, 256)])
def test_host_scalar_mul_matches_plain(host_lib, rows, bits):
    """13 rows: three full blocks of 4 rows and one row in a block of 4;
    G, the identity and the edge scalars 0, 1, 7, the largest and 2^128 - 1
    among the rows."""
    rng = np.random.default_rng(rows * 1000 + bits)
    top = N if bits == 256 else 1 << 128
    pts = [_rand_point(rng) for _ in range(rows)]
    pts[1:3] = [GENERATOR, Point.identity()]
    scs = [int.from_bytes(rng.bytes(40), "little") % top for _ in range(rows)]
    scs[:5] = [0, 1, 7, top - 1, (1 << 128) - 1]
    points = ec_batch.points_to_device(pts, "cpu").contiguous()
    scalars = torch.as_tensor(ec_batch._scalars_to_limbs(scs, bits).astype(np.int32))
    out = torch.empty_like(points)
    err = host_lib.fsdkr_ec_scalar_mul(points.data_ptr(), scalars.data_ptr(), rows,
                                       scalars.shape[1], bits, out.data_ptr(), None)
    assert err == 0
    want = ec_batch._scalar_mul_kernel(points, scalars, scalar_bits=bits).to(torch.int32)
    assert torch.equal(out, want)


@pytest.mark.parametrize("groups,m", [(1, 1), (1, 2), (3, 8), (2, 128)])
def test_host_tree_sum_matches_plain(host_lib, groups, m):
    """Random Z, a cancelling pair, a doubling and identity pads a group;
    128 rows give the first level two warps of pairs, met by the barrier
    between levels."""
    rng = np.random.default_rng(groups * 100 + m)
    pts = []
    for _ in range(groups):
        grp = [_rand_point(rng) for _ in range(m)]
        h = m // 2
        if m >= 2:
            grp[h] = -grp[0]
        if m >= 4:
            grp[1 + h] = grp[1]
        if m >= 8:
            grp[m - m // 8:] = [Point.identity()] * (m // 8)
        pts += grp
    proj = ec_batch.points_to_device(pts, "cpu").to(torch.int64)
    lam = torch.as_tensor(ec_batch.ints_to_limbs(
        [1 + int.from_bytes(rng.bytes(40), "little") % (P - 1) for _ in pts], 16)
        .astype(np.int64))
    scaled = torch.stack([ec_batch._fmul(proj[:, c], lam) for c in range(3)], dim=1)
    points = scaled.to(torch.int32).view(groups, m, 3, 16).contiguous()
    out = torch.empty((groups, 3, 16), dtype=torch.int32)
    scratch = torch.empty((groups, max(m // 2, 1), 24), dtype=torch.int32)
    err = host_lib.fsdkr_ec_tree_sum(points.data_ptr(), groups, m, scratch.data_ptr(),
                                     out.data_ptr(), None)
    assert err == 0
    assert torch.equal(out, ec_batch._tree_sum_kernel(points).to(torch.int32))
