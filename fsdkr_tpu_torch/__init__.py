"""fsdkr_tpu_torch — the PyTorch/CUDA port of the fs-dkr refresh framework.

One-round Fouque-Stern Distributed Key Refresh for GG20 threshold-ECDSA
keys, with the same protocol surface as the JAX package beside it
(`RefreshMessage.distribute_batch` / `collect`, keygen, the proof
systems), ported slice by slice to one NVIDIA H100.

Every batched modexp and modmul column runs through two hand-written
Hopper kernels (`csrc/rns_kernels.cu`, bound in `ops.rns_kernels`): an
RNS Montgomery product and a fused fixed-window RNS modexp. Tensors live
on `ProtocolConfig.device` ("cuda" by default); there is no fallback to
the host when the card is missing — `device="cpu"` must be asked for,
and then the kernels' plain PyTorch versions run instead.

The package imports torch and numpy, never jax, and nothing of the JAX
package: what it needs of the JAX-free layers it keeps as its own copy.
`carry.from_reference` converts the JAX package's objects into this
package's by class and attribute name.
"""

from .config import ProtocolConfig, DEFAULT_CONFIG, TEST_CONFIG
from . import errors
from .errors import FsDkrError

__version__ = "0.1.0"

__all__ = [
    "ProtocolConfig",
    "DEFAULT_CONFIG",
    "TEST_CONFIG",
    "errors",
    "FsDkrError",
    "__version__",
]
