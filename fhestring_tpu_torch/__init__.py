"""fhestring_tpu_torch: the TFHE encrypted-string framework on PyTorch and CUDA.

The port of ``fhestring_tpu`` (JAX and Pallas) to PyTorch, with the blind
rotation as a hand-written CUDA kernel for NVIDIA Hopper.  Characters are
encrypted as 4 x 2-bit shortint radix blocks; every string method lowers to
batched programmable bootstraps.  The module layout mirrors the JAX
package's.  This package imports torch and numpy, never jax.

Ported so far: the 64-bit parameter family (``PARAM_PROD``, the default)
and the 32-bit-torus (turbo) family end to end, the CLI, key and
ciphertext checkpoints (``serialize``), the TCP service (``service``) and
sharding over ``torch.distributed`` ranks (``parallel``, ``dryrun``); see
ROADMAP.md for what remains.  The device defaults to the card
(``client.ClientKey(device=None)``).
"""

from .params import (  # noqa: F401
    PARAM_MESSAGE_2_CARRY_2_KS_PBS_32,
    PARAM_MESSAGE_2_CARRY_2_KS_PBS_64,
    PARAM_PROD,
    PARAM_TEST32_STAT,
    PARAM_TEST32_ZERO_NOISE,
    PARAM_TEST_NOISY,
    PARAM_TEST_ZERO_NOISE,
    PARAM_TURBO,
    CryptoParams,
)
from .ciphertext import (  # noqa: F401
    Comparison,
    FheChar,
    FheSplit,
    FheString,
    FheStrip,
    PublicParameters,
)

__version__ = "0.1.0"
