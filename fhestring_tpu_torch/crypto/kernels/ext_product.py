"""One step's 64-bit external product by negacyclic convolution: the
hand-written CUDA kernel and its plain PyTorch version.

Replaces ``fhestring_tpu/crypto/kernels/ext_product.py: ext_product_u64``
(a Pallas TPU kernel: Hankel-band int8 matmuls on the MXU).  What it
computes, for each batch item b and output row col:

    ext[b, col] = sum_r d[b, r] (x) K[r, col]   (negacyclic in
                                                 Z_{2^64}[X]/(X^N + 1))

d[b, r] = sum_la 256^la * dl[la, b, r]: the 23-bit digits, given as their
3 balanced int8 limbs (``rotate_decompose``'s output, natural coefficient
order).  K[r, col] = sum_lb 256^lb * key[r, col, lb] (mod 2^64): the step's
bootstrap-key polys, given as the 8 balanced byte limbs of each u64 value
(``DeviceServerKeys.bsk_limbs[j]``).  The JAX kernel evaluates
sum_{la + lb < 8} 256^(la + lb) * (dl_la (x) key_lb) on int32 planes; the
terms with la + lb >= 8 are multiples of 2^64, so both give the same bits.
Its inputs were the c-reversed digits and the key limbs doubled to 2N and
then 4N; those are layouts for the TPU's lanes and are not used here.

The kernel (``csrc/ext_product.cu``) rebuilds each digit and each u64 key
value in registers and multiply-adds in 64-bit integers; its source says how
it is tiled.  What bounds it on an H100: the integer multiply-adds on the
CUDA cores, 2 * N * (k+1) * N = 1.7e7 u64 products per item and step at
N = 2048.

The plain version builds, per (r, col), the negacyclic matrices of the 8
byte limbs of the doubled key poly (as the JAX kernel's Hankel bands) and
multiplies them with the digit limbs by ``torch._int_mm`` (int8 x int8 ->
int32, exact: |sum| <= N * 128 * 128), then recombines the shift planes in
int64.  Memory per (r, col): 8 int8 [N, N] matrices, 32 MB at N = 2048.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import keys
from . import blind_rotate64 as br64
from . import cuda_build

TILE = 128  # coefficients per block, the kernel's kTile
ITEMS = (1, 4)  # batch items per block: the kernel's kItems bodies
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FUNCTIONS = {"fhe_ext_product": ([_VP, _VP, _VP, _INT, _INT, _INT, _VP],
                                  _INT)}


def build() -> str:
    """Compile the kernel (``cuda_build``) and load it, once per process.
    Returns the path of the shared library."""
    cuda_build.load("ext_product", _FUNCTIONS)
    return cuda_build.library_path("ext_product")


def items_per_block(batch: int, n: int, sms: int) -> int:
    """Batch items per block: 4 once that still gives the card two blocks
    per SM (grid N/128 x (k+1) x ceil(B/4)), else 1, so a batch of a few
    items still spreads over the SMs.  Measured on an H100 at N = 2048
    (PERF.md): 1 item is faster up to B = 33, 4 from B = 43; a body of 8
    items was never the fastest, one of 2 beat this choice by at most
    16%."""
    blocks = (n // TILE) * br64.GLWE_ROWS * -(-batch // ITEMS[-1])
    return ITEMS[-1] if blocks >= 2 * sms else 1


def _check(dl: torch.Tensor, key: torch.Tensor) -> None:
    if dl.dtype != torch.int8 or key.dtype != torch.int8:
        raise TypeError("dl and key must be int8")
    if dl.dim() != 3 or key.dim() != 4:
        raise ValueError("expected dl [3, B, (k+1)*N] and key "
                         "[k+1, k+1, 8, N]")
    kp1, N = br64.GLWE_ROWS, key.shape[-1]
    if tuple(key.shape) != (kp1, kp1, keys.KEY_PLANES64, N):
        raise ValueError(f"unsupported key shape {tuple(key.shape)}")
    if N & (N - 1) or not TILE <= N <= 2048:
        raise ValueError(f"unsupported polynomial size {N}")
    if dl.shape[0] != br64.DIGIT_LIMBS or dl.shape[2] != kp1 * N:
        raise ValueError(f"dl shape {tuple(dl.shape)} does not match the key")
    if dl.device != key.device:
        raise ValueError("dl and key on different devices")
    if not (dl.is_contiguous() and key.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def _limb_matrices(key_poly: torch.Tensor) -> torch.Tensor:
    """Byte limbs of one u64 key poly int8 [8, N] -> int8 [N(c), 8 * N(t)]:
    M[c, lb * N + t] = limb lb of the doubled poly (K, -K) at (t - c) mod
    2N, the negacyclic matrix of each limb plane."""
    planes, N = key_poly.shape
    value = torch.zeros(N, dtype=torch.int64, device=key_poly.device)
    for lb in range(planes):
        value = value + (key_poly[lb].to(torch.int64) << (8 * lb))
    doubled = keys.balanced_limbs(torch.cat([value, -value]), planes)
    ar = torch.arange(N, device=key_poly.device)
    idx = (ar[None, :] - ar[:, None]) & (2 * N - 1)       # [c, t]
    mats = doubled.to(torch.int8).t()[:, idx]             # [lb, c, t]
    return mats.permute(1, 0, 2).reshape(N, planes * N)


def ext_product_plain(dl: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: int8 negacyclic limb matmuls (exact int32
    planes), recombined mod 2^64 in int64.  Same arguments and result as
    ``ext_product``."""
    from ..pbs import _int8_matmul  # pbs imports this module

    _check(dl, key)
    L, B, _ = dl.shape
    kp1, _, planes, N = key.shape
    d = dl.view(L, B, kp1, N)
    out = torch.zeros((B, kp1, N), dtype=torch.int64, device=dl.device)
    for r in range(kp1):
        lhs = d[:, :, r].reshape(L * B, N)
        for col in range(kp1):
            w = _int8_matmul(lhs, _limb_matrices(key[r, col]))
            w = w.view(L, B, planes, N).to(torch.int64)
            for la in range(L):
                for lb in range(planes - la):              # la + lb < 8
                    out[:, col] += w[la, :, lb] << (8 * (la + lb))
    return out


def ext_product(dl: torch.Tensor, key: torch.Tensor,
                items: int | None = None) -> torch.Tensor:
    """One step's external product.

    dl: int8 [3, B, (k+1)*N] digit limbs (``rotate_diff_decompose``);
    key: int8 [k+1, k+1, 8, N] byte limbs of the step's key polys
    (``DeviceServerKeys.bsk_limbs[j]``).  Returns int64 [B, k+1, N]: the
    external product mod 2^64 (u64 bits).  items: the kernel body, batch
    items per block, one of ITEMS (default: ``items_per_block``); the
    result does not depend on it.

    CPU tensors run ``ext_product_plain``; CUDA tensors launch the kernel
    (built at first use) and count the launch in ``ext_product.launches``.
    """
    _check(dl, key)
    if items is not None and items not in ITEMS:
        raise ValueError(f"items must be one of {ITEMS}, not {items}")
    if dl.device.type == "cpu":
        return ext_product_plain(dl, key)
    if dl.device.type != "cuda":
        raise ValueError(f"no external-product kernel for {dl.device}")
    lib = cuda_build.load("ext_product", _FUNCTIONS)
    _, B, _ = dl.shape
    kp1, N = key.shape[1], key.shape[-1]
    if items is None:
        items = items_per_block(B, N, cuda_build.sm_count(dl.device.index))
    out = torch.empty((B, kp1, N), dtype=torch.int64, device=dl.device)
    with torch.cuda.device(dl.device):
        err = lib.fhe_ext_product(
            dl.data_ptr(), key.data_ptr(), out.data_ptr(), B, N, items,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "ext_product")
    ext_product.launches += 1
    return out


ext_product.launches = 0
