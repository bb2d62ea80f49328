"""One step's 64-bit external product by negacyclic convolution: the
hand-written CUDA kernel and its plain PyTorch version.

Replaces ``fhestring_tpu/crypto/kernels/ext_product.py: ext_product_u64``
(a Pallas TPU kernel: Hankel-band int8 matmuls on the MXU).  What it
computes, for each batch item b and output row col of the key it is given
(all k+1, or a shard of consecutive columns: the key-sharded blind rotation
of ``parallel.py``, which holds ``bsk_limbs[:, :, cols]``):

    ext[b, col] = sum_r d[b, r] (x) K[r, col]   (negacyclic in
                                                 Z_{2^64}[X]/(X^N + 1))

d[b, r] = sum_la 256^la * dl[la, b, r]: the 23-bit digits, given as their
3 balanced int8 limbs (``rotate_decompose``'s output, natural coefficient
order).  K[r, col] (mod 2^64): the step's bootstrap-key polys, given as the
reversed byte-limb planes of each poly doubled with its negation
(``DeviceServerKeys.bsk_limbs[j]``, ``keys.pack_bsk_limbs``).  The JAX kernel evaluates
sum_{la + lb < 8} 256^(la + lb) * (dl_la (x) key_lb) on int32 planes; the
terms with la + lb >= 8 are multiples of 2^64, so both give the same bits.
Its inputs were the c-reversed digits and the key limbs doubled to 2N and
then 4N; those are layouts for the TPU's lanes and are not used here.

The kernel (``csrc/ext_product.cu``) runs those limb products on the
tensor cores (``mma.sync`` int8 x int8 -> int32), one int32 fragment per
shift s = la + lb, and recombines them to u64 itself; the negacyclic
(Toeplitz) operand is read from a staged window of the key's limb planes
and never built.  Blocks that split the sum over c add their u64 partial
sums with atomics, so the kernel adds into its output: the accumulator
itself (``accumulate=True``: acc += ext in the same launch) or a zeroed
buffer.  Its source says how it is tiled.  What bounds it on an H100: 3.5e8
int8 multiply-adds per item and step at N = 2048, and at small batches the
shared-memory loads of the operand fragments.

The plain version takes the limbs of K itself out of the key's planes,
builds, per (r, col), the negacyclic matrices of the 8 byte limbs of the
doubled key poly (as the JAX kernel's Hankel bands) and
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

MIN_N = 128  # smallest polynomial size the kernel takes
GROUPS = (1, 2)  # 8-item groups per block: the kernel's kGroups bodies
ITEMS = 8  # batch items of one group (an n8 tile of the mma)
M_TILE = 128  # output coefficients per block, the kernel's kMt
CHUNK_STEP = 128  # a chunk of digit indices is a multiple of this
SHARED_MEMORY = 232448  # bytes a block may use on an H100
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FUNCTIONS = {
    "fhe_ext_product": ([_VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT,
                         _VP], _INT),
    "fhe_ext_product_init": ([], _INT),
}


def build() -> str:
    """Compile the kernel (``cuda_build``) and load it, once per process.
    Returns the path of the shared library."""
    cuda_build.load("ext_product", _FUNCTIONS)
    return cuda_build.library_path("ext_product")


def _library(device_index: int) -> ctypes.CDLL:
    return cuda_build.ready("ext_product", _FUNCTIONS, "fhe_ext_product_init",
                            device_index)


def prepare(device: torch.device) -> None:
    """Everything a launch on that CUDA device needs that a stream capture
    could not do: builds and loads the kernel."""
    _library(device.index)


def pick_body(batch: int, n: int, sms: int,
              cols: int = br64.GLWE_ROWS) -> tuple[int, int, int]:
    """(groups, chunk, split) of the launch, from a sweep on an H100 at
    N = 2048 (``tools/stepwise_sweep``).  groups: 8-item groups per block,
    2 where that pads the batch no further than 1 does, or at large
    batches.  chunk: digit indices staged at once, 1024, or 512 where the
    blocks are so few that only the finer split gives the card 2 a SM.
    split: blocks that share the 2N / chunk chunks of one output tile and
    add their partial sums, doubled until the grid (N/128 x cols ceil(B / 8
    groups) x split) has 8 blocks a SM; cols: the key's output rows.  The
    result does not depend on the body."""
    pair = 2 * ITEMS
    groups = 2 if batch >= 128 or -(-batch // pair) * 2 == -(-batch // ITEMS) \
        else 1
    blocks = (n // M_TILE) * cols * -(-batch // (ITEMS * groups))
    chunk = min(n, 1024)
    if chunk > 512 and blocks * (2 * n // chunk) < 2 * sms:
        chunk = 512
    chunks = 2 * n // chunk
    split = 1
    while split < chunks and blocks * split < 8 * sms:
        split *= 2
    return groups, chunk, split


def shared_memory(groups: int, chunk: int) -> int:
    """Bytes of shared memory of one block (the kernel's smem_bytes): 8 limb
    planes x 4 shifted copies of the key window, 3 limbs x 8 groups rows of
    digits, with the strides padded against bank conflicts."""
    return 4 * (8 * 4 * (chunk // 4 + 40)
                + br64.DIGIT_LIMBS * ITEMS * groups * (chunk // 4 + 4))


def _check_body(body, n: int) -> None:
    groups, chunk, split = body
    if (groups not in GROUPS or chunk % CHUNK_STEP
            or not CHUNK_STEP <= chunk <= n or split < 1
            or (2 * n // chunk) % split
            or shared_memory(groups, chunk) > SHARED_MEMORY):
        raise ValueError(f"unsupported body (groups, chunk, split) = {body} "
                         f"at N = {n}")


def _check(dl: torch.Tensor, key: torch.Tensor) -> None:
    if dl.dtype != torch.int8 or key.dtype != torch.int8:
        raise TypeError("dl and key must be int8")
    if dl.dim() != 3 or key.dim() != 4:
        raise ValueError("expected dl [3, B, (k+1)*N] and key "
                         "[k+1, cols, 8, 2N]")
    kp1, N = br64.GLWE_ROWS, key.shape[-1] // 2
    if (key.shape[0] != kp1 or not 1 <= key.shape[1] <= kp1
            or tuple(key.shape[2:]) != (keys.KEY_PLANES64, 2 * N)):
        raise ValueError(f"unsupported key shape {tuple(key.shape)}")
    if N & (N - 1) or not MIN_N <= N <= 2048:
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
    key = keys.doubled_limbs(key)[..., :key.shape[-1] // 2]  # limbs of K
    L, B, _ = dl.shape
    kp1, cols, planes, N = key.shape
    d = dl.view(L, B, kp1, N)
    out = torch.zeros((B, cols, N), dtype=torch.int64, device=dl.device)
    for r in range(kp1):
        lhs = d[:, :, r].reshape(L * B, N)
        for col in range(cols):
            w = _int8_matmul(lhs, _limb_matrices(key[r, col]))
            w = w.view(L, B, planes, N).to(torch.int64)
            for la in range(L):
                for lb in range(planes - la):              # la + lb < 8
                    out[:, col] += w[la, :, lb] << (8 * (la + lb))
    return out


def ext_product(dl: torch.Tensor, key: torch.Tensor,
                out: torch.Tensor | None = None, accumulate: bool = False,
                body: tuple[int, int, int] | None = None) -> torch.Tensor:
    """One step's external product.

    dl: int8 [3, B, (k+1)*N] digit limbs (``rotate_diff_decompose``);
    key: int8 [k+1, cols, 8, 2N] reversed limb planes of the step's doubled
    key polys (``DeviceServerKeys.bsk_limbs[j]``, cols = k+1, or a column
    shard of it).  Returns int64 [B, cols, N]: the external product's output
    rows of that key mod 2^64 (u64 bits).  out: where to put it (no
    allocation then); with accumulate=True the product is added to out (mod
    2^64) instead, the step ``acc += ext`` in one launch.  body: the
    kernel's (groups, chunk, split), default ``pick_body``; the result does
    not depend on it.

    CPU tensors run ``ext_product_plain``; CUDA tensors launch the kernel
    (built at first use) and count the launch in ``ext_product.launches``.
    """
    _check(dl, key)
    _, B, _ = dl.shape
    cols, N = key.shape[1], key.shape[-1] // 2
    if out is not None:
        cuda_build.check_out(out, (B, cols, N), torch.int64, dl.device)
    elif accumulate:
        raise ValueError("accumulate=True needs out")
    if body is not None:
        _check_body(body, N)
    if dl.device.type == "cpu":
        ext = ext_product_plain(dl, key)
        if out is None:
            return ext
        return out.add_(ext) if accumulate else out.copy_(ext)
    if dl.device.type != "cuda":
        raise ValueError(f"no external-product kernel for {dl.device}")
    lib = _library(dl.device.index)
    if body is None:
        body = pick_body(B, N, cuda_build.sm_count(dl.device.index), cols)
    # the kernel adds its blocks' partial sums into out
    if out is None:
        out = torch.zeros((B, cols, N), dtype=torch.int64, device=dl.device)
    elif not accumulate:
        out.zero_()
    with torch.cuda.device(dl.device):
        err = lib.fhe_ext_product(
            dl.data_ptr(), key.data_ptr(), out.data_ptr(), B, N, cols, *body,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "ext_product")
    ext_product.launches += 1
    return out


ext_product.launches = 0
