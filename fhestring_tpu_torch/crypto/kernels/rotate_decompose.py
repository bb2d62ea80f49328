"""Per-step prologue of the step-wise 64-bit blind rotation: the
hand-written CUDA kernel and its plain PyTorch version.

Replaces ``fhestring_tpu/crypto/kernels/rotate_decompose.py:
rotate_diff_decompose`` (a Pallas TPU kernel).  What it computes, for each
batch item b with amount a[b] in [0, 2N):

    diff = acc * X^a[b] - acc          (negacyclic rotation, u64 wrap)
    d    = decompose(diff, 2^23, ell=1) (round to the top 23 bits, balanced
                                        digit in [-2^22, 2^22))
    dl   = 3 balanced int8 limbs of d, int8 [3, B, (k+1)*N] (limb, item,
           row-major (r, t)): the JAX kernel's output layout.

It is the exact-mode digit of ``blind_rotate64`` (``_digits`` and
``_limbs``, which the plain version reuses), one step at a time, for the
step-wise routes of ``crypto/pbs.py``: K5 feeds K3 (``ext_product``) or K4
(``ntt_ext``).

The kernel (``csrc/rotate_decompose.cu``) runs one thread per 4
neighbouring coefficients: 16-byte loads of the accumulator, a gather of the
sources with the negacyclic sign, the u64 difference in ``uint64_t``, the
rounding and the limb split, and one packed store per limb plane.  What
bounds it on an H100: device memory, 16 bytes read and 3 written per
coefficient.  At a request's batches that is a microsecond or two on the
card, less than the host needs to start a launch, so the step loop
(``crypto/pbs.py``) gives the wrapper its output buffer (``out=``: no
allocation per step) and replays the captured launches as a CUDA graph.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import blind_rotate64 as br64
from . import cuda_build

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FUNCTIONS = {"fhe_rotate_decompose": ([_VP, _VP, _VP, _INT, _INT, _VP],
                                       _INT),
              "fhe_rotate_decompose_init": ([], _INT)}


def build() -> str:
    """Compile the kernel (``cuda_build``) and load it, once per process.
    Returns the path of the shared library."""
    cuda_build.load("rotate_decompose", _FUNCTIONS)
    return cuda_build.library_path("rotate_decompose")


def _library(device_index: int) -> ctypes.CDLL:
    return cuda_build.ready("rotate_decompose", _FUNCTIONS,
                            "fhe_rotate_decompose_init", device_index)


def prepare(device: torch.device) -> None:
    """Everything a launch on that CUDA device needs that a stream capture
    could not do: builds and loads the kernel."""
    _library(device.index)


def _check(acc: torch.Tensor, amounts: torch.Tensor) -> None:
    if acc.dtype != torch.int64 or amounts.dtype != torch.int32:
        raise TypeError("acc must be int64 and amounts int32")
    if acc.dim() != 3 or amounts.dim() != 1:
        raise ValueError("expected acc [B, k+1, N] and amounts [B]")
    B, kp1, N = acc.shape
    if kp1 != br64.GLWE_ROWS or N & (N - 1) or not 64 <= N <= 2048:
        raise ValueError(f"unsupported accumulator shape {tuple(acc.shape)}")
    if amounts.shape[0] != B:
        raise ValueError("amounts batch differs from acc")
    if acc.device != amounts.device:
        raise ValueError("acc and amounts on different devices")
    if not (acc.is_contiguous() and amounts.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def rotate_diff_decompose_plain(acc: torch.Tensor,
                                amounts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (the exact branch of
    ``blind_rotate64._digits`` and ``_limbs``).  Same arguments and result
    as ``rotate_diff_decompose``."""
    _check(acc, amounts)
    B, kp1, N = acc.shape
    d = br64._digits(acc, amounts.to(torch.int64), rounded=False)
    limbs = br64._limbs(d)                                # [B, R, 3, N]
    return limbs.permute(2, 0, 1, 3).reshape(
        br64.DIGIT_LIMBS, B, kp1 * N).to(torch.int8)


def rotate_diff_decompose(acc: torch.Tensor, amounts: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """One step's digit limbs.

    acc: int64 [B, k+1, N] accumulator (u64 bits); amounts: int32 [B] in
    [0, 2N).  Returns int8 [3, B, (k+1)*N]; out: where to put it (no
    allocation then).

    CPU tensors run ``rotate_diff_decompose_plain``; CUDA tensors launch the
    kernel (built at first use) and count the launch in
    ``rotate_diff_decompose.launches``.
    """
    _check(acc, amounts)
    B, kp1, N = acc.shape
    shape = (br64.DIGIT_LIMBS, B, kp1 * N)
    if out is not None:
        cuda_build.check_out(out, shape, torch.int8, acc.device)
    if acc.device.type == "cpu":
        dl = rotate_diff_decompose_plain(acc, amounts)
        return dl if out is None else out.copy_(dl)
    if acc.device.type != "cuda":
        raise ValueError(f"no rotate-decompose kernel for {acc.device}")
    lib = _library(acc.device.index)
    if out is None:
        out = torch.empty(shape, dtype=torch.int8, device=acc.device)
    with torch.cuda.device(acc.device):
        err = lib.fhe_rotate_decompose(
            acc.data_ptr(), amounts.data_ptr(), out.data_ptr(), B, N,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "rotate_decompose")
    rotate_diff_decompose.launches += 1
    return out


rotate_diff_decompose.launches = 0
