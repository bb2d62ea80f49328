"""One step's 64-bit external product by a two-prime negacyclic NTT: the
hand-written CUDA kernel and its plain PyTorch version.

Replaces ``fhestring_tpu/crypto/kernels/ntt_ext.py: ntt_ext_u64`` (a Pallas
TPU kernel: a grouped 3-prime NTT of four-step int8 dots on the MXU).  It
computes the same function as ``ext_product`` (K3), for each batch item b
and output row col,

    ext[b, col] = sum_r d[b, r] (x) K[r, col]   (negacyclic, mod 2^64),

from the same digit limbs dl int8 [3, B, (k+1)*N] (``rotate_decompose``'s
output), but against one step of the NTT-domain key the 64-bit blind
rotation reads, ``DeviceServerKeys.bsk_ntt64[j]`` int16 [2, k+1, (k+1)*8,
N]: no 3-prime key is packed.  It is one step of ``blind_rotate64``'s exact
mode without the accumulator update: forward transforms of the 6 digit-limb
polys mod 40961 and 61441, pointwise products with the key hats, inverse
transforms of the 16 shift-plane polys, and the centered two-prime CRT of
each plane W_s, exact since |W_s| <= 2.01e8 < M/2 (``blind_rotate64``);
ext = sum_s W_s << 8s.

The kernel (``csrc/ntt_ext.cu``) shares its device code with
``csrc/blind_rotate64.cu`` (``csrc/ntt64.cuh``) and runs one block of 1,024
threads per item.  What bounds it on an H100: the butterflies on the CUDA
cores (22 transforms of length N per prime and step) and one barrier per
butterfly stage; a batch of up to 132 items is one wave.  The plain version
is ``blind_rotate64.ext_product_ntt``, the step body of
``blind_rotate64_plain``.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import ntt
from ..keys import KEY_PLANES64
from . import blind_rotate64 as br64
from . import cuda_build

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FUNCTIONS = {"fhe_ntt_ext": ([_VP, _VP, _VP, _VP, _INT, _INT, _VP], _INT),
              "fhe_ntt_ext_init": ([], _INT)}


def build() -> str:
    """Compile the kernel (``cuda_build``) and load it, once per process.
    Returns the path of the shared library."""
    cuda_build.load("ntt_ext", _FUNCTIONS)
    return cuda_build.library_path("ntt_ext")


def _library(device_index: int) -> ctypes.CDLL:
    return cuda_build.ready("ntt_ext", _FUNCTIONS, "fhe_ntt_ext_init",
                            device_index)


def prepare(device: torch.device, n: int) -> None:
    """Everything a launch on that CUDA device needs that a stream capture
    could not do: builds and loads the kernel and puts the twiddle table of size n on it."""
    _library(device.index)
    ntt.kernel_twiddles(n, str(device))


def _check(dl: torch.Tensor, khat_j: torch.Tensor) -> None:
    if dl.dtype != torch.int8 or khat_j.dtype != torch.int16:
        raise TypeError("dl must be int8 and khat_j int16")
    if dl.dim() != 3 or khat_j.dim() != 4:
        raise ValueError("expected dl [3, B, (k+1)*N] and khat_j "
                         "[2, k+1, (k+1)*8, N]")
    kp1, N = br64.GLWE_ROWS, khat_j.shape[-1]
    want = (len(ntt.PRIMES), kp1, kp1 * KEY_PLANES64, N)
    if tuple(khat_j.shape) != want or N & (N - 1) or not 64 <= N <= 2048:
        raise ValueError(f"khat_j shape {tuple(khat_j.shape)}, expected "
                         f"{want} with N a power of two in [64, 2048]")
    if dl.shape[0] != br64.DIGIT_LIMBS or dl.shape[2] != kp1 * N:
        raise ValueError(f"dl shape {tuple(dl.shape)} does not match the key")
    if dl.device != khat_j.device:
        raise ValueError("dl and khat_j on different devices")
    if not (dl.is_contiguous() and khat_j.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def ntt_ext_plain(dl: torch.Tensor, khat_j: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (``blind_rotate64.ext_product_ntt`` in the
    exact mode).  Same arguments and result as ``ntt_ext``."""
    _check(dl, khat_j)
    L, B, _ = dl.shape
    kp1, N = br64.GLWE_ROWS, khat_j.shape[-1]
    limbs = dl.view(L, B, kp1, N).permute(1, 2, 0, 3).to(torch.int64)
    return br64.ext_product_ntt(limbs, khat_j)


def ntt_ext(dl: torch.Tensor, khat_j: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """One step's external product.

    dl: int8 [3, B, (k+1)*N] digit limbs (``rotate_diff_decompose``);
    khat_j: int16 [2, k+1, (k+1)*8, N], one step of
    ``DeviceServerKeys.bsk_ntt64``.  Returns int64 [B, k+1, N]: the
    external product mod 2^64 (u64 bits); out: where to put it (no
    allocation then).

    CPU tensors run ``ntt_ext_plain``; CUDA tensors launch the kernel
    (built at first use) and count the launch in ``ntt_ext.launches``.
    """
    _check(dl, khat_j)
    _, B, _ = dl.shape
    kp1, N = br64.GLWE_ROWS, khat_j.shape[-1]
    if out is not None:
        cuda_build.check_out(out, (B, kp1, N), torch.int64, dl.device)
    if dl.device.type == "cpu":
        ext = ntt_ext_plain(dl, khat_j)
        return ext if out is None else out.copy_(ext)
    if dl.device.type != "cuda":
        raise ValueError(f"no NTT external-product kernel for {dl.device}")
    lib = _library(dl.device.index)
    tw = ntt.kernel_twiddles(N, str(dl.device))
    if out is None:
        out = torch.empty((B, kp1, N), dtype=torch.int64, device=dl.device)
    with torch.cuda.device(dl.device):
        err = lib.fhe_ntt_ext(
            dl.data_ptr(), khat_j.data_ptr(), tw.data_ptr(), out.data_ptr(),
            B, N, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "ntt_ext")
    ntt_ext.launches += 1
    return out


ntt_ext.launches = 0
