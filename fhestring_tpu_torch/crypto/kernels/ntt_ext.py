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
``csrc/blind_rotate64.cu`` (``csrc/ntt64.cuh``) and has three of that
kernel's bodies with the same bits: one block of 1,024 threads per item, or a
thread-block cluster of 2 or 4 blocks per item (``csrc/rotate_cluster.cuh``
run for a single step: split by prime, or by prime and output row), so that
a batch of a few items uses 2 or 4 times as many SMs.  ``cluster=`` forces a
body; otherwise ``cluster.cluster_size`` picks it from the batch, the SM
count and how many clusters the card runs at once.  With ``out=acc,
accumulate=True`` the kernel adds the product to the accumulator itself
(each word has one writer).  What bounds it on an H100: the butterflies on
the CUDA cores (22 transforms of length N per prime and step) and one
barrier per butterfly stage; a batch of up to 132 items is one wave of the
one-block body.  The plain version is ``blind_rotate64.ext_product_ntt``,
the step body of ``blind_rotate64_plain``.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import ntt
from ..keys import KEY_PLANES64
from . import blind_rotate64 as br64
from . import cluster as _cluster
from . import cuda_build
from .cluster import WaveCost

# One wave of each body relative to the one-block body's, measured on an
# H100 at N = 2048 (PERF.md, ``tools/stepwise_sweep``).
WAVE_COST = WaveCost(one_block=(1.0, 2.0), cluster={2: 0.605, 4: 0.350})
CLUSTERS = _cluster.bodies(WAVE_COST)  # blocks per item of each body
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FUNCTIONS = {"fhe_ntt_ext": ([_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                               _VP], _INT),
              "fhe_ntt_ext_max_clusters": ([_INT, _INT], _INT),
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
    could not do: builds and loads the kernel, puts the twiddle table of
    size n on it and asks the card how many clusters of each body run at
    once (the pick's question)."""
    _library(device.index)
    ntt.kernel_twiddles(n, str(device))
    for c in CLUSTERS[1:]:
        max_active_clusters(device.index, c, n)


def check_cluster(cluster) -> None:
    """Raise unless ``cluster`` is None (pick) or one of ``CLUSTERS``."""
    _cluster.check_cluster(cluster, WAVE_COST)


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


@functools.lru_cache(maxsize=None)
def max_active_clusters(device_index: int, cluster: int, n: int) -> int:
    """How many clusters of ``cluster`` blocks the device runs at once at
    polynomial size n (``cudaOccupancyMaxActiveClusters``); raises if the
    device refuses the body."""
    lib = _library(device_index)
    with torch.cuda.device(device_index):
        count = lib.fhe_ntt_ext_max_clusters(n, cluster)
    cuda_build.check(lib, max(-count, 0), "ntt_ext cluster occupancy")
    return count


def pick_cluster(batch: int, n: int, device_index: int) -> int:
    """The body ``ntt_ext`` runs for this batch on this device."""
    return _cluster.cluster_size(
        batch, cuda_build.sm_count(device_index), n, WAVE_COST,
        lambda c, n_: max_active_clusters(device_index, c, n_))


def ntt_ext(dl: torch.Tensor, khat_j: torch.Tensor,
            out: torch.Tensor | None = None, accumulate: bool = False,
            cluster: int | None = None) -> torch.Tensor:
    """One step's external product.

    dl: int8 [3, B, (k+1)*N] digit limbs (``rotate_diff_decompose``);
    khat_j: int16 [2, k+1, (k+1)*8, N], one step of
    ``DeviceServerKeys.bsk_ntt64``.  Returns int64 [B, k+1, N]: the
    external product mod 2^64 (u64 bits); out: where to put it (no
    allocation then); with accumulate=True the product is added to out (mod
    2^64) instead, the step ``acc += ext`` in one launch.  cluster: the
    kernel body, blocks per item, one of CLUSTERS (default:
    ``pick_cluster``); the result does not depend on it.

    CPU tensors run ``ntt_ext_plain``; CUDA tensors launch the kernel
    (built at first use) and count the launch in ``ntt_ext.launches`` and,
    by body, in ``ntt_ext.bodies``.
    """
    _check(dl, khat_j)
    check_cluster(cluster)
    _, B, _ = dl.shape
    kp1, N = br64.GLWE_ROWS, khat_j.shape[-1]
    if out is not None:
        cuda_build.check_out(out, (B, kp1, N), torch.int64, dl.device)
    elif accumulate:
        raise ValueError("accumulate=True needs out")
    if dl.device.type == "cpu":
        ext = ntt_ext_plain(dl, khat_j)
        if out is None:
            return ext
        return out.add_(ext) if accumulate else out.copy_(ext)
    if dl.device.type != "cuda":
        raise ValueError(f"no NTT external-product kernel for {dl.device}")
    lib = _library(dl.device.index)
    if cluster is None:
        cluster = pick_cluster(B, N, dl.device.index)
    tw = ntt.kernel_twiddles(N, str(dl.device))
    if out is None:
        out = torch.empty((B, kp1, N), dtype=torch.int64, device=dl.device)
    with torch.cuda.device(dl.device):
        err = lib.fhe_ntt_ext(
            dl.data_ptr(), khat_j.data_ptr(), tw.data_ptr(), out.data_ptr(),
            B, N, int(accumulate), cluster,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, f"ntt_ext<{cluster}>")
    ntt_ext.launches += 1
    ntt_ext.bodies[cluster] += 1
    return out


ntt_ext.launches = 0
ntt_ext.bodies = dict.fromkeys(CLUSTERS, 0)
