"""Whole 32-bit blind rotation: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``fhestring_tpu/crypto/kernels/blind_rotate_fused32.py:
blind_rotate_fused32`` (the Pallas kernel of the turbo set).  What it
computes, for each batch item b and each of the n LWE mask coefficients j:

    rot  = acc * X^a[b, j]            (exact negacyclic rotation, u32 plane)
    d    = decompose(rot - acc)       (closest-representable rounding to
                                       the top 24 bits, 3 balanced base-256
                                       digits per row: R = (k+1)*3 polys)
    W_s  = sum_i d_i (x) key[j, i, :, s]   (negacyclic products against the
                                       4 balanced byte limbs s of the u32
                                       bootstrap-key payload)
    acc += sum_s W_s << 8s            (mod 2**32)

The accumulator is the u32 payload of a 32-bit-subgroup torus value, held
in an int32 tensor; the result is bit-identical to
``numpy_ref.blind_rotate`` (exact mode) on that payload.

Exactness.  Each W_s is an integer with |W_s| <= R * N * 128 * 128
(R = 6, N = 2048: 2.01e8).  It is computed by a negacyclic NTT mod
40961 and mod 61441 and rebuilt by a centered two-prime CRT, which is exact
for |W_s| < M/2 = 1.26e9 (M = 40961 * 61441).  All residue products are
below 2**32, so the kernel's transforms use 32-bit words (a plane's 6
products are summed in 64 bits), and the plain version int64.

The kernel (``csrc/blind_rotate32.cu``) keeps an item's accumulator in
shared memory for all n steps.  What bounds it on an H100 is integer
instructions on the CUDA cores (28 transforms of length N and 196,608
multiply-adds a step; the key, 393 KB a step, comes through L2 and is far
from binding), and one item on one SM reaches 1/132 of the card's rate.
So the kernel has four bodies with the same bits (``cluster.py``): one
block per item, and a thread-block cluster of 2, 4 or 8 blocks per item
that splits the step by prime, by prime and output row, or by prime,
output row and half of the row's 4 product planes, and exchanges the parts
through distributed shared memory (``csrc/rotate_cluster.cuh`` says which
block stores what into which, and why two cluster barriers a step order it
at every size).  The 8-block body runs an item's step on twice the SMs of
the 4-block body for the batches of up to one wave of 8-clusters (about 16
on an H100).  ``cluster_size`` picks the body
from the batch and the card; ``cluster=`` forces one.  The source says what
share of the bound each reaches.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import ntt
from ..keys import KEY_PLANES
from . import cuda_build
from . import cluster as _cluster
from .cluster import WaveCost

BASE_LOG = 8
LEVELS = 3
GLWE_ROWS = 2  # k + 1
# One wave of each body relative to the one-block body's, measured on an
# H100 at N = 2048 (PERF.md); every mode of the kernel is within 5% of it.
WAVE_COST = WaveCost(one_block=(1.0, 1.76),
                     cluster={2: 0.539, 4: 0.302, 8: 0.257})
CLUSTERS = _cluster.bodies(WAVE_COST)  # blocks per item of each body

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FUNCTIONS = {
    "fhe_blind_rotate32": (
        [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP], _INT),
    "fhe_blind_rotate32_max_clusters": ([_INT, _INT], _INT),
    "fhe_blind_rotate32_init": ([], _INT)}


def max_plane_value(num_r: int, n: int) -> int:
    """Worst-case |W_s|: R digit polys, |digit| <= 128, |limb| <= 128."""
    return num_r * n * 128 * 128


def build() -> str:
    """Compile the kernel (``cuda_build``) and load it, once per process.
    Returns the path of the shared library."""
    cuda_build.load("blind_rotate32", _FUNCTIONS)
    return cuda_build.library_path("blind_rotate32")


def _library(device_index: int) -> ctypes.CDLL:
    return cuda_build.ready("blind_rotate32", _FUNCTIONS, "fhe_blind_rotate32_init",
                            device_index)


def _check(acc_hi: torch.Tensor, amounts: torch.Tensor,
           khat: torch.Tensor) -> None:
    if acc_hi.dtype != torch.int32 or amounts.dtype != torch.int32:
        raise TypeError("acc_hi and amounts must be int32")
    if khat.dtype != torch.int16:
        raise TypeError("khat must be int16")
    if acc_hi.dim() != 3 or amounts.dim() != 2 or khat.dim() != 5:
        raise ValueError("expected acc_hi [B, k+1, N], amounts [B, n], "
                         "khat [n, 2, R, (k+1)*4, N]")
    B, kp1, N = acc_hi.shape
    R = kp1 * LEVELS
    if kp1 != GLWE_ROWS or N & (N - 1) or not 64 <= N <= 2048:
        raise ValueError(f"unsupported accumulator shape {tuple(acc_hi.shape)}")
    if amounts.shape[0] != B:
        raise ValueError("amounts batch differs from acc_hi")
    want = (amounts.shape[1], len(ntt.PRIMES), R, kp1 * KEY_PLANES, N)
    if tuple(khat.shape) != want:
        raise ValueError(f"khat shape {tuple(khat.shape)}, expected {want}")
    if not (acc_hi.device == amounts.device == khat.device):
        raise ValueError("acc_hi, amounts and khat on different devices")
    if not (acc_hi.is_contiguous() and amounts.is_contiguous()
            and khat.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    assert max_plane_value(R, N) < ntt.M // 2


def _decompose(diff: torch.Tensor) -> torch.Tensor:
    """u32 payloads (int64 [..., N]) -> balanced base-256 digits
    [..., LEVELS, N], level 0 most significant; identical to
    numpy_ref.decompose on diff << 32."""
    shift = 32 - BASE_LOG * LEVELS
    state = (diff >> shift) + ((diff >> (shift - 1)) & 1)
    digits = [None] * LEVELS
    for lev in range(LEVELS - 1, -1, -1):
        d = state & 255
        state = state >> 8
        carry = (d >= 128).to(torch.int64)
        digits[lev] = d - (carry << 8)
        state = state + carry
    return torch.stack(digits, dim=-2)


def blind_rotate32_plain(acc_hi: torch.Tensor, amounts: torch.Tensor,
                         khat: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the kernel's arithmetic, vectorised over
    the batch, in int64.  Same arguments and result as ``blind_rotate32``."""
    _check(acc_hi, amounts, khat)
    B, kp1, N = acc_hi.shape
    dev = acc_hi.device
    tw = ntt.device_twiddles(N, str(dev))
    p = torch.tensor(ntt.PRIMES, dtype=torch.int64, device=dev)
    shifts = torch.arange(KEY_PLANES, device=dev) * 8
    acc = acc_hi.to(torch.int64) & 0xFFFFFFFF
    t = torch.arange(N, device=dev)
    for j in range(amounts.shape[1]):
        idx = (t - amounts[:, j, None].to(torch.int64)) & (2 * N - 1)
        src = (idx & (N - 1))[:, None, :].expand(B, kp1, N)
        rot = torch.gather(acc, 2, src)
        rot = torch.where((idx >= N)[:, None, :], -rot, rot)
        diff = (rot - acc) & 0xFFFFFFFF
        digits = _decompose(diff).reshape(B, kp1 * LEVELS, N)
        dhat = ntt.ntt_fwd(digits[None] % p.view(2, 1, 1, 1), tw)
        kh = khat[j].to(torch.int64) & 0xFFFF            # [2, R, KO, N]
        prod = torch.zeros((2, B) + kh.shape[2:], dtype=torch.int64,
                           device=dev)
        for i in range(kh.shape[1]):
            prod += dhat[:, :, i, None, :] * kh[:, None, i]
        res = ntt.ntt_inv(prod % p.view(2, 1, 1, 1), tw)   # [2, B, KO, N]
        w = ntt.crt_centered(res)                          # W_s
        w = w.view(B, kp1, KEY_PLANES, N) << shifts.view(1, 1, -1, 1)
        acc = (acc + w.sum(dim=2)) & 0xFFFFFFFF
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def check_cluster(cluster) -> None:
    """Raise unless ``cluster`` is None (pick) or one of ``CLUSTERS``."""
    _cluster.check_cluster(cluster, WAVE_COST)


def cluster_size(batch: int, sms: int, n: int, occupancy=None) -> int:
    """Blocks per item this kernel runs a batch on: ``cluster.cluster_size``
    with this kernel's measured wave costs."""
    return _cluster.cluster_size(batch, sms, n, WAVE_COST, occupancy)


@functools.lru_cache(maxsize=None)
def max_active_clusters(device_index: int, cluster: int, n: int) -> int:
    """How many clusters of ``cluster`` blocks the device runs at once at
    polynomial size n (``cudaOccupancyMaxActiveClusters``); raises if the
    device refuses the body."""
    lib = _library(device_index)
    with torch.cuda.device(device_index):
        count = lib.fhe_blind_rotate32_max_clusters(n, cluster)
    cuda_build.check(lib, max(-count, 0), "blind_rotate32 cluster occupancy")
    return count


def blind_rotate32(acc_hi: torch.Tensor, amounts: torch.Tensor,
                   khat: torch.Tensor, *,
                   cluster: int | None = None) -> torch.Tensor:
    """Run the whole 32-bit blind rotation.

    acc_hi: int32 [B, k+1, N] initial accumulator (u32 payloads);
    amounts: int32 [B, n] per-step rotation amounts in [0, 2N);
    khat: int16 [n, 2, R, (k+1)*4, N] (keys.pack_bsk_hats);
    cluster: the kernel body, blocks per item, one of CLUSTERS (default:
    ``pick_cluster``); the result does not depend on it.
    Returns int32 [B, k+1, N]: the final accumulator payloads.

    CPU tensors run ``blind_rotate32_plain``; CUDA tensors launch the
    kernel (built at first use) and count the launch in
    ``blind_rotate32.launches`` and, by body, in ``blind_rotate32.bodies``.
    """
    _check(acc_hi, amounts, khat)
    check_cluster(cluster)
    if acc_hi.device.type == "cpu":
        return blind_rotate32_plain(acc_hi, amounts, khat)
    if acc_hi.device.type != "cuda":
        raise ValueError(f"no blind-rotation kernel for {acc_hi.device}")
    lib = _library(acc_hi.device.index)
    B, _, N = acc_hi.shape
    if cluster is None:
        cluster = pick_cluster(B, N, acc_hi.device.index)
    tw = ntt.kernel_twiddles(N, str(acc_hi.device))
    out = torch.empty_like(acc_hi)
    with torch.cuda.device(acc_hi.device):
        err = lib.fhe_blind_rotate32(
            acc_hi.data_ptr(), out.data_ptr(), amounts.data_ptr(),
            khat.data_ptr(), tw.data_ptr(), B, amounts.shape[1], N, cluster,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, f"blind_rotate32<{cluster}>")
    blind_rotate32.launches += 1
    blind_rotate32.bodies[cluster] += 1
    return out


def pick_cluster(batch: int, n: int, device_index: int) -> int:
    """The body ``blind_rotate32`` runs for this batch on this device."""
    return cluster_size(
        batch, cuda_build.sm_count(device_index), n,
        lambda c, n_: max_active_clusters(device_index, c, n_))


blind_rotate32.launches = 0
blind_rotate32.bodies = dict.fromkeys(CLUSTERS, 0)
