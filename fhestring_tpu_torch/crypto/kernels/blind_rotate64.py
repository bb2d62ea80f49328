"""Whole 64-bit blind rotation: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``fhestring_tpu/crypto/kernels/blind_rotate_fused.py:
blind_rotate_fused`` (the Pallas kernel of the 64-bit set PARAM_PROD).
What it computes, for each batch item b and each of the n LWE mask
coefficients j, with the gadget of that set (ell = 1 level of base 2^23):

    d    = one signed 23-bit digit per coefficient of the k+1 rows, in
           [-2^22, 2^22):
             exact:   decompose(acc * X^a[b, j] - acc), the u64 rotated
                      and the difference rounded to its top 23 bits
                      (numpy_ref.decompose);
             rounded: acc_r = round(acc >> 41) mod 2^23, rotated in
                      Z_{2^23}, minus acc_r (numpy_ref.cmux_rounded);
    d    = sum_la dl_la * 256^la        (3 balanced int8 limbs)
    key  = sum_lb kl_lb * 256^lb        (8 balanced int8 limbs per u64
                                         key value, mod 2^64)
    W_s  = sum_{la+lb=s} sum_r dl_la[r] (x) kl_lb[r, col]   (negacyclic)
    acc += sum_s W_s << 8s  (mod 2^64), over s in [0, 8), or only
           s in [3, 8) in approx mode (numpy_ref.polymul_planes with
           min_shift=3).

The result is bit-identical to ``numpy_ref.blind_rotate(acc, lwe, srv,
rounded=rounded, min_shift=3 if approx else 0)``, the contract of the TPU
kernel.  Production (``shortint`` on the card) runs rounded + approx.

Exactness.  Each W_s is an integer with |W_s| <= 3 pairs * R * N * 128 *
128 (R = k+1 = 2 digit rows, N = 2048: 2.01e8).  It is computed by a
negacyclic NTT mod 40961 and mod 61441 and rebuilt by a centered two-prime
CRT, which is exact for |W_s| < M/2 = 1.26e9 (M = 40961 * 61441); the
TPU kernel's 3-prime grouping of planes is not needed.  All residue
products are below 2**32, so the kernel's transforms use 32-bit words (a
plane's 6 products are summed in 64 bits) and uint64_t holds the
accumulator, and the plain version uses
int64 (whose wraparound is pinned against numpy uint64 by the tests).

The kernel (``csrc/blind_rotate64.cu``) keeps an item's u64 accumulator in
shared memory for all n steps.  What bounds it on an H100 is integer
instructions on the CUDA cores (per prime 6 forward and 16 inverse
transforms of length N in exact mode, 6 and 10 in approx mode; the key,
256 KB a step or 224 KB in approx mode, which never reads the key's limb 0,
comes through L2 and is far from binding), and one item on one SM reaches
1/132 of the card's rate.  So the kernel has four bodies with the same
bits (``cluster.py``): one block per item, and a thread-block cluster of 2,
4 or 8 blocks per item that splits the step by prime, by prime and output
row, or by prime, output row and half of the row's product planes (3 + 2
in approx mode, 4 + 4 in exact mode), and exchanges the parts through
distributed shared memory (``csrc/rotate_cluster.cuh`` says which block
stores what into which, and why two cluster barriers a step order it at
every size).  The 8-block body runs an item's step on twice the SMs of the
4-block body for the batches of up to one wave of 8-clusters (about 16 on
an H100).  ``cluster_size`` picks the body from the batch and the card;
``cluster=`` forces one.  The source says what share of the bound each
reaches.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import torus
from .. import ntt
from ..keys import KEY_PLANES64
from . import cuda_build
from . import cluster as _cluster
from .cluster import WaveCost

BASE_LOG = 23
LEVELS = 1
GLWE_ROWS = 2  # k + 1; with ell = 1 also the number of digit rows R
DIGIT_LIMBS = 3  # balanced int8 limbs of a digit: (BASE_LOG + 8) // 8
APPROX_MIN_SHIFT = 3  # approx mode drops shift planes s < 3
# One wave of each body relative to the one-block body's, measured on an
# H100 at N = 2048 (PERF.md); every mode of the kernel is within 5% of it.
WAVE_COST = WaveCost(one_block=(1.0, 2.0),
                     cluster={2: 0.575, 4: 0.342, 8: 0.290})
CLUSTERS = _cluster.bodies(WAVE_COST)  # blocks per item of each body

_SHIFT = 64 - BASE_LOG
_MASK = (1 << BASE_LOG) - 1
_HALF = 1 << (BASE_LOG - 1)
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FUNCTIONS = {
    "fhe_blind_rotate64": (
        [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _VP],
        _INT),
    "fhe_blind_rotate64_max_clusters": ([_INT, _INT, _INT, _INT], _INT),
    "fhe_blind_rotate64_init": ([], _INT)}


def max_plane_value(n: int) -> int:
    """Worst-case |W_s|: at most 3 (la, lb) pairs per shift plane, R = 2
    digit rows, |digit limb| <= 128, |key limb| <= 128."""
    return DIGIT_LIMBS * GLWE_ROWS * n * 128 * 128


def shift_planes(approx: bool) -> range:
    """The shift planes s the mode accumulates."""
    return range(APPROX_MIN_SHIFT if approx else 0, KEY_PLANES64)


def build() -> str:
    """Compile the kernel (``cuda_build``) and load it, once per process.
    Returns the path of the shared library."""
    cuda_build.load("blind_rotate64", _FUNCTIONS)
    return cuda_build.library_path("blind_rotate64")


def _library(device_index: int) -> ctypes.CDLL:
    return cuda_build.ready("blind_rotate64", _FUNCTIONS, "fhe_blind_rotate64_init",
                            device_index)


def _check(acc: torch.Tensor, amounts: torch.Tensor,
           khat: torch.Tensor) -> None:
    if acc.dtype != torch.int64 or amounts.dtype != torch.int32:
        raise TypeError("acc must be int64 and amounts int32")
    if khat.dtype != torch.int16:
        raise TypeError("khat must be int16")
    if acc.dim() != 3 or amounts.dim() != 2 or khat.dim() != 5:
        raise ValueError("expected acc [B, k+1, N], amounts [B, n], "
                         "khat [n, 2, k+1, (k+1)*8, N]")
    B, kp1, N = acc.shape
    if kp1 != GLWE_ROWS or N & (N - 1) or not 64 <= N <= 2048:
        raise ValueError(f"unsupported accumulator shape {tuple(acc.shape)}")
    if amounts.shape[0] != B:
        raise ValueError("amounts batch differs from acc")
    want = (amounts.shape[1], len(ntt.PRIMES), kp1, kp1 * KEY_PLANES64, N)
    if tuple(khat.shape) != want:
        raise ValueError(f"khat shape {tuple(khat.shape)}, expected {want}")
    if not (acc.device == amounts.device == khat.device):
        raise ValueError("acc, amounts and khat on different devices")
    if not (acc.is_contiguous() and amounts.is_contiguous()
            and khat.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    assert max_plane_value(N) < ntt.M // 2


def _rotate(x: torch.Tensor, a: torch.Tensor, neg) -> torch.Tensor:
    """x [B, C, N] times X^a[b] (a in [0, 2N)), negation given by ``neg``."""
    B, C, N = x.shape
    idx = (torch.arange(N, device=x.device) - a[:, None]) & (2 * N - 1)
    rot = torch.gather(x, 2, (idx & (N - 1))[:, None, :].expand(B, C, N))
    return torch.where((idx >= N)[:, None, :], neg(rot), rot)


def _digits(acc: torch.Tensor, a: torch.Tensor, rounded: bool
            ) -> torch.Tensor:
    """Signed digits int64 [B, k+1, N] in [-2^22, 2^22) of one step."""
    if rounded:
        acc_r = torus.round_shr(acc, _SHIFT) & _MASK
        rot = _rotate(acc_r, a, lambda v: (0 - v) & _MASK)
        state = (rot - acc_r) & _MASK
    else:
        diff = torus.sub(_rotate(acc, a, torus.neg), acc)
        state = torus.round_shr(diff, _SHIFT) & _MASK
    return state - ((state >= _HALF).to(torch.int64) << BASE_LOG)


def _limbs(d: torch.Tensor) -> torch.Tensor:
    """Digits [B, R, N] -> balanced int8-range limbs [B, R, 3, N]."""
    out = []
    for _ in range(DIGIT_LIMBS):
        limb = ((d + 128) & 255) - 128
        out.append(limb)
        d = (d - limb) >> 8
    return torch.stack(out, dim=2)


def ext_product_ntt(dl: torch.Tensor, khat_j: torch.Tensor, *,
                    approx: bool = False) -> torch.Tensor:
    """One step's external product, the kernel's arithmetic in int64:
    digit limbs dl int64 [B, k+1, 3, N] (row r, limb la) against one step
    of the key, khat_j int16 [2, k+1, (k+1)*8, N].  Returns
    sum_s W_s << 8s (mod 2^64) over the mode's shift planes, int64
    [B, k+1, N] (output row col)."""
    B, kp1, _, N = dl.shape
    dev = dl.device
    tw = ntt.device_twiddles(N, str(dev))
    p = torch.tensor(ntt.PRIMES, dtype=torch.int64, device=dev)
    planes = shift_planes(approx)
    s0 = planes.start
    shifts = torch.tensor([8 * s for s in planes], device=dev)
    dl = dl.reshape(B, kp1 * DIGIT_LIMBS, N)              # (r, la)
    dhat = ntt.ntt_fwd(dl[None] % p.view(2, 1, 1, 1), tw)
    dhat = dhat.view(2, B, kp1, DIGIT_LIMBS, N)
    kh = (khat_j.to(torch.int64) & 0xFFFF).view(
        2, kp1, kp1, KEY_PLANES64, N)                     # [P, r, col, lb, N]
    prod = torch.zeros((2, B, kp1, len(planes), N), dtype=torch.int64,
                       device=dev)
    for la in range(DIGIT_LIMBS):
        lb0 = max(0, s0 - la)
        lb1 = KEY_PLANES64 - la                           # s = la + lb < 8
        for r in range(kp1):
            prod[:, :, :, la + lb0 - s0:] += (
                dhat[:, :, None, None, r, la] * kh[:, None, r, :, lb0:lb1])
    res = ntt.ntt_inv(prod % p.view(2, 1, 1, 1, 1), tw)   # [P, B, col, s, N]
    w = ntt.crt_centered(res)                             # W_s [B, col, s, N]
    return torus.sum_axis(w << shifts.view(1, 1, -1, 1), 2)


def blind_rotate64_plain(acc: torch.Tensor, amounts: torch.Tensor,
                         khat: torch.Tensor, *, rounded: bool = False,
                         approx: bool = False) -> torch.Tensor:
    """The plain PyTorch version: the kernel's arithmetic (the same
    butterflies and tables), vectorised over the batch, in int64.  Same
    arguments and result as ``blind_rotate64``."""
    _check(acc, amounts, khat)
    for j in range(amounts.shape[1]):
        d = _digits(acc, amounts[:, j].to(torch.int64), rounded)
        acc = torus.add(acc, ext_product_ntt(_limbs(d), khat[j],
                                             approx=approx))
    return acc


def check_cluster(cluster) -> None:
    """Raise unless ``cluster`` is None (pick) or one of ``CLUSTERS``."""
    _cluster.check_cluster(cluster, WAVE_COST)


def cluster_size(batch: int, sms: int, n: int, occupancy=None) -> int:
    """Blocks per item this kernel runs a batch on: ``cluster.cluster_size``
    with this kernel's measured wave costs."""
    return _cluster.cluster_size(batch, sms, n, WAVE_COST, occupancy)


@functools.lru_cache(maxsize=None)
def max_active_clusters(device_index: int, cluster: int, n: int,
                        rounded: bool, approx: bool) -> int:
    """How many clusters of ``cluster`` blocks the device runs at once at
    polynomial size n in this mode (``cudaOccupancyMaxActiveClusters``; the
    modes differ in shared memory); raises if the device refuses the body."""
    lib = _library(device_index)
    with torch.cuda.device(device_index):
        count = lib.fhe_blind_rotate64_max_clusters(n, int(rounded),
                                                    int(approx), cluster)
    cuda_build.check(lib, max(-count, 0), "blind_rotate64 cluster occupancy")
    return count


def blind_rotate64(acc: torch.Tensor, amounts: torch.Tensor,
                   khat: torch.Tensor, *, rounded: bool = False,
                   approx: bool = False,
                   cluster: int | None = None) -> torch.Tensor:
    """Run the whole 64-bit blind rotation.

    acc: int64 [B, k+1, N] initial accumulator (u64 bits);
    amounts: int32 [B, n] per-step rotation amounts in [0, 2N);
    khat: int16 [n, 2, k+1, (k+1)*8, N] (keys.pack_bsk_hats);
    rounded, approx: the mode (module docstring);
    cluster: the kernel body, blocks per item, one of CLUSTERS (default:
    ``pick_cluster``); the result does not depend on it.
    Returns int64 [B, k+1, N]: the final accumulator.

    CPU tensors run ``blind_rotate64_plain``; CUDA tensors launch the
    kernel (built at first use) and count the launch in
    ``blind_rotate64.launches`` and, by body, in ``blind_rotate64.bodies``.
    """
    _check(acc, amounts, khat)
    check_cluster(cluster)
    if acc.device.type == "cpu":
        return blind_rotate64_plain(acc, amounts, khat, rounded=rounded,
                                    approx=approx)
    if acc.device.type != "cuda":
        raise ValueError(f"no blind-rotation kernel for {acc.device}")
    lib = _library(acc.device.index)
    B, _, N = acc.shape
    if cluster is None:
        cluster = pick_cluster(B, N, acc.device.index, rounded=rounded,
                               approx=approx)
    tw = ntt.kernel_twiddles(N, str(acc.device))
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        err = lib.fhe_blind_rotate64(
            acc.data_ptr(), out.data_ptr(), amounts.data_ptr(),
            khat.data_ptr(), tw.data_ptr(), B, amounts.shape[1], N,
            int(rounded), int(approx), cluster,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, f"blind_rotate64<{cluster}>")
    blind_rotate64.launches += 1
    blind_rotate64.bodies[cluster] += 1
    return out


def pick_cluster(batch: int, n: int, device_index: int, *,
                 rounded: bool = False, approx: bool = False) -> int:
    """The body ``blind_rotate64`` runs for this batch on this device."""
    return cluster_size(
        batch, cuda_build.sm_count(device_index), n,
        lambda c, n_: max_active_clusters(device_index, c, n_, bool(rounded),
                                          bool(approx)))


blind_rotate64.launches = 0
blind_rotate64.bodies = dict.fromkeys(CLUSTERS, 0)
