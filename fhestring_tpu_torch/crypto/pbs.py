"""Batched programmable bootstrap on PyTorch, both torus families.

Pipeline (KS -> PBS order, as the JAX package's ``crypto/pbs.py``):

    LWE(big key, k*N)  --keyswitch-->  LWE(small key, n)
                       --modswitch-->  Z_{2N} coefficients
                       --test-poly rotation--> GLWE accumulator
                       --blind rotate--> (kernels/blind_rotate32.py or
                                          kernels/blind_rotate64.py, or
                                          step by step: below)
                       --sample extract--> LWE(big key) of table[m]

Torus values are int64 tensors holding the u64 residue (``torus.py``).  In
the 32-bit-torus family (turbo) every value is a multiple of 2**32, so the
blind rotation carries only the u32 payload (int32); the 64-bit family
(``PARAM_PROD``) carries the whole int64 accumulator.

The 64-bit family has two blind-rotation routes, as the JAX package has:
one launch of the whole n-step kernel (``blind_rotate64``, K2), or the
step-wise route, one prologue and one external product per LWE step:

    for j in range(n):
        dl  = rotate_diff_decompose(acc, a_j)            (K5)
        acc = acc + ext_product(dl, bsk_limbs[j])        (K3, use_pallas)
                  | ntt_ext(dl, bsk_ntt64[j])            (K4, use_ntt2)

Both step-wise routes are exact and give the bits of K2's exact mode.  K3
adds its product into the accumulator itself, so its route is 2 launches a
step and K4's is 3.  On the card the n steps are captured once per (route,
batch, key) into a CUDA graph over static buffers and replayed for every
later batch of that shape: the host makes one graph launch instead of 2n
or 3n kernel launches.  On the CPU the loop is a plain Python loop.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from .. import torus
from ..params import CryptoParams
from .keys import DeviceServerKeys, key_planes
from .kernels import blind_rotate32 as br
from .kernels import blind_rotate64 as br64
from .kernels import ext_product as ep
from .kernels import ntt_ext as ne
from .kernels import rotate_decompose as rd


def _check_kernel_shape(p: CryptoParams) -> None:
    """The family's blind-rotation kernel takes this set's gadget and k."""
    if p.torus_bits == 32:
        shape = (br.BASE_LOG, br.LEVELS, br.GLWE_ROWS)
    else:
        shape = (br64.BASE_LOG, br64.LEVELS, br64.GLWE_ROWS)
    if (p.pbs_base_log, p.pbs_level, p.glwe_dimension + 1) != shape:
        raise ValueError(f"{p.name}: the {p.torus_bits}-bit blind-rotation "
                         f"kernel takes gadget 2^{shape[0]} x {shape[1]} "
                         f"and k = 1 only")


# ---------------------------------------------------------------------------
# Gadget decomposition
# ---------------------------------------------------------------------------

def decompose(v: torch.Tensor, base_log: int, levels: int) -> torch.Tensor:
    """Balanced signed decomposition of torus values; int64 [levels, ...]
    (level 0 most significant), matching numpy_ref.decompose bit-exactly."""
    shift = 64 - base_log * levels
    state = torus.round_shr(v, shift) if shift > 0 else v
    base = 1 << base_log
    digits = [None] * levels
    for lev in range(levels - 1, -1, -1):
        d = state & (base - 1)
        state = torus.shr(state, base_log)
        carry = (d >= base >> 1).to(torch.int64)
        digits[lev] = d - carry * base
        state = state + carry
    return torch.stack(digits)


# ---------------------------------------------------------------------------
# Keyswitch (big key -> small key)
# ---------------------------------------------------------------------------

def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32, exact.  (``torch.mm`` on int8
    returns int8 and wraps.)  CUDA's ``torch._int_mm`` needs M > 16 and
    K, N multiples of 8: rows are zero-padded here, columns at packing."""
    rows = a.shape[0]
    if a.is_cuda:
        padded = max(32, -(-rows // 8) * 8)
        if padded != rows:
            a = torch.cat([a, a.new_zeros((padded - rows, a.shape[1]))])
    return torch._int_mm(a, b)[:rows]


def keyswitch(ct: torch.Tensor, keys: DeviceServerKeys) -> torch.Tensor:
    """ct: int64 [B, kN+1] -> int64 [B, n+1].

    Exact: ks digits |d| <= 4, key limbs |l| <= 128, K = kN*ks_level terms,
    so every int32 sum is below 4 * 128 * K (2^22.3 at turbo)."""
    p = keys.params
    kn, n1 = p.big_lwe_dimension, p.lwe_dimension + 1
    digits = decompose(ct[:, :kn], p.ks_base_log, p.ks_level)  # [lev, B, kN]
    # K-order matches keys.pack_ksk: (i, lev) row-major.
    d = digits.permute(1, 2, 0).reshape(ct.shape[0], kn * p.ks_level)
    planes = _int8_matmul(d.to(torch.int8), keys.ksk_limbs)
    nplanes = key_planes(p)
    planes = planes[:, :n1 * nplanes].reshape(-1, n1, nplanes)
    # sum_s plane_s * 256**s mod 2**64 (JAX recombine_planes); the 4 planes
    # of a 32-bit-torus key are the u64 value's byte limbs 4..7
    low = 64 - 8 * nplanes
    acc = torch.zeros_like(planes[..., 0], dtype=torch.int64)
    for s in range(nplanes):
        acc = torus.add(acc, torus.shl(planes[..., s].to(torch.int64),
                                       low + 8 * s))
    out = torus.neg(acc)
    out[:, -1] += ct[:, kn]
    return out


# ---------------------------------------------------------------------------
# Modswitch, rotation, sample extraction
# ---------------------------------------------------------------------------

def modswitch(ct: torch.Tensor, p: CryptoParams) -> torch.Tensor:
    """int64 torus [..., n+1] -> int64 in [0, 2N) (rounding)."""
    two_n = 2 * p.polynomial_size
    shift = 64 - (two_n.bit_length() - 1)
    return torus.round_shr(ct, shift) & (two_n - 1)


def negacyclic_rotate(poly: torch.Tensor, amounts: torch.Tensor
                      ) -> torch.Tensor:
    """poly int64 [B, C, N]; amounts int64 [B] in [0, 2N): poly * X^amount."""
    B, C, N = poly.shape
    t = torch.arange(N, device=poly.device)
    idx = (t - amounts[:, None]) & (2 * N - 1)                   # [B, N]
    rot = torch.gather(poly, 2, (idx & (N - 1))[:, None, :].expand(B, C, N))
    return torch.where((idx >= N)[:, None, :], -rot, rot)


def sample_extract(acc: torch.Tensor, p: CryptoParams) -> torch.Tensor:
    """int64 [B, k+1, N] -> LWE int64 [B, kN+1] (coefficient 0)."""
    k = p.glwe_dimension
    mask = acc[:, :k, :]
    a = torch.cat([mask[:, :, :1], -torch.flip(mask[:, :, 1:], dims=[-1])],
                  dim=-1)
    return torch.cat([a.reshape(acc.shape[0], -1), acc[:, k, :1]], dim=-1)


def _run_steps(acc: torch.Tensor, steps: torch.Tensor, key: torch.Tensor,
               use_ntt2: bool, dl: torch.Tensor | None = None,
               ext: torch.Tensor | None = None) -> torch.Tensor:
    """The n steps, eagerly, updating acc in place: K5, then K3 adding into
    acc, or K4 and acc += ext.  steps: int32 [n, B].  dl and ext: the
    steps' buffers (allocated here if not given).  Nothing in the loop
    allocates or reads back to the host, so it can be captured."""
    B, kp1, N = acc.shape
    if dl is None:
        dl = torch.empty((br64.DIGIT_LIMBS, B, kp1 * N), dtype=torch.int8,
                         device=acc.device)
    if use_ntt2 and ext is None:
        ext = torch.empty_like(acc)
    for j in range(steps.shape[0]):
        rd.rotate_diff_decompose(acc, steps[j], out=dl)
        if use_ntt2:
            acc.add_(ne.ntt_ext(dl, key[j], out=ext))
        else:
            ep.ext_product(dl, key[j], out=acc, accumulate=True)
    return acc


@dataclasses.dataclass
class _StepGraph:
    """The captured steps of one (route, batch, key) and their buffers."""
    graph: torch.cuda.CUDAGraph
    key: torch.Tensor          # kept alive: the graph holds its address
    acc: torch.Tensor          # int64 [B, k+1, N], in and out
    steps: torch.Tensor        # int32 [n, B]
    # the steps' buffers: the graph writes them at every replay, so they
    # must not go back to the allocator while it lives
    scratch: tuple


STEP_GRAPHS_KEPT = 16  # least recently used graphs beyond this are dropped
_STEP_GRAPHS: collections.OrderedDict[tuple, _StepGraph] = (
    collections.OrderedDict())


def _capture_steps(shape: tuple, n: int, key: torch.Tensor,
                   use_ntt2: bool) -> _StepGraph:
    """Capture the n steps at accumulator shape [B, k+1, N] into a CUDA
    graph over buffers of its own.  The kernels are built and loaded first
    (a capture can do neither); no kernel runs during the capture, so the
    wrappers' launch counts are put back after it."""
    dev = key.device
    rd.prepare(dev)
    if use_ntt2:
        ne.prepare(dev, shape[-1])
    else:
        ep.prepare(dev)
    product = ne.ntt_ext if use_ntt2 else ep.ext_product
    acc = torch.zeros(shape, dtype=torch.int64, device=dev)
    steps = torch.zeros((n, shape[0]), dtype=torch.int32, device=dev)
    dl = torch.empty((br64.DIGIT_LIMBS, shape[0], shape[1] * shape[2]),
                     dtype=torch.int8, device=dev)
    ext = torch.empty_like(acc) if use_ntt2 else None
    graph = torch.cuda.CUDAGraph()
    counts = rd.rotate_diff_decompose.launches, product.launches
    try:
        with torch.cuda.graph(graph):
            _run_steps(acc, steps, key, use_ntt2, dl, ext)
    finally:
        rd.rotate_diff_decompose.launches, product.launches = counts
    return _StepGraph(graph, key, acc, steps, (dl, ext))


def _step_graph(shape: tuple, n: int, key: torch.Tensor,
                use_ntt2: bool) -> _StepGraph:
    """The cached graph of that accumulator shape, route and key tensor."""
    ident = (use_ntt2, tuple(shape), n, key.device, key.data_ptr())
    entry = _STEP_GRAPHS.get(ident)
    if entry is None:
        entry = _STEP_GRAPHS[ident] = _capture_steps(shape, n, key, use_ntt2)
        while len(_STEP_GRAPHS) > STEP_GRAPHS_KEPT:
            _STEP_GRAPHS.popitem(last=False)
    _STEP_GRAPHS.move_to_end(ident)
    return entry


def _replay_steps(entry: _StepGraph, use_ntt2: bool) -> None:
    """Replay the captured steps on the entry's buffers.  A replay runs no
    wrapper, so it counts its kernel nodes itself: n launches of K5 and n
    of the route's product kernel."""
    entry.graph.replay()
    n = entry.steps.shape[0]
    rd.rotate_diff_decompose.launches += n
    product = ne.ntt_ext if use_ntt2 else ep.ext_product
    product.launches += n


def _blind_rotate_stepwise(acc: torch.Tensor, amounts: torch.Tensor,
                           keys: DeviceServerKeys, use_ntt2: bool,
                           graph: bool = True) -> torch.Tensor:
    """The step-wise 64-bit route: per step K5, then K3 adding into the
    accumulator or K4 and acc += ext.  On a CUDA device the steps are
    replayed from a captured graph (graph=False: launched one by one, for
    comparison); a failed capture or replay raises.  On the CPU the steps
    run one by one."""
    key = keys.bsk_ntt64 if use_ntt2 else keys.bsk_limbs
    if key is None:
        raise ValueError("the step-wise route needs "
                         + ("bsk_ntt64: pack_server_keys(with_ntt2=True)"
                            if use_ntt2 else "bsk_limbs (a 64-bit set)"))
    steps = amounts.t().contiguous()                    # [n, B]
    if acc.device.type != "cuda" or not graph or acc.shape[0] == 0:
        return _run_steps(acc.clone(), steps, key, use_ntt2)
    entry = _step_graph(acc.shape, steps.shape[0], key, use_ntt2)
    entry.acc.copy_(acc)
    entry.steps.copy_(steps)
    _replay_steps(entry, use_ntt2)
    return entry.acc.clone()


def blind_rotate(acc: torch.Tensor, lwe_2n: torch.Tensor,
                 keys: DeviceServerKeys, rounded: bool = False,
                 approx: bool = False, use_pallas: bool = False,
                 use_ntt2: bool = False) -> torch.Tensor:
    """acc: int64 [B, k+1, N]; lwe_2n: int64 [B, n+1] in [0, 2N).  Rotates
    acc by -phase homomorphically: first by -b (the body, column n), then
    the n steps over the mask coefficients.

    rounded/approx select the 64-bit kernel's mode, with the JAX meaning
    (``numpy_ref.blind_rotate(rounded=rounded, min_shift=3 if approx else
    0)``); the 32-bit kernel runs the exact mode only.

    use_pallas / use_ntt2 (the JAX package's keyword names) take the 64-bit
    step-wise route (module docstring), exact mode only: use_pallas means
    the K3 route (``ext_product`` against ``keys.bsk_limbs``), use_ntt2 the
    K4 route (``ntt_ext`` against ``keys.bsk_ntt64``); use_ntt2 wins when
    both are set, as in the JAX package.  Neither: the whole-rotation
    kernel of the family."""
    p = keys.params
    _check_kernel_shape(p)
    two_n = 2 * p.polynomial_size
    acc = negacyclic_rotate(acc, (two_n - lwe_2n[:, -1]) & (two_n - 1))
    amounts = lwe_2n[:, :p.lwe_dimension].to(torch.int32).contiguous()
    if use_pallas or use_ntt2:
        if p.torus_bits != 64 or rounded or approx:
            raise ValueError("the step-wise route is the 64-bit family's "
                             "exact mode only")
        return _blind_rotate_stepwise(acc.contiguous(), amounts, keys,
                                      use_ntt2)
    if p.torus_bits == 64:
        return br64.blind_rotate64(acc.contiguous(), amounts, keys.bsk_ntt64,
                                   rounded=rounded, approx=approx)
    if rounded or approx:
        raise ValueError("the 32-bit blind rotation runs the exact mode only")
    hi = br.blind_rotate32(torus.hi32(acc).contiguous(), amounts,
                           keys.bsk_ntt32)
    return torus.from_hi32(hi)


# ---------------------------------------------------------------------------
# Full PBS
# ---------------------------------------------------------------------------

def pbs_batch(ct: torch.Tensor, lut_idx: torch.Tensor, lut_bank: torch.Tensor,
              keys: DeviceServerKeys, rounded: bool = False,
              approx: bool = False, use_pallas: bool = False,
              use_ntt2: bool = False) -> torch.Tensor:
    """Apply per-item LUTs to a batch of big-key LWE ciphertexts.

    ct: int64 [B, kN+1]; lut_idx: int64 [B] into lut_bank int64 [L, 2N].
    Returns int64 [B, kN+1] encrypting table[m] with fresh PBS noise.
    rounded/approx: the blind rotation's mode; use_pallas: the K3
    step-wise route; use_ntt2: the K4 step-wise route (``blind_rotate``).
    """
    p = keys.params
    _check_kernel_shape(p)
    N = p.polynomial_size
    B = ct.shape[0]
    lwe_2n = modswitch(keyswitch(ct, keys), p)

    # Body = test poly * X^-b; masks start at zero.  The test poly is
    # rotated here, so the blind rotation gets the mask amounts with b = 0.
    b = lwe_2n[:, -1]
    sel = lut_bank[lut_idx]                                     # [B, 2N]
    idx = (torch.arange(N, device=ct.device) + b[:, None]) & (2 * N - 1)
    body = torch.gather(sel, 1, idx)                            # [B, N]
    acc = torch.cat([body.new_zeros((B, p.glwe_dimension, N)),
                     body[:, None, :]], dim=1)
    lwe_nob = torch.cat([lwe_2n[:, :-1], lwe_2n.new_zeros((B, 1))], dim=1)
    return sample_extract(
        blind_rotate(acc, lwe_nob, keys, rounded=rounded, approx=approx,
                     use_pallas=use_pallas, use_ntt2=use_ntt2), p)
