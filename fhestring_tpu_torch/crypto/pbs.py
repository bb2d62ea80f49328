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

Each family has a whole-rotation kernel (K1 at 32 bits, K2 at 64 bits:
one launch for all n steps), the route of a key packed with its NTT-domain
key.  A key packed without it (``pack_server_keys(with_ntt2=False)``) runs
the step-wise route over the limb planes, one prologue and one external
product per LWE step, as the JAX package's ``use_pallas`` route does:

    for j in range(n):
        dl  = rotate_diff_decompose(acc, a_j)            (K5)
        acc = acc + ext_product(dl, bsk_limbs[j])        (K3)

At 32 bits (gadget 2^8 x 3) the three levels' digits are made in torch ops
and K3 runs once per level, against that level's rows of ``bsk_limbs``
(the JAX package runs an XLA einsum there).  The same loop with ``ntt_ext``
(K4) against ``bsk_ntt64`` in place of K3 is the JAX package's ``use_ntt2``
route; no key is served by it, and it stays a direct call
(``_blind_rotate_stepwise``) for its tests and measurements.  The step-wise
routes are exact and give the bits of the whole-rotation kernel's exact
mode.  K3 and K4 add their product into the accumulator themselves.  On the
card the n steps are captured once per (product kernel, batch, key) into a
CUDA graph over static buffers and replayed for every later batch of that
shape: the host makes one graph launch instead of every launch of every
step.  On the CPU the loop is a plain Python loop over the plain versions.

``blind_rotate`` alone maps the packed key fields to a route, and
``served_mode`` alone maps them, the family and the device to the served
path's mode.
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


def keyswitch_digits(ct: torch.Tensor, p: CryptoParams) -> torch.Tensor:
    """The keyswitch's left operand: int8 [B, K] digits of the mask, K =
    kN*ks_level in the order of the key's rows (``keys.pack_ksk``: (i, lev)
    row-major)."""
    kn = p.big_lwe_dimension
    digits = decompose(ct[:, :kn], p.ks_base_log, p.ks_level)  # [lev, B, kN]
    return digits.permute(1, 2, 0).reshape(ct.shape[0], kn * p.ks_level).to(
        torch.int8)


def keyswitch(ct: torch.Tensor, keys: DeviceServerKeys) -> torch.Tensor:
    """ct: int64 [B, kN+1] -> int64 [B, n+1].

    Exact: ks digits |d| <= 4, key limbs |l| <= 128, K = kN*ks_level terms,
    so every int32 sum is below 4 * 128 * K (2^22.3 at turbo)."""
    planes = _int8_matmul(keyswitch_digits(ct, keys.params), keys.ksk_limbs)
    return keyswitch_finish(planes, ct, keys.params)


def keyswitch_finish(planes: torch.Tensor, ct: torch.Tensor,
                     p: CryptoParams) -> torch.Tensor:
    """The keyswitch's result from its int32 product planes [B, ks_cols]
    (``keyswitch_digits`` @ ``ksk_limbs``): the planes recombined mod 2^64,
    negated, plus the body of ct."""
    kn, n1 = p.big_lwe_dimension, p.lwe_dimension + 1
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


def _levels(acc_shape: tuple, key: torch.Tensor, product) -> int:
    """Gadget levels of a step-wise route: bsk_limbs holds (k+1) x levels
    rows (1 level at 64 bits; the 32-bit set's 3, whose route runs one K3
    per level); K4 runs against the 64-bit key, 1 level."""
    return 1 if product is ne.ntt_ext else key.shape[1] // acc_shape[1]


def _digit_buffer(shape: tuple, levels: int, device) -> torch.Tensor:
    """The steps' int8 digit limbs: [3, B, (k+1)N] (K5's output), or for
    the 32-bit route [levels, 3, B, (k+1)N], whose limbs 1 and 2 stay zero
    (a base-256 digit is one balanced int8 limb)."""
    B, kp1, N = shape
    if levels > 1:
        return torch.zeros((levels, br64.DIGIT_LIMBS, B, kp1 * N),
                           dtype=torch.int8, device=device)
    return torch.empty((br64.DIGIT_LIMBS, B, kp1 * N), dtype=torch.int8,
                       device=device)


def gadget_digits32(diff: torch.Tensor) -> torch.Tensor:
    """Balanced digits of the 32-bit gadget (2^8 x 3) of torus values,
    int64 [3, ...] in [-128, 128), level 0 most significant: what
    ``decompose(diff, 8, 3)`` gives, at once from the rounded top 24 bits.
    With 128 added at every byte, each byte is its balanced digit + 128,
    carries included (the top carry is dropped, as ``decompose`` drops
    it)."""
    width = br.BASE_LOG * br.LEVELS
    top = torus.round_shr(diff, 64 - width) + sum(
        128 << (br.BASE_LOG * i) for i in range(br.LEVELS))
    shifts = torch.arange(width - br.BASE_LOG, -1, -br.BASE_LOG,
                          device=diff.device)
    return ((top[None] >> shifts.view((-1,) + (1,) * diff.dim())) & 255) - 128


def _digits_levels(acc: torch.Tensor, a: torch.Tensor,
                   dl: torch.Tensor) -> None:
    """The 32-bit route's prologue in torch ops: rotate acc by X^a, take
    the difference and its gadget digits (the JAX package's
    ``_digit_limbs``) into limb 0 of dl [levels, 3, B, (k+1)N]; a digit is
    one int8 limb."""
    diff = negacyclic_rotate(acc, a.to(torch.int64)) - acc
    dl[:, 0].copy_(gadget_digits32(diff).view(dl.shape[0], dl.shape[2],
                                              dl.shape[3]))


def _run_steps(acc: torch.Tensor, steps: torch.Tensor, key: torch.Tensor,
               product, dl: torch.Tensor | None = None) -> torch.Tensor:
    """The n steps, eagerly, updating acc in place: K5 (or the 32-bit
    route's digits), then the product kernel adding into acc: ``product``
    is ``ep.ext_product`` (K3, key = bsk_limbs, once per gadget level) or
    ``ne.ntt_ext`` (K4, key = bsk_ntt64).  steps: int32 [n, B].  dl: the
    steps' digit buffer (allocated here if not given).  Nothing in the loop
    reads back to the host, and the kernels allocate nothing, so it can be
    captured."""
    levels = _levels(acc.shape, key, product)
    if dl is None:
        dl = _digit_buffer(acc.shape, levels, acc.device)
    if levels > 1:
        kp1 = acc.shape[1]
        for j in range(steps.shape[0]):
            _digits_levels(acc, steps[j], dl)
            for lev in range(levels):
                product(dl[lev], key[j, lev * kp1:(lev + 1) * kp1], out=acc,
                        accumulate=True)
        return acc
    for j in range(steps.shape[0]):
        rd.rotate_diff_decompose(acc, steps[j], out=dl)
        product(dl, key[j], out=acc, accumulate=True)
    return acc


@dataclasses.dataclass
class _StepGraph:
    """The captured steps of one (product kernel, batch, key) and their
    buffers."""
    graph: torch.cuda.CUDAGraph
    product: object            # the product kernel's wrapper (K3 or K4)
    key: torch.Tensor          # kept alive: the graph holds its address
    acc: torch.Tensor          # int64 [B, k+1, N], in and out
    steps: torch.Tensor        # int32 [n, B]
    # the steps' digit buffer: the graph writes it at every replay, so it
    # must not go back to the allocator while the graph lives
    dl: torch.Tensor
    k4_body: int | None        # the body of K4 the capture picked (K4 route)
    levels: int = 1            # K3 launches a step (3 on the 32-bit route)


STEP_GRAPHS_KEPT = 16  # least recently used graphs beyond this are dropped
_STEP_GRAPHS: collections.OrderedDict[tuple, _StepGraph] = (
    collections.OrderedDict())


def _capture_steps(shape: tuple, n: int, key: torch.Tensor,
                   product) -> _StepGraph:
    """Capture the n steps at accumulator shape [B, k+1, N] into a CUDA
    graph over buffers of its own.  The kernels are built and loaded first
    (a capture can do neither); no kernel runs during the capture, so the
    wrappers' launch counts are put back after it.  The 32-bit route's
    torch ops take their temporaries from the graph's own memory pool."""
    dev = key.device
    levels = _levels(shape, key, product)
    if levels == 1:
        rd.prepare(dev)
    k4_body = None
    if product is ne.ntt_ext:
        ne.prepare(dev, shape[-1])
        k4_body = ne.pick_cluster(shape[0], shape[-1], dev.index)
    else:
        ep.prepare(dev)
    acc = torch.zeros(shape, dtype=torch.int64, device=dev)
    steps = torch.zeros((n, shape[0]), dtype=torch.int32, device=dev)
    dl = _digit_buffer(shape, levels, dev)
    graph = torch.cuda.CUDAGraph()
    counts = rd.rotate_diff_decompose.launches, product.launches
    bodies = dict(ne.ntt_ext.bodies)
    try:
        with torch.cuda.graph(graph):
            _run_steps(acc, steps, key, product, dl)
    finally:
        rd.rotate_diff_decompose.launches, product.launches = counts
        ne.ntt_ext.bodies.update(bodies)
    return _StepGraph(graph, product, key, acc, steps, dl, k4_body, levels)


def _step_graph(shape: tuple, n: int, key: torch.Tensor,
                product) -> _StepGraph:
    """The cached graph of that accumulator shape, product kernel and key
    tensor."""
    ident = (product, tuple(shape), n, key.device, key.data_ptr())
    entry = _STEP_GRAPHS.get(ident)
    if entry is None:
        entry = _STEP_GRAPHS[ident] = _capture_steps(shape, n, key, product)
        while len(_STEP_GRAPHS) > STEP_GRAPHS_KEPT:
            _STEP_GRAPHS.popitem(last=False)
    _STEP_GRAPHS.move_to_end(ident)
    return entry


def _replay_steps(entry: _StepGraph) -> None:
    """Replay the captured steps on the entry's buffers.  A replay runs no
    wrapper, so it counts its kernel nodes itself: n launches of K5 (none
    on the 32-bit route, whose digits are torch ops) and n of the product
    kernel per gadget level (K4's also by body)."""
    entry.graph.replay()
    n = entry.steps.shape[0]
    if entry.levels == 1:
        rd.rotate_diff_decompose.launches += n
    entry.product.launches += n * entry.levels
    if entry.k4_body is not None:
        entry.product.bodies[entry.k4_body] += n


def _blind_rotate_stepwise(acc: torch.Tensor, amounts: torch.Tensor,
                           key: torch.Tensor, product) -> torch.Tensor:
    """A step-wise route: per step the digits (K5, or torch ops on the
    32-bit route), then ``product`` adding into the accumulator:
    ``ep.ext_product`` (K3, once per gadget level) against bsk_limbs, or
    ``ne.ntt_ext`` (K4) against bsk_ntt64.  On a CUDA device the steps are
    replayed from a captured graph (``_run_steps`` launches them one by
    one); a failed capture or replay raises.  On the CPU the steps run one
    by one on the plain versions."""
    steps = amounts.t().contiguous()                    # [n, B]
    if acc.device.type != "cuda" or acc.shape[0] == 0:
        return _run_steps(acc.clone(), steps, key, product)
    entry = _step_graph(acc.shape, steps.shape[0], key, product)
    entry.acc.copy_(acc)
    entry.steps.copy_(steps)
    _replay_steps(entry)
    return entry.acc.clone()


def served_mode(keys: DeviceServerKeys, device: torch.device
                ) -> tuple[bool, bool]:
    """(rounded, approx) of the served path's blind rotation on ``device``:
    rounded + approx for a 64-bit set on a CUDA device with its NTT-domain
    key (K2 in the JAX package's accelerator mode, calibrated on device in
    benchmarks/calibration_prod_r5.log), exact otherwise: K1 runs the exact
    mode only, the limb route is exact, and on the CPU the JAX package's
    path is exact.  So CPU outputs are bit-identical to the JAX package's
    CPU path whichever keys were packed."""
    fast = (torch.device(device).type == "cuda"
            and keys.params.torus_bits == 64 and keys.bsk_ntt64 is not None)
    return fast, fast


def blind_rotate(acc: torch.Tensor, lwe_2n: torch.Tensor,
                 keys: DeviceServerKeys, rounded: bool = False,
                 approx: bool = False) -> torch.Tensor:
    """acc: int64 [B, k+1, N]; lwe_2n: int64 [B, n+1] in [0, 2N).  Rotates
    acc by -phase homomorphically: first by -b (the body, column n), then
    the n steps over the mask coefficients.

    The route is the key's:

    - with the family's NTT-domain key (``keys.ntt_key``): the family's
      whole-rotation kernel, K1 or K2;
    - without it, with ``bsk_limbs``: the limb-plane route, K5 then K3 at
      64 bits; at 32 bits the digits in torch ops and one K3 per gadget
      level.  Exact only;
    - with neither: refused.

    rounded/approx select the 64-bit kernel's mode, with the JAX meaning
    (``numpy_ref.blind_rotate(rounded=rounded, min_shift=3 if approx else
    0)``); K1 and the limb route run the exact mode only.  Every route's
    exact mode gives the same bits."""
    p = keys.params
    _check_kernel_shape(p)
    two_n = 2 * p.polynomial_size
    acc = negacyclic_rotate(acc, (two_n - lwe_2n[:, -1]) & (two_n - 1))
    amounts = lwe_2n[:, :p.lwe_dimension].to(torch.int32).contiguous()
    khat = keys.ntt_key
    if khat is None:
        if keys.bsk_limbs is None:
            raise ValueError("the server key has neither its NTT-domain key "
                             "nor bsk_limbs; pack it with pack_server_keys")
        if rounded or approx:
            raise ValueError("the limb-plane route runs the exact mode only")
        return _blind_rotate_stepwise(acc.contiguous(), amounts,
                                      keys.bsk_limbs, ep.ext_product)
    if p.torus_bits == 64:
        return br64.blind_rotate64(acc.contiguous(), amounts, khat,
                                   rounded=rounded, approx=approx)
    if rounded or approx:
        raise ValueError("the 32-bit blind rotation runs the exact mode only")
    hi = br.blind_rotate32(torus.hi32(acc).contiguous(), amounts, khat)
    return torus.from_hi32(hi)


# ---------------------------------------------------------------------------
# Full PBS
# ---------------------------------------------------------------------------

def initial_acc(lwe_2n: torch.Tensor, lut_idx: torch.Tensor,
                lut_bank: torch.Tensor, p: CryptoParams) -> torch.Tensor:
    """The blind rotation's starting accumulator int64 [B, k+1, N]: masks
    zero, body = each item's test poly * X^-b (b = lwe_2n's last column),
    so the rotation then takes the mask amounts with b = 0."""
    N = p.polynomial_size
    B = lwe_2n.shape[0]
    b = lwe_2n[:, -1]
    sel = lut_bank[lut_idx]                                     # [B, 2N]
    idx = (torch.arange(N, device=lwe_2n.device) + b[:, None]) & (2 * N - 1)
    body = torch.gather(sel, 1, idx)                            # [B, N]
    return torch.cat([body.new_zeros((B, p.glwe_dimension, N)),
                      body[:, None, :]], dim=1)


def pbs_batch(ct: torch.Tensor, lut_idx: torch.Tensor, lut_bank: torch.Tensor,
              keys: DeviceServerKeys, rounded: bool = False,
              approx: bool = False) -> torch.Tensor:
    """Apply per-item LUTs to a batch of big-key LWE ciphertexts.

    ct: int64 [B, kN+1]; lut_idx: int64 [B] into lut_bank int64 [L, 2N].
    Returns int64 [B, kN+1] encrypting table[m] with fresh PBS noise.
    rounded/approx: the blind rotation's mode; the route is the key's
    (``blind_rotate``).
    """
    p = keys.params
    _check_kernel_shape(p)
    lwe_2n = modswitch(keyswitch(ct, keys), p)
    acc = initial_acc(lwe_2n, lut_idx, lut_bank, p)
    lwe_nob = torch.cat([lwe_2n[:, :-1], lwe_2n.new_zeros((ct.shape[0], 1))],
                        dim=1)
    return sample_extract(
        blind_rotate(acc, lwe_nob, keys, rounded=rounded, approx=approx), p)
