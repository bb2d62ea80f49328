"""Multi-process execution on ``torch.distributed``: the PBS batch, the
evaluation keys or the polynomial axis sharded over a process group.

The port of the JAX package's ``parallel.py``, where each function is a
``shard_map`` over a device mesh.  Here every function is SPMD code that
each rank of a process group runs, as a ``shard_map`` body runs on each
device, with explicit collectives on that group:

- **batch sharding** (``pbs_batch_sharded``): each rank bootstraps its
  rows of the batch through ``crypto/pbs.pbs_batch`` (on the card: K2, or
  K1 at turbo) with the keys replicated, then an ``all_gather`` hands the
  whole batch to every rank.  No communication inside a PBS.  A server
  runs its engine this way under ``lane_sharded``: the counterpart of the
  JAX package's GSPMD run of the engine under a mesh.
- **key sharding** (``pbs_batch_keysharded``): a rank holds only its
  column shard of the bootstrap key (the GLWE output axis) and its row
  shard of the keyswitch key; one ``all_reduce`` in the keyswitch, one
  ``all_gather`` of the external product's columns per blind-rotation step
  (K5 on the whole accumulator, then K3 on the column shard).
- **polynomial sharding** (``ntt_fwd_poly_sharded``,
  ``ntt_inv_poly_sharded``, ``ext_group_poly_sharded``): the four-step
  negacyclic NTT of ``crypto/ntt_plan.py`` with its stages local and one
  ``all_to_all`` between them.

A mesh becomes the process group the caller passes in (``make_group``):
the JAX functions' axis names carry nothing a group needs, and a plain
group is what every collective takes, on either backend.  ``run_ranks``
spawns the ranks; a rank function is any importable function of this
package, called as ``fn(group, device, *args)``.

Backends (measured on one NVIDIA H100 80GB HBM3 at 700 W, torch
2.11.0+cu128, NCCL 2.28.9; tests/test_torch_gpu.py holds both facts):
NCCL refuses two ranks on one card (``ncclInvalidUsage`` at the
first collective), so two ranks share a card only over gloo; gloo takes
CUDA tensors in every collective used here (``all_gather_into_tensor``,
``all_to_all_single``, ``all_reduce``, ``broadcast``), so no tensor is
staged through the host by this module (gloo copies through the host
itself).  NCCL runs the same functions at one rank a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
import warnings

import torch
import torch.distributed as dist

from .crypto import ntt_plan
from .crypto import pbs
from .crypto.keys import DeviceServerKeys
from .crypto.kernels import blind_rotate64 as br64
from .crypto.kernels import ext_product as ep
from .crypto.kernels import rotate_decompose as rd
from .params import CryptoParams


# ---------------------------------------------------------------------------
# Groups, ranks and placement
# ---------------------------------------------------------------------------

def make_group(n_ranks: int | None = None):
    """The process group of the first ``n_ranks`` ranks (default: all):
    the counterpart of the JAX package's ``make_mesh``, ``make_key_mesh``
    and ``make_poly_mesh``.  Every rank of the world must call it (it is a
    collective); a rank outside the group gets
    ``dist.GroupMember.NON_GROUP_MEMBER``."""
    world = dist.get_world_size()
    n = n_ranks or world
    if n == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


def _rank_world(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def shard_string(group, blocks):
    """This rank's slice of the position axis (axis 0) of a block tensor
    or ``Blocks``: the counterpart of placing it with its first axis
    sharded over the mesh.  The axis must divide by the group's size."""
    rank, world = _rank_world(group)

    def cut(t):
        if t.shape[0] % world:
            raise ValueError(f"{t.shape[0]} positions over {world} ranks")
        per = t.shape[0] // world
        return t[rank * per:(rank + 1) * per]

    return _on_ct(blocks, cut)


def replicate(group, value):
    """The group's first rank's tensor (or ``Blocks``) on every rank, by a
    broadcast: every rank passes a tensor of the same shape and type."""
    src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD \
        else 0

    def bcast(t):
        t = t.contiguous().clone()
        dist.broadcast(t, src, group=group)
        return t

    return _on_ct(value, bcast)


def _on_ct(value, fn):
    """fn on a tensor, or on the ciphertext tensor of a ``Blocks``."""
    if torch.is_tensor(value):
        return fn(value)
    return dataclasses.replace(value, ct=fn(value.ct))


def all_gather(tensor: torch.Tensor, group) -> torch.Tensor:
    """Every rank's tensor stacked along a new axis 0, [world, ...]."""
    world = dist.get_world_size(group)
    tensor = tensor.contiguous()
    # gloo takes the output with the ranks' first axes concatenated
    out = tensor.new_empty((world * tensor.shape[0],) + tensor.shape[1:])
    with warnings.catch_warnings():  # renamed all_gather_single in torch 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, tensor, group=group)
    return out.view((world,) + tuple(tensor.shape))


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` on axis 0: send[i] goes to rank i, and out[i]
    came from rank i.  It splits the first axis only, so the callers move
    the axes the JAX code splits and concatenates (its last and second
    last) to the front and back."""
    send = send.contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return out


# ---------------------------------------------------------------------------
# Batch sharding
# ---------------------------------------------------------------------------

def pbs_batch_sharded(ct: torch.Tensor, lut_idx: torch.Tensor,
                      lut_bank: torch.Tensor, keys: DeviceServerKeys, group,
                      rounded: bool = False, approx: bool = False
                      ) -> torch.Tensor:
    """``pbs_batch`` with the batch axis sharded over the group: rank r
    bootstraps rows [r*b, (r+1)*b) (b = ceil(B / world)) with the keys and
    the LUT bank replicated, and an ``all_gather`` returns the whole batch
    int64 [B, kN+1] on every rank.  A batch the group's size does not
    divide is padded with zero rows, which are cut off again.  rounded and
    approx are ``pbs_batch``'s mode.  Bit-identical to one process's
    ``pbs_batch`` in the same mode: every row is bootstrapped alone."""
    rank, world = _rank_world(group)
    B = ct.shape[0]
    per = -(-B // world)
    if B == 0:
        return ct.clone()
    if per * world != B:
        ct = torch.cat([ct, ct.new_zeros((per * world - B, ct.shape[1]))])
        lut_idx = torch.cat([lut_idx, lut_idx.new_zeros(per * world - B)])
    rows = slice(rank * per, (rank + 1) * per)
    mine = pbs.pbs_batch(ct[rows], lut_idx[rows], lut_bank, keys,
                         rounded=rounded, approx=approx)
    return all_gather(mine, group).reshape(per * world, -1)[:B]


@contextlib.contextmanager
def lane_sharded(server, group):
    """Within the block, every bootstrap of ``server`` (a ``ServerKey``)
    runs ``pbs_batch_sharded`` over the group: the counterpart of running
    the JAX engine under ``with mesh:`` on a lane-sharded string.  Every
    rank runs the engine on the same (replicated) ciphertexts in lockstep:
    the engine never branches on ciphertext values, so every rank makes
    the same batches, and ``metrics`` counts each batch once on each
    rank, as an unsharded run does."""
    sc = server.backend.sc
    sc.group = group
    try:
        yield server
    finally:
        sc.group = None


# ---------------------------------------------------------------------------
# Key sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KeyShard:
    """What one rank of a key-sharded PBS holds: its row shard of the
    keyswitch key, ``ksk_limbs[rank*K/w : (rank+1)*K/w]``, and its column
    shard of the bootstrap key's limb planes, ``bsk_limbs[:, :, cols]``
    int8 [n, R, (k+1)/w, 8, 2N] (the GLWE output axis), each a tensor of
    its own."""

    params: CryptoParams
    ksk_limbs: torch.Tensor
    bsk_limbs: torch.Tensor

    def nbytes(self) -> dict:
        return {name: t.numel() * t.element_size()
                for name, t in (("ksk", self.ksk_limbs),
                                ("bsk", self.bsk_limbs))}


def shard_keys(keys: DeviceServerKeys, group) -> KeyShard:
    """This rank's ``KeyShard`` of a 64-bit set's packed keys, copied out
    of them (the caller may then drop ``keys``).  Needs (k+1) and K =
    kN*ks_level divisible by the group's size, as the JAX function."""
    p = keys.params
    rank, world = _rank_world(group)
    kp1 = p.glwe_dimension + 1
    K = p.big_lwe_dimension * p.ks_level
    if p.torus_bits != 64 or keys.bsk_limbs is None:
        raise ValueError("the key-sharded PBS takes a 64-bit set's keys "
                         "with bsk_limbs")
    if kp1 % world or K % world:
        raise ValueError(f"(k+1) = {kp1} and K = {K} must divide by the "
                         f"group's {world} ranks")
    rows, cols = K // world, kp1 // world
    return KeyShard(
        p, keys.ksk_limbs[rank * rows:(rank + 1) * rows].clone(),
        keys.bsk_limbs[:, :, rank * cols:(rank + 1) * cols].contiguous())


def pbs_batch_keysharded(ct: torch.Tensor, lut_idx: torch.Tensor,
                         lut_bank: torch.Tensor, shard: KeyShard,
                         group, times: dict | None = None) -> torch.Tensor:
    """``pbs_batch`` with the evaluation keys sharded over the group, in
    the exact mode (the JAX function's ``_ext_planes_einsum``); ct,
    lut_idx and lut_bank replicated, the result int64 [B, kN+1] on every
    rank.

    The keyswitch contracts this rank's K/w digit columns with its KSK
    rows into int32 planes and an ``all_reduce(SUM)`` adds them: exact, as
    no partial sum exceeds the unsharded product's bound.  Each of the n
    blind-rotation steps runs K5 (``rotate_diff_decompose``) on the whole
    accumulator, K3 (``ext_product``) on this rank's key columns, an
    ``all_gather`` of the columns (axis 1) and ``acc +=``.  Bit-identical
    to ``pbs_batch``'s exact mode, never to K2's served mode.

    times: a dict that the n steps add their seconds into, by part:
    "kernels" (K5 and K3), "all_gather" and "add", with the device
    synchronised after each part (which slows the steps; for measuring)."""
    p = shard.params
    rank, world = _rank_world(group)
    K = p.big_lwe_dimension * p.ks_level
    rows = K // world
    if shard.ksk_limbs.shape[0] != rows:
        raise ValueError("the shard was made for another group size")
    digits = pbs.keyswitch_digits(ct, p)[:, rank * rows:(rank + 1) * rows]
    planes = pbs._int8_matmul(digits.contiguous(), shard.ksk_limbs)
    dist.all_reduce(planes, group=group)
    lwe_2n = pbs.modswitch(pbs.keyswitch_finish(planes, ct, p), p)
    acc = pbs.initial_acc(lwe_2n, lut_idx, lut_bank, p).contiguous()
    steps = lwe_2n[:, :p.lwe_dimension].to(torch.int32).t().contiguous()
    B, kp1, N = acc.shape
    cols = shard.bsk_limbs.shape[2]
    dl = torch.empty((br64.DIGIT_LIMBS, B, kp1 * N), dtype=torch.int8,
                     device=acc.device)
    ext = torch.empty((B, cols, N), dtype=torch.int64, device=acc.device)
    lap = _PartClock(acc.device, times)
    for j in range(p.lwe_dimension):
        rd.rotate_diff_decompose(acc, steps[j], out=dl)
        ep.ext_product(dl, shard.bsk_limbs[j], out=ext)
        lap("kernels")
        full = all_gather(ext, group)  # [w, B, cols, N]
        lap("all_gather")
        acc += full.permute(1, 0, 2, 3).reshape(B, kp1, N)
        lap("add")
    return pbs.sample_extract(acc, p)


class _PartClock:
    """Called with a part's name, adds the seconds since its last call
    into ``times[name]``, the device synchronised first; does nothing
    when times is None."""

    def __init__(self, device: torch.device, times: dict | None):
        self.device, self.times = device, times
        self.t = self._now() if times is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, part: str) -> None:
        if self.times is not None:
            t = self._now()
            self.times[part] = self.times.get(part, 0.0) + t - self.t
            self.t = t


# ---------------------------------------------------------------------------
# Polynomial sharding: the four-step negacyclic NTT, stages local
# ---------------------------------------------------------------------------

def _center(v: torch.Tensor, p: int) -> torch.Tensor:
    """Exact centered residue mod p of int64 values, in [-(p-1)/2,
    (p-1)/2] (p odd): the bits of the JAX ``_modc`` with ``exact=True``."""
    v = torch.remainder(v, p)
    return torch.where(v > p // 2, v - p, v)


def _limbs(m) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered |m| <= 2^15 -> two balanced int8 limbs, m = l0 + 256 l1."""
    m = torch.as_tensor(m).to(torch.int64)
    l0 = ((m + 128) & 255) - 128
    return l0.to(torch.int8), ((m - l0) >> 8).to(torch.int8)


def _limb_product(x, w0: torch.Tensor, w1: torch.Tensor, p: int,
                  x_is_byte: bool = False) -> torch.Tensor:
    """Centered x [M, K] (int64, |x| <= 2^15; int8 digits if x_is_byte) @
    (w0 + 256 w1) [K, L] mod p, centered, exact: int8 limb products on
    ``torch._int_mm`` (int32 sums below 2^22) recombined in int64.
    ``torch.mm`` on int8 wraps, and CUDA has no int32 or int64 product."""
    if x_is_byte:
        z = (x.to(torch.int8),)
    else:
        z = _limbs(x)
    out = None
    for i, zi in enumerate(z):
        for k, wk in enumerate((w0, w1)):
            term = pbs._int8_matmul(zi.contiguous(), wk).to(torch.int64) \
                << (8 * (i + k))
            out = term if out is None else out + term
    return _center(out, p)


@dataclasses.dataclass
class _PolyConsts:
    """One rank's stage constants for (prime, N) as int8 limb pairs: the
    block-diagonal of its j1 blocks of a block stage (one int8 product for
    all its blocks), and the dense stage's whole matrix."""
    n1: int
    n2: int
    mf: tuple          # [j1_loc*n2(j2), j1_loc*n2(k2)] block-diagonal
    w1: tuple          # [n1(j1), n1(k1)]
    w1i: tuple         # [n1(k1), n1(j1)]
    mi: tuple          # [j1_loc*n2(k2), j1_loc*n2(j2)] block-diagonal


def _poly_consts(prime: int, n_poly: int, group, device, g: int = 0
                 ) -> _PolyConsts:
    rank, world = _rank_world(group)
    plan = ntt_plan.make_neg_plan(prime, n_poly)
    n1, n2 = plan.n1, plan.n2
    if n1 % world or n2 % world:
        raise ValueError(f"n1 = {n1} and n2 = {n2} must divide by the "
                         f"group's {world} ranks")
    loc = slice(rank * n1 // world, (rank + 1) * n1 // world)

    def block_diag(mats):
        return tuple(torch.block_diag(*limb.unbind(0)).to(device)
                     for limb in _limbs(mats[loc]))

    return _PolyConsts(
        n1, n2, block_diag(plan.mf),
        tuple(t.to(device) for t in _limbs(plan.w1[0])),
        tuple(t.to(device) for t in _limbs(plan.w1i.T)),
        block_diag(plan.mi[g]))


def _fwd_local(x_loc: torch.Tensor, c: _PolyConsts, p: int, group
               ) -> torch.Tensor:
    """Forward transform of this rank's j1 shard x_loc int [M, n2(j2),
    j1_loc] (centered digits, |x| <= 127) -> its k2 shard of the hats,
    int64 [M, k2_loc, n1(k1)]."""
    M, n2, j1_loc = x_loc.shape
    world = dist.get_world_size(group)
    # stage 1 (local): S[j1, k2] = sum_j2 x[j1, j2] Mf[j1][j2, k2]
    xs = x_loc.transpose(1, 2).reshape(M, j1_loc * n2)
    s = _limb_product(xs, *c.mf, p, x_is_byte=True).view(M, j1_loc, n2)
    # butterfly-stage all_to_all: the sharded axis from j1 to k2
    k2_loc = n2 // world
    send = s.view(M, j1_loc, world, k2_loc).permute(2, 0, 1, 3)
    recv = _all_to_all(send, group)                # [w(j1 blk), M, j1, k2]
    st = recv.permute(1, 3, 0, 2).reshape(M * k2_loc, world * j1_loc)
    # stage 2 (local): out[k2, k1] = sum_j1 S[j1, k2] W1[j1, k1]
    return _limb_product(st, *c.w1, p).view(M, k2_loc, c.n1)


def _inv_local(c_loc: torch.Tensor, c: _PolyConsts, p: int, group
               ) -> torch.Tensor:
    """Inverse transform of this rank's k2 shard of centered hats, int64
    [M, k2_loc, n1(k1)] (the forward's output layout) -> its j1 shard of
    the coefficients, int64 [M, j1_loc, n2(j2)]."""
    M, k2_loc, n1 = c_loc.shape
    world = dist.get_world_size(group)
    # stage A (local, dense): q[k2, j1] = sum_k1 c[k2, k1] W1i[k1, j1]
    q = _limb_product(c_loc.reshape(M * k2_loc, n1), *c.w1i, p)
    # butterfly-stage all_to_all: the sharded axis from k2 to j1
    j1_loc = n1 // world
    send = q.view(M, k2_loc, world, j1_loc).permute(2, 0, 1, 3)
    recv = _all_to_all(send, group)                # [w(k2 blk), M, k2, j1]
    qt = recv.permute(1, 3, 0, 2).reshape(M, j1_loc * world * k2_loc)
    # stage B (local, per j1 block): out[j1, j2] = sum_k2 qt[j1, k2]
    #                                             Mi[j1][k2, j2]
    return _limb_product(qt, *c.mi, p).view(M, j1_loc, c.n2)


def _j1_shard(x: torch.Tensor, c: _PolyConsts, group) -> torch.Tensor:
    """[..., N] (t = j1 + n1*j2) -> this rank's j1 shard [M, n2, j1_loc]."""
    rank, world = _rank_world(group)
    x2 = x.reshape(-1, c.n2, c.n1)
    j1_loc = c.n1 // world
    return x2[:, :, rank * j1_loc:(rank + 1) * j1_loc]


def _k2_shard(x: torch.Tensor, c: _PolyConsts, group) -> torch.Tensor:
    """[..., N] hats (h = k2*n1 + k1) -> this rank's k2 shard [M, k2_loc,
    n1]."""
    rank, world = _rank_world(group)
    k2_loc = c.n2 // world
    return x.reshape(-1, c.n2, c.n1)[:, rank * k2_loc:(rank + 1) * k2_loc]


def ntt_fwd_poly_sharded(x: torch.Tensor, n_poly: int, prime: int,
                         group) -> torch.Tensor:
    """One forward negacyclic NTT with the polynomial axis sharded over the
    group: stage 1 (the block contraction over j2, twist and twiddles
    folded) local on each rank's j1 shard, an ``all_to_all`` from j1 to
    k2, stage 2 (the dense contraction over j1) local on each rank's k2
    shard, then the k2 shards gathered.

    x: int [..., N] centered digits (|x| <= 127), the same on every rank;
    returns the centered hats int64 [..., N] (h = k2*n1 + k1) on every
    rank, the bits of ``ntt_plan.neg_fwd`` and of the JAX function."""
    c = _poly_consts(prime, n_poly, group, x.device)
    hats = _fwd_local(_j1_shard(x, c, group), c, prime, group)
    full = all_gather(hats, group)  # [w, M, k2_loc, n1]
    return full.permute(1, 0, 2, 3).reshape(x.shape)


def ntt_inv_poly_sharded(ahat: torch.Tensor, n_poly: int, prime: int,
                         group, g: int = 0) -> torch.Tensor:
    """The inverse, mirrored: stage A (dense over k1) local on each rank's
    k2 shard, an ``all_to_all`` from k2 to j1, stage B (the block
    contraction over k2, untwist, 1/N and 256^{-3g} folded) local on each
    rank's j1 shard, then the j1 shards gathered.

    ahat: centered hats int [..., N]; returns the centered coefficients
    int64 [..., N] on every rank, the bits of ``ntt_plan.neg_inv(ahat,
    plan, g)``."""
    c = _poly_consts(prime, n_poly, group, ahat.device, g)
    out = _inv_local(_k2_shard(ahat.to(torch.int64), c, group), c, prime,
                     group)
    full = all_gather(out, group)  # [w, M, j1_loc, n2]
    # [M, n1(j1), n2(j2)] -> natural order t = j1 + n1*j2
    full = full.permute(1, 0, 2, 3).reshape(-1, c.n1, c.n2)
    return full.transpose(1, 2).reshape(ahat.shape)


def ext_group_poly_sharded(digits: torch.Tensor, khat_prime: torch.Tensor,
                           n_poly: int, prime: int, group, g: int = 0
                           ) -> torch.Tensor:
    """One external-product plane group mod one prime with the polynomial
    axis sharded end to end: the forward transform of each decomposition
    row's digits (one ``all_to_all`` a row), the pointwise product with the
    key's hats and the sum over rows local on the k2 shards (the hats of
    every row live on the same frequency shard), one inverse transform
    (one ``all_to_all``), and the j1 shards gathered.

    digits: int [R, ..., N] centered gadget digits (|.| <= 127);
    khat_prime: centered int [R, ..., N] key hats mod ``prime`` for the same
    rows.  Returns centered int64 [..., N]: sigma_g * sum_i digits_i (x)
    key_i, the bits of neg_inv(center(sum_i center(neg_fwd(d_i) *
    khat_i)))."""
    c = _poly_consts(prime, n_poly, group, digits.device, g)
    acc = None
    for i in range(digits.shape[0]):
        hat = _fwd_local(_j1_shard(digits[i], c, group), c, prime, group)
        term = hat * _k2_shard(khat_prime[i].to(torch.int64), c, group)
        acc = term if acc is None else acc + term   # |.| < R p^2 / 4
    out = _inv_local(_center(acc, prime), c, prime, group)
    full = all_gather(out, group).permute(1, 0, 2, 3)
    full = full.reshape(-1, c.n1, c.n2).transpose(1, 2)
    return full.reshape(digits.shape[1:])


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------

class RankError(RuntimeError):
    """A rank raised, died or did not finish in time."""


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               device: str, timeout: float, fn, args, results) -> None:
    """A spawned rank: one thread, its card (rank mod the cards), the
    process group from the file store, fn(group, device, *args); puts
    (rank, ok, result or traceback) on the results queue."""
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
            device_id=dev if backend == "nccl" else None)
        try:
            out = fn(dist.group.WORLD, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(world: int, fn, *args, backend: str = "gloo",
              device=None, timeout: float = 60.0) -> list:
    """Run ``fn(group, device, *args)`` on ``world`` spawned processes, one
    rank each, joined by ``torch.distributed`` over a ``FileStore`` in a
    temporary directory (no port to pick, so parallel callers cannot
    collide).  fn must be importable (a child imports its module, never the
    caller's), its arguments and result picklable.  Each rank uses one CPU
    thread and, on "cuda", the card rank mod the card count.  device None
    means the card, and raises where there is none: the ranks run on the
    CPU only where the caller passes ``device="cpu"``.

    Returns every rank's result, by rank.  If a rank raises or exits, or
    the ranks are not all done within ``timeout`` seconds (start-up
    included; also each collective's timeout), every rank is killed and
    ``RankError`` carries the failing rank's traceback."""
    from .client import default_device

    device = str(default_device(device))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    done: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="fhe_ranks_") as tmp:
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(rank, world, os.path.join(tmp, "store"), backend, device,
                  timeout, fn, args, results)) for rank in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = sorted(set(range(world)) - set(done))
                    raise RankError(f"ranks {late} not done within "
                                    f"{timeout} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    for rank, proc in enumerate(procs):
                        if proc.exitcode not in (None, 0):
                            raise RankError(f"rank {rank} exited with code "
                                            f"{proc.exitcode}") from None
                    continue
                if not ok:
                    raise RankError(f"rank {rank} failed:\n{out}")
                done[rank] = out
            for proc in procs:
                proc.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=10)
            results.close()
    return [done[rank] for rank in range(world)]
