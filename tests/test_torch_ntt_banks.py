"""The shared-memory banks that the CUDA transforms (``csrc/ntt64.cuh``)
touch, modelled word by word, and their arithmetic run through the same
addresses in numpy.

The model mirrors, in ``ntt64.cuh``:

- ``swizzle``: its expression is read from the header and evaluated here,
  so the model and the kernels use the same layout;
- ``splits``, ``ntt_fwd`` and ``ntt_inv``: which passes run at each n, each
  with its stage count kS and unit distance 2^log_u (``passes`` below);
- ``fwd_pass`` / ``inv_pass`` with ``first_coeff``, ``swizzle_shift``,
  ``load_coeffs`` and ``store_coeffs``: thread idx (idx = threadIdx.x, +
  blockDim.x each turn) takes poly idx >> log_items and work item w = idx
  mod 2^log_items, first coefficient t0 = ((w >> log_u) << (log_u + kS)) +
  (w mod 2^log_u), stored at word t = t0 + shift of the poly, where shift =
  swizzle(t0') - t0' at the thread's own first item t0'; coefficient q lies
  at word t ^ swizzle(q << log_u) (``kUnitOffsets``); the pass on
  neighbouring coefficients moves two 16-byte words, at t and at t ^ 4;
- the elementwise readers and writers (``load_digits``, ``load_limbs``,
  ``pointwise``, ``digit_products``, ``crt_sum``, ``plane_sum``, the
  cluster bodies' CRT): thread after thread on coefficients t = idx mod n,
  each at word t + swizzle_shift(threadIdx.x mod n).

A bank is a word address mod 32.  A warp's 32-bit access is conflict-free
when its threads touch 32 distinct banks (or one word); a 16-byte access is
served in phases of 8 threads, each conflict-free when its threads' words
cover all 32 banks.  Tolerance: none, integers.
"""

import os
import re

import numpy as np
import pytest
import torch

from fhestring_tpu_torch.crypto import ntt
from fhestring_tpu_torch.crypto.kernels import cuda_build

SIZES = [64, 128, 256, 512, 1024, 2048]
THREADS = [512, 1024]
# Polys a transform runs on in some body: the 3 or 6 digit polys, the 4, 5,
# 8, 10 or 16 product polys of K1, K2 approx and K2 exact (a block of 4 holds
# one output row's, a block of 8 half of them: 2, 3 or 4).
NPOLYS = [2, 3, 4, 5, 6, 8, 10, 16]


def _read_swizzle():
    """ntt64.cuh's swizzle as a Python function: its body is integer
    arithmetic that reads the same in both languages."""
    with open(os.path.join(cuda_build.CSRC, "ntt64.cuh")) as f:
        src = f.read()
    found = re.search(r"int swizzle\(int t\) \{\n(.*?)\n\}", src, re.S)
    assert found, "ntt64.cuh: swizzle not found"
    body = found.group(1).replace("const int ", "").replace(";", "")
    scope = {}
    exec("def swizzle(t):\n" + body, scope)  # noqa: S102
    return scope["swizzle"]


SWIZZLE = _read_swizzle()


def natural(t):
    return t


def splits(log_n):
    """(threes, twos, ones) as ntt64.cuh's splits()."""
    stages = log_n - 3
    most = min(log_n - 5, 3)
    threes = stages // 3 if most == 3 else 0
    twos = (stages - 3 * threes) // 2 if most >= 2 else 0
    return threes, twos, stages - 3 * threes - 2 * twos


def passes(log_n, forward):
    """The passes of one transform, in order: (kS, log_u, first stage,
    contiguous)."""
    threes, twos, ones = splits(log_n)
    out, s = [], 0
    for k_s in [3] * threes + [2] * twos + [1] * ones:
        out.append((k_s, log_n - s - k_s, s, False))
        s += k_s
    out.append((3, 0, s, True))
    return out if forward else out[::-1]


def first_coeff(w, log_u, k_s):
    return ((w >> log_u) << (log_u + k_s)) + (w & ((1 << log_u) - 1))


def shift(t0, swizzle):
    """swizzle_shift: what a thread adds to every coefficient it meets."""
    return np.array([swizzle(int(v)) - int(v) for v in np.ravel(t0)]
                    ).reshape(np.shape(t0))


def pass_words(log_n, k_s, log_u, contig, npoly, swizzle, threads=None):
    """Word addresses [total items, 2^kS] of every coefficient a pass
    touches, item by item (= thread idx), as load_coeffs reads them: with
    `threads`, through each thread's swizzle_shift, as the kernels find
    them; without, by swizzle of each item's first coefficient."""
    e = 1 << k_s
    log_items = log_n - k_s
    idx = np.arange(npoly << log_items)
    w = idx & ((1 << log_items) - 1)
    t0 = first_coeff(w, log_u, k_s)
    if threads is None:
        t = t0 + shift(t0, swizzle)
    else:
        mine = first_coeff(idx % threads & ((1 << log_items) - 1), log_u, k_s)
        t = t0 + shift(mine, swizzle)
    base = (idx >> log_items) << log_n
    if contig:
        lo = base + t
        hi = base + (t ^ 4)
        return np.concatenate([lo[:, None] + np.arange(4),
                               hi[:, None] + np.arange(4)], axis=1)
    off = np.array([swizzle(q << log_u) for q in range(e)])
    return base[:, None] + (t[:, None] ^ off[None, :])


def warps(total, threads):
    """Thread idx of each warp instruction of the idx loop."""
    for turn in range(-(-total // threads)):
        for warp in range(threads // 32):
            first = turn * threads + 32 * warp
            lanes = np.arange(first, min(first + 32, total))
            if len(lanes):
                yield lanes


def conflicts(words, contig, threads):
    """The worst bank conflict (1: none) of any warp-wide access of a pass
    with these word addresses."""
    worst = 1
    for lanes in warps(len(words), threads):
        if contig:  # two 16-byte accesses, in phases of 8 threads
            for half in (0, 4):
                for p in range(0, len(lanes), 8):
                    quads = words[lanes[p:p + 8], half]
                    assert np.all(quads % 4 == 0)
                    groups = (quads >> 2) & 7
                    worst = max(worst, np.bincount(groups).max())
        else:
            for q in range(words.shape[1]):
                banks = words[lanes, q] % 32
                worst = max(worst, np.bincount(banks).max())
    return worst


@pytest.mark.parametrize("n", SIZES)
def test_swizzle_is_a_linear_permutation_inside_each_row(n):
    t = np.arange(n)
    s = np.array([SWIZZLE(int(v)) for v in t])
    assert np.array_equal(s >> 5, t >> 5)  # no word leaves its row
    for row in range(n // 32):
        assert sorted(s[32 * row:32 * row + 32]) == list(
            range(32 * row, 32 * row + 32))
    assert np.array_equal(s & 3, t & 3)  # 16-byte words stay whole, in order
    assert np.array_equal(s[s], t)  # its own inverse
    for a in (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024):
        for b in range(0, n, 7):
            if a < n:
                assert SWIZZLE(a ^ b) == SWIZZLE(a) ^ SWIZZLE(b)


@pytest.mark.parametrize("n", SIZES)
def test_passes_cover_each_stage_once_with_warps_inside_a_poly(n):
    log_n = n.bit_length() - 1
    fwd = passes(log_n, True)
    stages = [s for k_s, _, s0, _ in fwd for s in range(s0, s0 + k_s)]
    assert stages == list(range(log_n))
    for k_s, log_u, s0, contig in fwd:
        assert log_u == (0 if contig else log_n - s0 - k_s)
        if not contig:
            assert n >> k_s >= 32  # work items a poly: a warp's 32 fit
    inv = passes(log_n, False)
    assert [p[:2] for p in inv] == [p[:2] for p in reversed(fwd)]
    if n == 2048:  # 3 stages, 3, 2, then the neighbours: unchanged
        assert [(k, u) for k, u, _, _ in fwd] == [(3, 8), (3, 5), (2, 3),
                                                  (3, 0)]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", SIZES)
def test_every_pass_is_free_of_bank_conflicts(n, forward, threads):
    log_n = n.bit_length() - 1
    for npoly in NPOLYS:
        for k_s, log_u, _, contig in passes(log_n, forward):
            words = pass_words(log_n, k_s, log_u, contig, npoly, SWIZZLE,
                               threads)
            assert sorted(words.ravel()) == list(range(npoly * n))
            assert conflicts(words, contig, threads) == 1, (
                n, npoly, k_s, log_u)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n", SIZES)
def test_a_threads_shift_is_the_swizzle_of_every_coefficient_it_meets(
        n, threads):
    """With 512 or 1024 threads (a multiple of 256), swizzle_shift at a
    thread's first coefficient gives the swizzle of every later one, in the
    passes and in the elementwise loops."""
    log_n = n.bit_length() - 1
    for k_s, log_u, _, contig in passes(log_n, True):
        assert np.array_equal(
            pass_words(log_n, k_s, log_u, contig, 16, SWIZZLE, threads),
            pass_words(log_n, k_s, log_u, contig, 16, SWIZZLE))
    for rows in (1, 2, 3 * 2):
        idx = np.arange(rows * n)
        t = idx & (n - 1)
        mine = shift(idx % threads & (n - 1), SWIZZLE)
        assert np.array_equal(t + mine, t + shift(t, SWIZZLE))


@pytest.mark.parametrize("n", SIZES)
def test_elementwise_readers_are_free_of_bank_conflicts(n):
    log_n = n.bit_length() - 1
    for npoly in (1, 6, 16):
        idx = np.arange(npoly * n)
        t = idx & (n - 1)
        words = ((idx >> log_n) << log_n) + t + shift(idx % 1024 & (n - 1),
                                                      SWIZZLE)
        for lanes in warps(len(words), 1024):
            assert len(set(words[lanes] % 32)) == len(lanes)


@pytest.mark.parametrize("threads", THREADS)
def test_the_model_finds_the_conflicts_of_the_natural_layout(threads):
    """Without the swizzle, N = 2048's pass of distances 16 and 8 reads 4
    rows' same 8 banks, and the neighbour pass's threads t and t + 4 share
    4 banks; the passes of 3 stages are conflict-free.  A pass of 3 stages
    at n = 64 (8 items a poly: 4 polys a warp) stays 4-way under any layout
    of a poly, which is why splits() gives n = 64 passes of 1."""
    got = {(k, u): conflicts(pass_words(11, k, u, c, 6, natural), c, threads)
           for k, u, _, c in passes(11, True)}
    assert got == {(3, 8): 1, (3, 5): 1, (2, 3): 4, (3, 0): 2}
    assert conflicts(pass_words(6, 3, 3, False, 6, SWIZZLE), False,
                     threads) == 4


def _mul_shoup(y, w, wq, p):
    u32 = np.uint64(0xFFFFFFFF)
    return (y * w - ((y * wq) >> np.uint64(32)) * np.uint64(p)) & u32


def _run(buf, log_n, p, table, forward):
    """One transform of the polys in buf (swizzled, uint64 words), pass by
    pass as fwd_pass / inv_pass compute it: lazy butterflies, the last pass
    reduced."""
    npoly = buf.size >> log_n
    pp = np.uint64(p)
    for k_s, log_u, s0, contig in passes(log_n, forward):
        e = 1 << k_s
        words = pass_words(log_n, k_s, log_u, contig, npoly, SWIZZLE, 512)
        w = np.arange(len(words)) & ((1 << (log_n - k_s)) - 1)
        i = w >> log_u
        v = buf[words]
        for st in range(k_s):
            if forward:
                half = e >> (st + 1)
                for g in range(1 << st):
                    tw = table[(1 << (s0 + st)) + (i << st) + g]
                    for k in range(half):
                        q = g * 2 * half + k
                        u = v[:, q].copy()
                        m = _mul_shoup(v[:, q + half], tw[:, 0], tw[:, 1], p)
                        v[:, q] = u + m
                        v[:, q + half] = u - m + 2 * pp
            else:
                half = 1 << st
                h = 1 << (log_n - log_u - st - 1)
                bound = np.uint64(p << (log_u + st))
                for g in range(e >> (st + 1)):
                    tw = table[h + (i << (k_s - st - 1)) + g]
                    for k in range(half):
                        q = g * 2 * half + k
                        u, x = v[:, q].copy(), v[:, q + half].copy()
                        assert np.all(x < bound)
                        v[:, q] = u + x
                        v[:, q + half] = _mul_shoup(u - x + bound, tw[:, 0],
                                                    tw[:, 1], p)
        assert int(v.max()) < 1 << 32
        if (contig and forward) or (not forward and log_u + k_s == log_n):
            v %= pp
        buf[words] = v
    return buf


@pytest.mark.parametrize("n", SIZES)
def test_swizzled_passes_compute_the_plain_transforms(n):
    """The passes on a swizzled buffer of 3 polys (random, all p - 1 and a
    ramp) give, read back through the swizzle, ntt.ntt_fwd and ntt.ntt_inv
    of the polys."""
    log_n = n.bit_length() - 1
    rng = np.random.default_rng(n)
    tw = torch.from_numpy(ntt.twiddles(n))
    table = ntt.kernel_twiddles(n, "cpu").numpy().view(np.uint32).astype(
        np.uint64)
    where = np.array([SWIZZLE(t) for t in range(n)])
    for pi, p in enumerate(ntt.PRIMES):
        polys = np.stack([rng.integers(0, p, n), np.full(n, p - 1),
                          np.arange(n) % p]).astype(np.uint64)
        x = torch.from_numpy(np.stack([polys, polys]).astype(np.int64))
        for forward, plain in ((True, ntt.ntt_fwd), (False, ntt.ntt_inv)):
            buf = np.zeros(3 * n, np.uint64)
            buf.reshape(3, n)[:, where] = polys
            _run(buf, log_n, p, table[pi, 0 if forward else 1], forward)
            got = buf.reshape(3, n)[:, where]
            want = plain(x, tw)[pi].numpy().astype(np.uint64)
            assert np.array_equal(got, want), (p, forward)
