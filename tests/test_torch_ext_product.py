"""The port's step-wise external product by convolution (K3,
``kernels/ext_product.py``) and its limb key against the JAX package.

``ext_product_plain`` (what the wrapper runs on CPU tensors, and what the
CUDA kernel is held to on the card) is compared with the JAX package's
Pallas kernel ``ext_product_u64`` run in interpret mode, as
tests/test_ext_product_kernel.py runs it, at N=128 and 256 and B=8.  Both
get the same numpy digit limbs and u64 key polys: the port in natural order
with the key's reversed limb planes, the JAX kernel with the digits reversed
per row (drev) and the limbs of the doubled key quadrupled to 4N (p4).  The
port's ``bsk_limbs``, un-reversed, is held to the JAX
``pack_server_keys(srv).bsk_limbs``.

``kernel_model`` is the CUDA kernel's arithmetic in numpy: the reversed
doubled limb planes read as a Toeplitz operand, one int32 plane per shift
s = la + lb summed over the digit rows and the (la, lb) pairs, the u64
recombination, and the partial sums of blocks that split the digit index
added in any order.  It is held equal to the plain version and to the JAX
kernel, and its int32 planes are shown to stay in range at the worst case.

Tolerance: zero.  All compute the product exactly mod 2^64.
"""

import numpy as np
import pytest
import torch

from fhestring_tpu.crypto import keys as jkeys
from fhestring_tpu.crypto.kernels.ext_product import ext_product_u64
from fhestring_tpu.numpy_ref import core as ref
from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE, torus
from fhestring_tpu_torch.crypto import keys
from fhestring_tpu_torch.crypto.kernels import ext_product as ep

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

B, R, KP1, LIMBS = 8, 2, 2, 3
SIZES = (128, 256)
EDGE = np.array([0, 1, 127, 128, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
                 (1 << 64) - 128, 0x8080808080808080], np.uint64)


def _make(N):
    """Digit limbs int8 [3, B, R*N] (natural order) and u64 key polys
    [R, KP1, N] with edge values."""
    rng = np.random.default_rng(N)
    dl = rng.integers(-128, 128, size=(LIMBS, B, R * N)).astype(np.int8)
    key = rng.integers(0, 1 << 64, size=(R, KP1, N), dtype=np.uint64)
    key[0, 0, :len(EDGE)] = EDGE
    key[1, 1, -len(EDGE):] = EDGE
    return dl, key


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"N{n}")
def inputs(request):
    return _make(request.param)


def _planes(key):
    return keys.pack_bsk_limbs(key[None], "cpu")[0]


def _port(dl, key):
    return torus.to_numpy(ep.ext_product_plain(torch.from_numpy(dl),
                                               _planes(key)))


def _jax(dl, key):
    N = key.shape[-1]
    drev = np.flip(dl.reshape(LIMBS, -1, R, N), axis=-1).reshape(dl.shape)
    p2 = np.moveaxis(jkeys.balanced_limbs_u64(jkeys.negacyclic_double(key)),
                     -1, -2)                             # [R, KP1, 8, 2N]
    p4 = np.concatenate([p2, p2], axis=-1)
    lo, hi = ext_product_u64(np.ascontiguousarray(drev), p4, n_poly=N,
                             b_tile=8, interpret=True)
    return np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))


def kernel_model(dl, planes, chunk, split, rng=None):
    """The CUDA kernel's arithmetic.  dl int8 [3, B, R*N]; planes int8
    [R, cols, 8, 2N] (``keys.pack_bsk_limbs``, cols = KP1, or a column
    shard of it).  The 2N / chunk chunks of
    digit indices (over both rows) are shared by `split` blocks; a block
    sums its chunks on 8 int32 planes, recombines them to u64 and adds
    that to the output, the blocks in the order rng shuffles them into.
    Returns (u64 [B, cols, N], the largest |int32 plane entry| seen)."""
    N, cols = planes.shape[-1] // 2, planes.shape[1]
    d = dl.astype(np.int64).reshape(LIMBS, -1, R, N)
    q = planes.astype(np.int64)
    t, c = np.arange(N)[:, None], np.arange(N)[None, :]
    toeplitz = (c - t) % (2 * N)          # A[t, c] = plane[(c - t) mod 2N]
    chunks = [(r, lo) for r in range(R) for lo in range(0, N, chunk)]
    per_block = len(chunks) // split
    parts, worst = [], 0
    for z in range(split):
        acc = np.zeros((8, d.shape[1], cols, N), np.int64)
        for r, lo in chunks[z * per_block:(z + 1) * per_block]:
            for col in range(cols):
                for lb in range(8):
                    a = q[r, col, lb][toeplitz[:, lo:lo + chunk]]   # [t, c]
                    for la in range(min(LIMBS, 8 - lb)):
                        acc[la + lb, :, col] += d[la, :, r, lo:lo + chunk] @ a.T
        worst = max(worst, int(np.abs(acc).max()))
        part = np.zeros(acc.shape[1:], np.uint64)
        for s in range(8):
            # sign_extend64(int32 plane) << 8s in uint64
            part += acc[s].astype(np.int32).astype(np.int64).astype(
                np.uint64) << np.uint64(8 * s)
        parts.append(part)
    out = np.zeros_like(parts[0])
    order = rng.permutation(split) if rng is not None else range(split)
    for z in order:
        out += parts[z]
    return out, worst


@pytest.mark.parametrize("N", [256, 512])
def test_plain_matches_interpreted_jax_kernel(N):
    """The JAX kernel takes N >= 256."""
    dl, key = _make(N)
    np.testing.assert_array_equal(_port(dl, key), _jax(dl, key))


@pytest.mark.parametrize("chunk,split", [(128, 1), (128, 2), (64, 4),
                                         (32, 8)])
def test_kernel_model_matches_plain_and_jax(inputs, chunk, split):
    """Chunked, split over blocks whose partial sums are added in a
    shuffled order: the same bits as the plain version and the JAX
    kernel."""
    dl, key = inputs
    got, worst = kernel_model(dl, _planes(key).numpy(), chunk, split,
                              np.random.default_rng(split))
    np.testing.assert_array_equal(got, _port(dl, key))
    if key.shape[-1] >= 256:                 # the JAX kernel's least size
        np.testing.assert_array_equal(got, _jax(dl, key))
    assert worst < 1 << 31


@pytest.mark.parametrize("N", SIZES + (2048,))
@pytest.mark.parametrize("case", ["digits -2^22", "limbs -128"])
def test_int32_planes_hold_the_worst_case(N, case):
    """Key limbs all -128 against digits all -2^22 (limbs 0, 0, -64) and
    against digit limbs all -128 (the bound's own worst case): every int32
    plane of one block that sums everything stays within 3 pairs x 2 rows
    x N x 128^2 < 2^31, also at N = 2048 (there from the bound alone), and
    the model still equals the plain version."""
    bound = 3 * R * N * 128 * 128
    assert bound < 1 << 31
    if N == 2048:       # 2^27.6; the model at this size is held on the card
        assert bound == 201326592
        return
    limb = np.array([0, 0, -64] if case == "digits -2^22" else [-128] * 3,
                    np.int8)
    assert int(limb.astype(np.int64) @ [1, 256, 65536]) == (
        -(1 << 22) if case == "digits -2^22" else -8421504)
    dl = np.broadcast_to(limb[:, None, None], (LIMBS, 2, R * N)).copy()
    all_min = (-128 * sum(256**i for i in range(8))) % (1 << 64)
    key = np.full((R, KP1, N), all_min, np.uint64)
    planes = _planes(key).numpy()
    assert (keys.doubled_limbs(torch.from_numpy(planes))[..., :N].numpy()
            == -128).all()
    got, worst = kernel_model(dl, planes, N, 1)
    assert worst <= bound
    if case == "limbs -128":
        # the plane of s = 2..7 on the K half: 3 pairs x 2 rows of
        # (-128)(-128), over the c <= t that read K and not -K
        assert worst >= 3 * R * 128 * 128 * (N // 2)
    np.testing.assert_array_equal(got, _port(dl, key))


@pytest.mark.parametrize("cols", [(0, 1), (1, 2)], ids=["col0", "col1"])
@pytest.mark.parametrize("chunk,split", [(128, 1), (64, 4)])
def test_column_shard_equals_those_columns(inputs, cols, chunk, split):
    """A key of one output column (the key-sharded blind rotation's shard
    ``bsk_limbs[:, :, cols]``): the plain version and the kernel's model
    give those columns of the full product, bit for bit."""
    dl, key = inputs
    full = _port(dl, key)
    shard = _planes(key)[:, cols[0]:cols[1]].contiguous()
    got = ep.ext_product_plain(torch.from_numpy(dl), shard)
    assert tuple(got.shape) == (B, 1, key.shape[-1])
    np.testing.assert_array_equal(torus.to_numpy(got),
                                  full[:, cols[0]:cols[1]])
    model, _ = kernel_model(dl, shard.numpy(), chunk, split,
                            np.random.default_rng(split))
    np.testing.assert_array_equal(model, full[:, cols[0]:cols[1]])


def test_column_shard_counts_in_the_picked_grid():
    """``pick_body`` counts the key's columns in the grid: at B=17 a
    one-column shard has too few blocks for chunks of 1024 (fewer than 2
    a SM) and stages 512 at a time, where the whole key does not."""
    assert ep.pick_body(17, 2048, 132) == (1, 1024, 4)
    assert ep.pick_body(17, 2048, 132, 1) == (1, 512, 8)
    for b in (1, 8, 17, 2048):
        ep._check_body(ep.pick_body(b, 2048, 132, 1), 2048)


def test_plain_matches_the_u64_convolution(inputs):
    """Against the definition: sum_r d_r (x) K_r, negacyclic mod 2^64, with
    d = sum_la 256^la dl_la (numpy uint64, two items)."""
    dl, key = inputs
    N = key.shape[-1]
    got = _port(dl, key)
    d = dl.astype(np.int64).reshape(LIMBS, B, R, N)
    digits = (d[0] + 256 * d[1] + 65536 * d[2]).astype(np.uint64)
    for b in (0, B - 1):
        want = np.zeros((KP1, N), np.uint64)
        for r in range(R):
            for col in range(KP1):
                want[col] += ref.polymul(digits[b, r], key[r, col])
        np.testing.assert_array_equal(got[b], want)


def test_bsk_limbs_match_jax_pack_server_keys():
    """The port's planes are the JAX package's doubled limbs (K, -K), each
    plane reversed: un-reversed they are its ``bsk_limbs`` bit for bit."""
    p = PARAM_TEST_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(7))
    got = keys.pack_server_keys(srv, "cpu", params=p).bsk_limbs
    want = np.asarray(jkeys.pack_server_keys(srv).bsk_limbs)
    assert got.dtype == torch.int8
    assert tuple(got.shape) == (p.lwe_dimension, R, KP1, 8,
                                2 * p.polynomial_size) == want.shape
    np.testing.assert_array_equal(keys.doubled_limbs(got).numpy(), want)
    two_n = 2 * p.polynomial_size
    for i in (0, 1, p.polynomial_size, two_n - 1):
        np.testing.assert_array_equal(got[..., i].numpy(),
                                      want[..., -i % two_n])


def test_negated_half_holds_the_limbs_of_the_negated_value():
    """-(-128) is no int8: the -K half is the limbs of -K mod 2^64."""
    key = np.zeros((R, KP1, 128), np.uint64)
    key[0, 0, 0] = 0x80                      # limbs (-128, 1, 0, ...)
    doubled = keys.doubled_limbs(_planes(key))[0, 0]       # [8, 2N]
    assert doubled[:, 0].tolist() == [-128, 1, 0, 0, 0, 0, 0, 0]
    assert doubled[:, 128].tolist() == [-128, 0, 0, 0, 0, 0, 0, 0]   # -0x80


def test_items_per_block_spreads_small_batches():
    """``pick_body``: grid N/128 x 2 ceil(B / 8 groups) x split.  Small
    batches take one group of 8 items a block and split the digit index
    over as many blocks as there are chunks; two groups only where that
    pads the batch no further, or at large batches; large batches do not
    split; every pick is a body the kernel takes."""
    batches = (1, 5, 8, 15, 16, 17, 31, 33, 48, 66, 99, 132, 256, 2048)
    picks = {b: ep.pick_body(b, 2048, 132) for b in batches}
    for b, (groups, chunk, split) in picks.items():
        ep._check_body((groups, chunk, split), 2048)
        blocks = 16 * 2 * -(-b // (8 * groups)) * split
        assert blocks >= 8 * 132 or split == 2 * 2048 // chunk
        assert split == 1 or blocks < 2 * 8 * 132
        padded = -(-b // (8 * groups)) * 8 * groups
        assert padded == -(-b // 8) * 8 or b >= 128
    assert [picks[b][0] for b in (1, 8, 15, 16, 17, 33, 48, 66)] == [
        1, 1, 2, 2, 1, 1, 2, 1]
    assert picks[8] == (1, 512, 8) and picks[2048] == (2, 1024, 1)
    ep._check_body(ep.pick_body(16, 128, 132), 128)
    ep._check_body(ep.pick_body(4096, 256, 132), 256)
    assert ep.pick_body(8, 2048, 16)[2] < picks[8][2]    # a smaller card


@pytest.mark.parametrize("groups", ep.GROUPS)
def test_shared_memory_of_every_groups_fits_at_some_chunk(groups):
    """The wrapper's formula for a block's shared memory (the kernel's
    smem_bytes): 8 planes x 4 copies x (chunk + 160) bytes and 24 groups
    rows of chunk + 16 bytes."""
    assert ep.shared_memory(groups, 512) == (32 * (512 + 160)
                                             + 24 * groups * (512 + 16))
    assert ep.shared_memory(groups, 2048) <= ep.SHARED_MEMORY
    assert ep.shared_memory(4, 2048) > ep.SHARED_MEMORY


def test_cpu_wrapper_runs_plain_and_counts_no_launch(inputs):
    dl, key = inputs
    before = ep.ext_product.launches
    out = ep.ext_product(torch.from_numpy(dl), _planes(key))
    assert ep.ext_product.launches == before == 0
    np.testing.assert_array_equal(torus.to_numpy(out), _port(dl, key))


@pytest.mark.parametrize("accumulate", [False, True])
def test_out_and_accumulate_forms_equal_the_returning_form(inputs,
                                                           accumulate):
    dl, key = inputs
    N = key.shape[-1]
    want = ep.ext_product(torch.from_numpy(dl), _planes(key))
    rng = np.random.default_rng(3)
    start = torus.from_numpy(rng.integers(0, 1 << 64, size=(B, KP1, N),
                                          dtype=np.uint64))
    out = start.clone()
    got = ep.ext_product(torch.from_numpy(dl), _planes(key), out=out,
                         accumulate=accumulate)
    assert got is out
    assert torch.equal(out, torus.add(start, want) if accumulate else want)


@pytest.mark.parametrize("bad", ["dl_dtype", "key_dtype", "key_shape",
                                 "limbs", "size", "small", "stride",
                                 "groups", "chunk", "split", "too large",
                                 "cols", "out cols",
                                 "out shape", "out dtype",
                                 "accumulate without out"])
def test_wrapper_rejects_bad_inputs(inputs, monkeypatch, bad):
    dl = torch.from_numpy(inputs[0])
    key = _planes(inputs[1])
    N = key.shape[-1] // 2
    kwargs = {}
    if bad == "dl_dtype":
        dl = dl.to(torch.int16)
    elif bad == "key_dtype":
        key = key.to(torch.int16)
    elif bad == "key_shape":
        key = key[:, :, :4].contiguous()
    elif bad == "limbs":
        dl = dl[:2].contiguous()
    elif bad == "size":
        dl = dl[:, :, :N].contiguous()
    elif bad == "small":
        key, dl = key[..., :128].contiguous(), dl[:, :, :128].contiguous()
    elif bad == "stride":
        dl = dl.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "groups":
        kwargs["body"] = (3, 128, 1)
    elif bad == "chunk":
        kwargs["body"] = (1, 2 * N, 1)
    elif bad == "split":
        kwargs["body"] = (1, 128, 3)
    elif bad == "too large":
        dl, key = dl.repeat(1, 1, 2048 // N), key.repeat(1, 1, 1, 2048 // N)
        monkeypatch.setattr(ep, "SHARED_MEMORY", 100 * 1024)
        kwargs["body"] = (2, 2048, 1)
    elif bad == "cols":
        key = torch.cat([key, key[:, :1]], dim=1)
    elif bad == "out cols":
        key = key[:, :1].contiguous()
        kwargs["out"] = torch.zeros((B, KP1, N), dtype=torch.int64)
    elif bad == "out shape":
        kwargs["out"] = torch.zeros((B, KP1, 2 * N), dtype=torch.int64)
    elif bad == "out dtype":
        kwargs["out"] = torch.zeros((B, KP1, N), dtype=torch.int32)
    elif bad == "accumulate without out":
        kwargs["accumulate"] = True
    with pytest.raises((TypeError, ValueError)):
        ep.ext_product(dl, key, **kwargs)
