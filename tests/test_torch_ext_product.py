"""The port's step-wise external product by convolution (K3,
``kernels/ext_product.py``) and its limb key against the JAX package.

``ext_product_plain`` (what the wrapper runs on CPU tensors, and what the
CUDA kernel is held to on the card) is compared with the JAX package's
Pallas kernel ``ext_product_u64`` run in interpret mode, as
tests/test_ext_product_kernel.py runs it, at N=256 and B=8.  Both get the
same numpy digit limbs and u64 key polys: the port in natural order with
the key's 8 byte limbs, the JAX kernel with the digits reversed per row
(drev) and the limbs of the doubled key quadrupled to 4N (p4).  The port's
``bsk_limbs`` is held to the JAX ``pack_server_keys(srv).bsk_limbs[..., :N]``.

Tolerance: zero.  Both compute the product exactly mod 2^64.
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

B, R, KP1, N, LIMBS = 8, 2, 2, 256, 3
EDGE = np.array([0, 1, 127, 128, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
                 (1 << 64) - 128, 0x8080808080808080], np.uint64)


@pytest.fixture(scope="module")
def inputs():
    """Digit limbs int8 [3, B, R*N] (natural order) and u64 key polys
    [R, KP1, N] with edge values."""
    rng = np.random.default_rng(0)
    dl = rng.integers(-128, 128, size=(LIMBS, B, R * N)).astype(np.int8)
    key = rng.integers(0, 1 << 64, size=(R, KP1, N), dtype=np.uint64)
    key[0, 0, :len(EDGE)] = EDGE
    key[1, 1, -len(EDGE):] = EDGE
    return dl, key


def _port(dl, key):
    limbs = keys.pack_bsk_limbs(key[None], "cpu")[0]
    return torus.to_numpy(ep.ext_product_plain(torch.from_numpy(dl), limbs))


def test_plain_matches_interpreted_jax_kernel(inputs):
    dl, key = inputs
    drev = np.flip(dl.reshape(LIMBS, B, R, N), axis=-1).reshape(LIMBS, B, R * N)
    p2 = np.moveaxis(jkeys.balanced_limbs_u64(jkeys.negacyclic_double(key)),
                     -1, -2)                             # [R, KP1, 8, 2N]
    p4 = np.concatenate([p2, p2], axis=-1)
    lo, hi = ext_product_u64(np.ascontiguousarray(drev), p4, n_poly=N,
                             b_tile=8, interpret=True)
    want = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(_port(dl, key), want)


def test_plain_matches_the_u64_convolution(inputs):
    """Against the definition: sum_r d_r (x) K_r, negacyclic mod 2^64, with
    d = sum_la 256^la dl_la (numpy uint64, two items)."""
    dl, key = inputs
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
    p = PARAM_TEST_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(7))
    got = keys.pack_server_keys(srv, "cpu", params=p).bsk_limbs
    want = np.asarray(jkeys.pack_server_keys(srv).bsk_limbs)[..., :p.polynomial_size]
    assert got.dtype == torch.int8
    assert tuple(got.shape) == (p.lwe_dimension, R, KP1, 8, p.polynomial_size)
    np.testing.assert_array_equal(got.numpy(), want)


def test_items_per_block_spreads_small_batches():
    """Grid N/128 x (k+1) x ceil(B/items): small batches take 1 item per
    block; large ones 4, once that still gives two blocks per SM."""
    assert [ep.items_per_block(b, 2048, 132) for b in (1, 5, 8, 32, 33, 99,
                                                       132, 2048)] == [
        1, 1, 1, 1, 4, 4, 4, 4]
    assert ep.items_per_block(16, 256, 132) == 1
    assert ep.items_per_block(4096, 256, 132) == 4
    assert ep.items_per_block(33, 2048, 264) == 1


def test_cpu_wrapper_runs_plain_and_counts_no_launch(inputs):
    dl, key = inputs
    before = ep.ext_product.launches
    out = ep.ext_product(torch.from_numpy(dl),
                         keys.pack_bsk_limbs(key[None], "cpu")[0])
    assert ep.ext_product.launches == before == 0
    np.testing.assert_array_equal(torus.to_numpy(out), _port(dl, key))


@pytest.mark.parametrize("bad", ["dl_dtype", "key_dtype", "key_shape",
                                 "limbs", "size", "small", "stride",
                                 "items"])
def test_wrapper_rejects_bad_inputs(inputs, bad):
    dl = torch.from_numpy(inputs[0])
    key = keys.pack_bsk_limbs(inputs[1][None], "cpu")[0]
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
        key, dl = key[..., :64].contiguous(), dl[:, :, :128].contiguous()
    elif bad == "stride":
        dl = dl.transpose(1, 2).contiguous().transpose(1, 2)
    items = 3 if bad == "items" else None
    with pytest.raises((TypeError, ValueError)):
        ep.ext_product(dl, key, items=items)
