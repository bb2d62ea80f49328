"""The port's step-wise external product by NTT (K4, ``kernels/ntt_ext.py``)
against the JAX package and against K3.

``ntt_ext_plain`` (what the wrapper runs on CPU tensors, and what the CUDA
kernel is held to on the card) is compared, at n=256 and B=64, with the
JAX package's Pallas kernel ``ntt_ext_u64`` run in interpret mode and with
its numpy reference ``ntt2.ext_u64_ntt2_numpy``, as
tests/test_ntt_ext_kernel.py runs them; and with the port's K3 plain
version (``ext_product_plain``) on the same input.  The JAX kernel takes a
3-prime NTT-domain key (``ntt2.key_hats``); the port's K4 takes one step of
the 2-prime key of its 64-bit blind rotation (``keys.pack_bsk_hats``); both
come from the same numpy u64 key polys.  Digits span [-2^22, 2^22].

Tolerance: zero.  Every route is exact integer arithmetic mod 2^64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhestring_tpu.crypto import ntt2
from fhestring_tpu.crypto.keys import balanced_limbs_u64
from fhestring_tpu.crypto.kernels import ntt_ext as jax_ntt_ext
from fhestring_tpu_torch import torus
from fhestring_tpu_torch.crypto import keys
from fhestring_tpu_torch.crypto.kernels import ext_product as ep
from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

N, B, R, KP1, LIMBS = 256, 64, 2, 2, 3


def _digit_limbs(digits: np.ndarray) -> np.ndarray:
    """Balanced int8 limbs [..., 3] of digits (as the JAX test makes them)."""
    out, state = [], digits.astype(np.int64)
    for _ in range(LIMBS):
        limb = ((state + 128) % 256) - 128
        out.append(limb.astype(np.int8))
        state = (state - limb) >> 8
    return np.stack(out, axis=-1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    digits = rng.integers(-(1 << 22), (1 << 22) + 1, size=(B, R, N))
    digits[0, 0, :4] = [-(1 << 22), 1 << 22, (1 << 22) - 1, 0]
    dl = _digit_limbs(digits)                             # [B, R, N, La]
    key = rng.integers(0, 1 << 64, size=(R, KP1, N), dtype=np.uint64)
    port_dl = np.ascontiguousarray(
        np.transpose(dl, (3, 0, 1, 2)).reshape(LIMBS, B, R * N))
    return dl, key, port_dl


def _port(port_dl, key):
    khat = keys.pack_bsk_hats(key[None], "cpu", keys.KEY_PLANES64)[0]
    return torus.to_numpy(ne.ntt_ext_plain(torch.from_numpy(port_dl), khat))


def _u64(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))


def test_plain_matches_interpreted_jax_kernel_and_numpy_reference(inputs):
    dl, key, port_dl = inputs
    raw_limbs = np.moveaxis(balanced_limbs_u64(key), -1, -2)
    khat = ntt2.key_hats(raw_limbs, N)                    # [3, R, KP1, 8, N]
    got = _port(port_dl, key)
    np.testing.assert_array_equal(got, _u64(*ntt2.ext_u64_ntt2_numpy(
        dl, khat, N)))
    lo, hi = jax_ntt_ext.ntt_ext_u64(
        jnp.asarray(port_dl), jnp.asarray(khat.reshape(khat.shape[:-1]
                                                       + (N // 128, 128))),
        jax_ntt_ext.pack_neg_consts(N), n_poly=N, b_tile=64, interpret=True)
    np.testing.assert_array_equal(got, _u64(lo, hi))


def test_plain_equals_the_k3_plain_version(inputs):
    _, key, port_dl = inputs
    limbs = keys.pack_bsk_limbs(key[None], "cpu")[0]
    k3 = ep.ext_product_plain(torch.from_numpy(port_dl), limbs)
    np.testing.assert_array_equal(_port(port_dl, key), torus.to_numpy(k3))


def test_cpu_wrapper_runs_plain_and_counts_no_launch(inputs):
    _, key, port_dl = inputs
    khat = keys.pack_bsk_hats(key[None], "cpu", keys.KEY_PLANES64)[0]
    before = ne.ntt_ext.launches
    out = ne.ntt_ext(torch.from_numpy(port_dl), khat)
    assert ne.ntt_ext.launches == before == 0
    np.testing.assert_array_equal(torus.to_numpy(out), _port(port_dl, key))


@pytest.mark.parametrize("bad", ["dl_dtype", "key_dtype", "key_shape",
                                 "limbs", "size", "stride"])
def test_wrapper_rejects_bad_inputs(inputs, bad):
    _, key, port_dl = inputs
    dl = torch.from_numpy(port_dl)
    khat = keys.pack_bsk_hats(key[None], "cpu", keys.KEY_PLANES64)[0]
    if bad == "dl_dtype":
        dl = dl.to(torch.int16)
    elif bad == "key_dtype":
        khat = khat.to(torch.int32)
    elif bad == "key_shape":
        khat = khat[:, :, :8].contiguous()
    elif bad == "limbs":
        dl = dl[:2].contiguous()
    elif bad == "size":
        dl = dl[:, :, :N].contiguous()
    elif bad == "stride":
        dl = dl.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        ne.ntt_ext(dl, khat)


@pytest.mark.parametrize("cluster", [None, 1, 2, 4])
def test_every_body_is_the_plain_version_on_the_cpu(inputs, cluster):
    """``cluster=`` picks the kernel's body on the card; on the CPU every
    value runs the plain version, adding into ``out`` where asked."""
    _, key, port_dl = inputs
    khat = keys.pack_bsk_hats(key[None], "cpu", keys.KEY_PLANES64)[0]
    dl = torch.from_numpy(port_dl)
    want = ne.ntt_ext_plain(dl, khat)
    assert torch.equal(ne.ntt_ext(dl, khat, cluster=cluster), want)
    start = torch.arange(want.numel(), dtype=torch.int64).view(want.shape)
    out = start.clone()
    assert ne.ntt_ext(dl, khat, out=out, accumulate=True,
                      cluster=cluster) is out
    assert torch.equal(out, start + want)
    assert ne.ntt_ext.launches == 0 and set(ne.ntt_ext.bodies) == {1, 2, 4}


@pytest.mark.parametrize("bad", [0, 3, 8, True, "2"])
def test_wrapper_rejects_other_cluster_values(inputs, bad):
    _, key, port_dl = inputs
    khat = keys.pack_bsk_hats(key[None], "cpu", keys.KEY_PLANES64)[0]
    with pytest.raises(ValueError):
        ne.ntt_ext(torch.from_numpy(port_dl), khat, cluster=bad)


def test_pick_uses_the_wave_model():
    """The pick is ``cluster.cluster_size`` with this kernel's wave costs:
    4 blocks an item while the card has room for the batch, 2 beyond, 1
    once the batch fills the card."""
    from fhestring_tpu_torch.crypto.kernels import cluster

    room = {2: 66, 4: 30}
    picks = {b: cluster.cluster_size(b, 132, 2048, ne.WAVE_COST,
                                     lambda c, n: room[c])
             for b in (1, 8, 30, 31, 66, 67, 132, 133, 2048)}
    assert picks[1] == picks[8] == picks[30] == 4
    assert picks[66] == 2
    assert picks[2048] == 1
    assert all(p in ne.CLUSTERS for p in picks.values())
