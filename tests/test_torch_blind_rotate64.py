"""The port's 64-bit blind-rotation kernel module against the JAX package.

``blind_rotate64_plain`` (what the wrapper runs on CPU tensors, and what
the CUDA kernel is held to on the card) is compared with the numpy oracle
``numpy_ref.blind_rotate`` in every mode (exact, rounded, rounded + approx,
and approx alone), and in the production mode (rounded + approx) with the
JAX package's Pallas kernel ``blind_rotate_fused`` run in interpret mode,
as tests/test_blind_rotate_fused.py runs it.  The key packing's byte limbs
are held to the JAX package's ``keys.balanced_limbs_u64``.  Keys and inputs
are made with numpy from a seed and given to both packages.

Tolerance: zero.  Every layer is exact integer arithmetic (exact NTTs, an
exact CRT, u64 wraparound), so outputs must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhestring_tpu import torus as jtorus
from fhestring_tpu.crypto import keys as jkeys
from fhestring_tpu.crypto.kernels.blind_rotate_fused import (
    blind_rotate_fused, pack_fused_consts)
from fhestring_tpu.numpy_ref import core as ref
from fhestring_tpu_torch import PARAM_TEST_NOISY, PARAM_TEST_ZERO_NOISE, torus
from fhestring_tpu_torch.crypto import keys, ntt
from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

KP1 = 2
# (rounded, approx): exact, rounded, production, and approx alone
MODES = [(False, False), (True, False), (True, True), (False, True)]


@pytest.fixture(scope="module", params=[PARAM_TEST_ZERO_NOISE,
                                        PARAM_TEST_NOISY],
                ids=lambda p: p.name)
def key_material(request):
    p = request.param
    _, srv = ref.keygen(p, np.random.default_rng(7))
    return p, srv, keys.pack_server_keys(srv, "cpu", params=p)


def _inputs(p, seed, B):
    """Random u64 accumulators and per-step amounts in [0, 2N)."""
    rng = np.random.default_rng(seed)
    N = p.polynomial_size
    acc0 = rng.integers(0, 1 << 64, size=(B, KP1, N), dtype=np.uint64)
    amounts = rng.integers(0, 2 * N, size=(B, p.lwe_dimension)).astype(np.int32)
    return acc0, amounts


def _plain(acc0, amounts, dev, rounded, approx):
    return torus.to_numpy(br.blind_rotate64_plain(
        torus.from_numpy(acc0), torch.from_numpy(amounts), dev.bsk_ntt64,
        rounded=rounded, approx=approx))


def _oracle(acc0, amounts, srv, rounded, approx):
    lwe = np.zeros((len(acc0), amounts.shape[1] + 1), np.int64)
    lwe[:, :-1] = amounts
    return np.stack([ref.blind_rotate(acc0[i], lwe[i], srv, rounded=rounded,
                                      min_shift=3 if approx else 0)
                     for i in range(len(acc0))])


@pytest.mark.parametrize("rounded,approx", MODES,
                         ids=["exact", "rounded", "production", "approx"])
def test_plain_matches_oracle(key_material, rounded, approx):
    p, srv, dev = key_material
    # the oracle's plane-truncated products are O(N^2) per item
    acc0, amounts = _inputs(p, 3, 4 if p.polynomial_size <= 256 else 2)
    np.testing.assert_array_equal(_plain(acc0, amounts, dev, rounded, approx),
                                  _oracle(acc0, amounts, srv, rounded, approx))


def test_plain_matches_interpreted_jax_kernel_in_production_mode():
    """B = 64 through the JAX package's blind_rotate_fused (interpreted)
    with rounded=True, approx=True: the mode the card runs."""
    p = PARAM_TEST_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(13))
    dev = keys.pack_server_keys(srv, "cpu", params=p)
    acc0, amounts = _inputs(p, 17, 64)
    got = _plain(acc0, amounts, dev, True, True)

    jdev = jkeys.pack_server_keys(srv, with_ntt2=True)
    acc = jtorus.from_numpy(acc0)
    lo, hi = blind_rotate_fused(
        acc.lo, acc.hi, jnp.asarray(amounts), jdev.bsk_ntt2,
        pack_fused_consts(p.polynomial_size), n_poly=p.polynomial_size,
        base_log=p.pbs_base_log, b_tile=64, interpret=True, rounded=True,
        approx=True)
    want = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounded", [False, True], ids=["exact", "rounded"])
def test_digits_at_the_rounding_and_sign_boundaries(rounded):
    """Digits whose 23-bit state sits at 2^22 - 1, 2^22, 0 and 2^23 - 1,
    with and without the round-up bit (bit 40), against the oracle's
    decomposition.  With a = N the rotation negates, so the exact diff is
    -2 acc and the rounded state is -acc_r - acc_r."""
    N = 64
    top = [(1 << 22) - 1, 1 << 22, 0, (1 << 23) - 1, 1, (1 << 22) + 1]
    values = []
    for t in top:
        for low in (0, 1 << 40, (1 << 40) - 1, (1 << 41) - 1):
            values.append(((t << 41) | low) % (1 << 64))
    diffs = np.array(values + [0] * (N - len(values)), np.uint64)
    if rounded:
        acc = diffs
        acc_r = ((acc >> np.uint64(41)) + ((acc >> np.uint64(40))
                                           & np.uint64(1))) & np.uint64(br._MASK)
        state = (np.uint64(0) - acc_r - acc_r) & np.uint64(br._MASK)
        want = state.astype(np.int64) - (state >= (1 << 22)) * (1 << 23)
    else:
        # exact: pick acc with -2 acc = diff (diff even), so rot - acc = diff
        diffs &= ~np.uint64(1)
        acc = (np.uint64(0) - diffs) >> np.uint64(1)
        want = ref.decompose(np.uint64(0) - acc - acc, 23, 1)[0]
    acc_t = torus.from_numpy(np.stack([acc, acc])[None])
    got = br._digits(acc_t, torch.tensor([N]), rounded)[0, 0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -(1 << 22) and got.max() < (1 << 22)


def test_key_limbs_match_jax_balanced_limbs_u64():
    """The 8 byte limbs the key is packed from equal the JAX package's
    balanced_limbs_u64 (final carry dropped), edge values included; and the
    packed hats transform back to exactly those limbs."""
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, 127, 128, 255, 256, (1 << 63) - 1, 1 << 63,
                     (1 << 64) - 1, (1 << 64) - 128, 0x7F7F7F7F7F7F7F7F,
                     0x8080808080808080], np.uint64)
    values = np.concatenate([edge, rng.integers(0, 1 << 64, size=500,
                                                dtype=np.uint64)])
    got = keys.balanced_limbs(torus.from_numpy(values), 8).numpy()
    np.testing.assert_array_equal(got, jkeys.balanced_limbs_u64(values))

    p = PARAM_TEST_ZERO_NOISE
    N = p.polynomial_size
    bsk = rng.integers(0, 1 << 64, size=(3, KP1, KP1, N), dtype=np.uint64)
    bsk[0, 0, 0, :len(edge)] = edge
    khat = keys.pack_bsk_hats(bsk, "cpu", keys.KEY_PLANES64)
    assert tuple(khat.shape) == (3, 2, KP1, KP1 * 8, N)
    assert khat.dtype == torch.int16
    tw = torch.from_numpy(ntt.twiddles(N))
    residues = (khat.to(torch.int64) & 0xFFFF).movedim(1, 0)
    back = ntt.ntt_inv(residues, tw)                    # limbs mod p, x N/N
    limbs = jkeys.balanced_limbs_u64(bsk)               # [3, R, kp1, N, 8]
    limbs = np.moveaxis(limbs, -1, -2).reshape(3, KP1, KP1 * 8, N)
    for i, q in enumerate(ntt.PRIMES):
        np.testing.assert_array_equal(back[i].numpy(), limbs.astype(np.int64) % q)


def test_cpu_wrapper_runs_plain_and_counts_no_launch(key_material):
    p, _, dev = key_material
    acc0, amounts = _inputs(p, 9, 3)
    before = br.blind_rotate64.launches
    out = br.blind_rotate64(torus.from_numpy(acc0), torch.from_numpy(amounts),
                            dev.bsk_ntt64, rounded=True, approx=True)
    assert br.blind_rotate64.launches == before == 0
    np.testing.assert_array_equal(torus.to_numpy(out),
                                  _plain(acc0, amounts, dev, True, True))


def test_key_layout_and_exactness_bound(key_material):
    p, _, dev = key_material
    N = p.polynomial_size
    assert tuple(dev.bsk_ntt64.shape) == (p.lwe_dimension, 2, KP1, KP1 * 8, N)
    assert dev.bsk_ntt64.dtype == torch.int16
    assert dev.bsk_ntt32 is None
    # the CRT reconstructs |W| < M/2; N = 2048 sits at 0.16 * M/2
    assert br.max_plane_value(2048) == 3 * 2 * 2048 * 128 * 128
    assert br.max_plane_value(2048) < 0.16 * (40961 * 61441) // 2
    assert list(br.shift_planes(True)) == [3, 4, 5, 6, 7]
    assert list(br.shift_planes(False)) == list(range(8))


@pytest.mark.parametrize("bad", ["acc_dtype", "amount_dtype", "key_dtype",
                                 "key_shape", "batch", "stride", "rows"])
def test_wrapper_rejects_bad_inputs(key_material, bad):
    p, _, dev = key_material
    acc0, amounts = _inputs(p, 4, 4)
    acc = torus.from_numpy(acc0)
    amt = torch.from_numpy(amounts)
    khat = dev.bsk_ntt64
    if bad == "acc_dtype":
        acc = acc.to(torch.int32)
    elif bad == "amount_dtype":
        amt = amt.to(torch.int64)
    elif bad == "key_dtype":
        khat = khat.to(torch.int32)
    elif bad == "key_shape":
        khat = khat[:, :, :, :8]
    elif bad == "batch":
        amt = amt[:-1]
    elif bad == "stride":
        acc = acc.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rows":
        acc = torch.cat([acc, acc[:, :1]], dim=1)
    with pytest.raises((TypeError, ValueError)):
        br.blind_rotate64(acc, amt, khat)
