"""The port's per-step prologue (K5, ``kernels/rotate_decompose.py``)
against the JAX package.

``rotate_diff_decompose_plain`` (what the wrapper runs on CPU tensors, and
what the CUDA kernel is held to on the card) is compared with the JAX
package's Pallas kernel ``rotate_diff_decompose`` run in interpret mode,
and with the JAX XLA pipeline it replaces (shear rotation, u64 difference,
``decompose``, ``balanced_limbs_i32``), at N=256 and B=8.  The amounts
include 0, N and 2N-1, and the accumulators put digits on the rounding and
sign boundaries: 23-bit states 2^22 - 1, 2^22 and 2^23 - 1, with the round
bit (bit 40 of the difference) set and clear.  Inputs are made with numpy
from a seed and given to both packages.

Tolerance: zero.  The prologue is exact integer arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhestring_tpu import torus as jtorus
from fhestring_tpu.crypto import pbs as jpbs
from fhestring_tpu.crypto.kernels.rotate_decompose import (
    rotate_diff_decompose as jax_rotate_diff_decompose)
from fhestring_tpu.numpy_ref import core as ref
from fhestring_tpu_torch import torus
from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

B, KP1, N = 8, 2, 256
BASE_LOG, LIMBS = 23, 3
# 23-bit digit states on the sign and wrap boundaries, and the low bits
# below them: the round bit (bit 40) set or clear
TOPS = [(1 << 22) - 1, 1 << 22, (1 << 23) - 1, 0, 1, (1 << 22) + 1]
LOWS = [0, 1 << 40, (1 << 40) - 1, (1 << 41) - 2, (1 << 39)]


def _boundary_diffs() -> np.ndarray:
    """[KP1 * N] even u64 differences whose digits sit on the boundaries."""
    vals = [((t << 41) | lo) % (1 << 64) for t in TOPS for lo in LOWS]
    vals = np.array((vals * (KP1 * N // len(vals) + 1))[:KP1 * N], np.uint64)
    return vals & ~np.uint64(1)


@pytest.fixture(scope="module")
def inputs():
    """Accumulators and amounts: items 0-2 take a = 0, N, 2N - 1 on random
    accumulators; items 3 and 4 take a = N on accumulators whose
    difference -2 acc is the boundary set (and its negation)."""
    rng = np.random.default_rng(3)
    acc = rng.integers(0, 1 << 64, size=(B, KP1, N), dtype=np.uint64)
    amounts = rng.integers(0, 2 * N, size=B).astype(np.int32)
    amounts[:5] = [0, N, 2 * N - 1, N, N]
    diffs = _boundary_diffs()
    acc[3] = ((np.uint64(0) - diffs) >> np.uint64(1)).reshape(KP1, N)
    acc[4] = (diffs >> np.uint64(1)).reshape(KP1, N)
    return acc, amounts


def _port(acc, amounts):
    return rd.rotate_diff_decompose_plain(
        torus.from_numpy(acc), torch.from_numpy(amounts)).numpy()


def test_plain_matches_interpreted_jax_kernel(inputs):
    acc, amounts = inputs
    a = jtorus.from_numpy(acc)
    want = np.asarray(jax_rotate_diff_decompose(
        a.lo, a.hi, jnp.asarray(amounts), n_poly=N, base_log=BASE_LOG,
        num_la=LIMBS, interpret=True))
    got = _port(acc, amounts)
    assert got.dtype == np.int8 and got.shape == (LIMBS, B, KP1 * N)
    np.testing.assert_array_equal(got, want)


def test_plain_matches_jax_xla_pipeline(inputs):
    acc, amounts = inputs
    a = jtorus.from_numpy(acc)
    rotated = jpbs._negacyclic_rotate_shear(a, jnp.asarray(amounts), N)
    digits = jpbs.decompose(jtorus.sub(rotated, a), BASE_LOG, 1)
    want = np.asarray(jpbs.balanced_limbs_i32(digits[0].astype(jnp.int32),
                                              LIMBS))   # [B, KP1, N, La]
    want = np.moveaxis(want, -1, 0).reshape(LIMBS, B, KP1 * N)
    np.testing.assert_array_equal(_port(acc, amounts), want)


def test_boundary_digits_match_the_oracle(inputs):
    """Items 3 and 4 rotate by N, so diff = -2 acc: the limbs recombine to
    numpy_ref.decompose(diff, 23, 1), every boundary state occurs, and the
    digits stay in [-2^22, 2^22)."""
    acc, amounts = inputs
    got = _port(acc, amounts).astype(np.int64)
    digits = got[0] + 256 * got[1] + 65536 * got[2]      # [B, KP1 * N]
    for item in (3, 4):
        diff = (np.uint64(0) - acc[item] - acc[item]).reshape(-1)
        np.testing.assert_array_equal(digits[item],
                                      ref.decompose(diff, BASE_LOG, 1)[0])
    state = set((digits[3] % (1 << 23)).tolist())
    assert {(1 << 22) - 1, 1 << 22, (1 << 23) - 1} <= state
    assert digits.min() >= -(1 << 22) and digits.max() < (1 << 22)
    np.testing.assert_array_equal(digits[0], 0)        # a = 0: no change


def test_cpu_wrapper_runs_plain_and_counts_no_launch(inputs):
    acc, amounts = inputs
    before = rd.rotate_diff_decompose.launches
    out = rd.rotate_diff_decompose(torus.from_numpy(acc),
                                   torch.from_numpy(amounts))
    assert rd.rotate_diff_decompose.launches == before == 0
    np.testing.assert_array_equal(out.numpy(), _port(acc, amounts))


@pytest.mark.parametrize("bad", ["acc_dtype", "amount_dtype", "amount_dim",
                                 "batch", "rows", "size", "stride"])
def test_wrapper_rejects_bad_inputs(inputs, bad):
    acc = torus.from_numpy(inputs[0])
    amt = torch.from_numpy(inputs[1])
    if bad == "acc_dtype":
        acc = acc.to(torch.int32)
    elif bad == "amount_dtype":
        amt = amt.to(torch.int64)
    elif bad == "amount_dim":
        amt = amt[:, None]
    elif bad == "batch":
        amt = amt[:-1]
    elif bad == "rows":
        acc = torch.cat([acc, acc[:, :1]], dim=1)
    elif bad == "size":
        acc = acc[:, :, :N - 8].contiguous()
    elif bad == "stride":
        acc = acc.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        rd.rotate_diff_decompose(acc, amt)
