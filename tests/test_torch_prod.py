"""The port's 64-bit programmable bootstrap (the PARAM_PROD family) against
the JAX package, bit for bit.

At the 64-bit CI sets PARAM_TEST_ZERO_NOISE and PARAM_TEST_STAT: the
8-plane keyswitch against JAX ``pbs.keyswitch`` and the oracle; the exact
``pbs_batch`` against JAX ``pbs_batch`` on CPU (its einsum path) and
``numpy_ref.pbs``; the production-mode ``pbs_batch`` (rounded + approx, the
mode the card runs) against JAX ``pbs_batch(use_fused=True, rounded=True,
approx=True)`` with its Pallas kernel interpreted; and the shortint layer's
choice of mode.  Keys and ciphertexts are made once with numpy from a seed
and given to both packages.

Tolerance: zero.  Every stage is exact integer arithmetic, so ciphertexts
must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhestring_tpu import torus as jtorus
from fhestring_tpu.crypto import keys as jkeys
from fhestring_tpu.crypto import pbs as jpbs
from fhestring_tpu.numpy_ref import core as ref
from fhestring_tpu_torch import PARAM_PROD, PARAM_TEST_ZERO_NOISE, torus
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br
from fhestring_tpu_torch.params import PARAM_TEST_STAT
from fhestring_tpu_torch.shortint import ShortintContext

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

TABLE = [(7 * x + 3) % 16 for x in range(16)]


@pytest.fixture(scope="module", params=[PARAM_TEST_ZERO_NOISE,
                                        PARAM_TEST_STAT],
                ids=lambda p: p.name)
def setup(request):
    p = request.param
    rng = np.random.default_rng(5)
    sk, srv = ref.keygen(p, rng)
    return p, sk, srv, keys.pack_server_keys(srv, "cpu", params=p), rng


def _encrypt(sk, msgs, rng):
    return np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])


def _pbs(cts, dev, p, tables=(TABLE,), idx=None, **mode):
    idx = torch.zeros(len(cts), dtype=torch.int64) if idx is None else idx
    return torus.to_numpy(pbs.pbs_batch(
        torus.from_numpy(cts), idx, keys.pack_luts(list(tables), p, "cpu"),
        dev, **mode))


def test_keyswitch_matches_jax_and_oracle(setup):
    p, sk, srv, dev, rng = setup
    cts = _encrypt(sk, np.arange(16), rng)
    got = torus.to_numpy(pbs.keyswitch(torus.from_numpy(cts), dev))
    want = np.stack([ref.keyswitch(c, srv) for c in cts])
    np.testing.assert_array_equal(got, want)
    jgot = jtorus.to_numpy(jpbs.keyswitch(jtorus.from_numpy(cts),
                                          jkeys.pack_server_keys(srv)))
    np.testing.assert_array_equal(got, jgot)
    # all 8 byte planes of the 64-bit key; (n+1)*8 is already a multiple
    # of 8 (PARAM_PROD: 5944 columns)
    assert tuple(dev.ksk_limbs.shape) == (p.big_lwe_dimension * p.ks_level,
                                          (p.lwe_dimension + 1) * 8)
    assert (PARAM_PROD.lwe_dimension + 1) * 8 == 5944


def test_exact_pbs_batch_matches_jax_cpu_path_and_oracle(setup):
    p, sk, srv, dev, rng = setup
    msgs = rng.integers(0, 16, size=12)
    cts = _encrypt(sk, msgs, rng)
    got = _pbs(cts, dev, p)
    jout = jpbs.pbs_batch(jtorus.from_numpy(cts), jnp.zeros(len(msgs), jnp.int32),
                          jkeys.pack_luts([TABLE], p), jkeys.pack_server_keys(srv))
    np.testing.assert_array_equal(got, jtorus.to_numpy(jout))
    for i in range(0, len(msgs), 4):
        np.testing.assert_array_equal(got[i], ref.pbs(cts[i], TABLE, srv))
    for i, m in enumerate(msgs):
        assert ref.shortint_decrypt(sk, got[i]) == TABLE[m]


def test_production_pbs_batch_matches_interpreted_jax_kernel(setup):
    """rounded=True, approx=True: JAX pbs_batch with use_fused=True runs
    blind_rotate_fused (interpreted on CPU) with the NTT key packed."""
    p, sk, srv, dev, rng = setup
    msgs = rng.integers(0, 16, size=16)
    cts = _encrypt(sk, msgs, rng)
    got = _pbs(cts, dev, p, rounded=True, approx=True)
    jout = jpbs.pbs_batch(jtorus.from_numpy(cts), jnp.zeros(len(msgs), jnp.int32),
                          jkeys.pack_luts([TABLE], p),
                          jkeys.pack_server_keys(srv, with_ntt2=True),
                          use_fused=True, rounded=True, approx=True)
    np.testing.assert_array_equal(got, jtorus.to_numpy(jout))
    for i, m in enumerate(msgs):
        assert ref.shortint_decrypt(sk, got[i]) == TABLE[m]


def test_pbs_batch_per_item_luts(setup):
    """lut_idx selects a test polynomial per item from the bank."""
    p, sk, srv, dev, rng = setup
    tables = [[(x + t) % 16 for x in range(16)] for t in range(3)]
    msgs = rng.integers(0, 16, size=9)
    idx = np.arange(9) % 3
    got = _pbs(_encrypt(sk, msgs, rng), dev, p, tables, torch.from_numpy(idx))
    for i, m in enumerate(msgs):
        assert ref.shortint_decrypt(sk, got[i]) == tables[idx[i]][m]


def test_shortint_runs_the_exact_mode_on_cpu(setup):
    """On CPU tensors the shortint layer runs the exact blind rotation (as
    the JAX package's CPU path does) through the plain version: no kernel
    launch, and outputs equal to the exact pbs_batch."""
    p, sk, srv, dev, rng = setup
    ctx = ShortintContext(dev)
    cts = _encrypt(sk, rng.integers(0, 16, size=5), rng)
    before = br.blind_rotate64.launches
    blocks = ctx.apply_lut(ctx.from_numpy_cts(cts), TABLE)
    assert br.blind_rotate64.launches == before
    np.testing.assert_array_equal(torus.to_numpy(blocks.ct), _pbs(cts, dev, p))


def test_turbo_kernel_refuses_the_64bit_modes():
    """The 32-bit blind rotation has no rounded or approx mode."""
    from fhestring_tpu_torch import PARAM_TEST32_ZERO_NOISE as P32

    _, srv = ref.keygen(P32, np.random.default_rng(0))
    dev = keys.pack_server_keys(srv, "cpu", params=P32)
    acc = torch.zeros((1, 2, P32.polynomial_size), dtype=torch.int64)
    lwe = torch.zeros((1, P32.lwe_dimension + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="exact mode only"):
        pbs.blind_rotate(acc, lwe, dev, rounded=True, approx=True)
