"""The port's programmable bootstrap against the JAX package, bit for bit.

Mirrors tests/test_fused32.py: keyswitch against JAX ``pbs.keyswitch`` and
the oracle, then the whole ``pbs_batch`` against JAX ``pbs_batch(
use_fused=True)`` (its Pallas kernel interpreted) and ``numpy_ref.pbs``, at
PARAM_TEST32_ZERO_NOISE and PARAM_TEST32_STAT.  Keys and ciphertexts are
made once with numpy from a seed and given to both packages.

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
from fhestring_tpu_torch import PARAM_TEST32_STAT, PARAM_TEST32_ZERO_NOISE
from fhestring_tpu_torch import torus
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.crypto.kernels import blind_rotate32 as br

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

PSETS = [PARAM_TEST32_ZERO_NOISE, PARAM_TEST32_STAT]


@pytest.fixture(scope="module", params=PSETS, ids=lambda p: p.name)
def setup(request):
    p = request.param
    rng = np.random.default_rng(5)
    sk, srv = ref.keygen(p, rng)
    return p, sk, srv, keys.pack_server_keys(srv, "cpu", params=p), rng


def _encrypt(sk, msgs, rng):
    return np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])


def test_decompose_matches_jax_and_oracle():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << 64, size=(4, 300), dtype=np.uint64)
    for base_log, levels in [(3, 5), (8, 3), (23, 1)]:
        want = ref.decompose(v, base_log, levels)
        got = pbs.decompose(torus.from_numpy(v), base_log, levels).numpy()
        np.testing.assert_array_equal(got, want)
        jgot = np.asarray(jpbs.decompose(jtorus.from_numpy(v), base_log, levels))
        np.testing.assert_array_equal(got, jgot)


def test_keyswitch_matches_jax_and_oracle(setup):
    p, sk, srv, dev, rng = setup
    cts = _encrypt(sk, np.arange(16), rng)
    got = torus.to_numpy(pbs.keyswitch(torus.from_numpy(cts), dev))
    want = np.stack([ref.keyswitch(c, srv) for c in cts])
    np.testing.assert_array_equal(got, want)
    jdev = jkeys.pack_server_keys(srv)
    jgot = jtorus.to_numpy(jpbs.keyswitch(jtorus.from_numpy(cts), jdev))
    np.testing.assert_array_equal(got, jgot)
    assert (got % (1 << 32) == 0).all()
    # the KS matmul's columns are padded to a multiple of 8 for _int_mm
    assert dev.ksk_limbs.shape[1] % 8 == 0
    assert dev.ksk_limbs.shape[1] >= (p.lwe_dimension + 1) * 4


def test_modswitch_and_sample_extract_match_jax(setup):
    p, sk, srv, dev, rng = setup
    cts = _encrypt(sk, np.arange(8), rng)
    small = np.stack([ref.keyswitch(c, srv) for c in cts])
    got = pbs.modswitch(torus.from_numpy(small), p).numpy()
    np.testing.assert_array_equal(got, np.stack([ref.modswitch(s, p) for s in small]))
    np.testing.assert_array_equal(
        got, np.asarray(jpbs.modswitch(jtorus.from_numpy(small), p)))

    acc = rng.integers(0, 1 << 64, size=(8, p.glwe_dimension + 1,
                                         p.polynomial_size), dtype=np.uint64)
    got = torus.to_numpy(pbs.sample_extract(torus.from_numpy(acc), p))
    np.testing.assert_array_equal(got, np.stack([ref.sample_extract(a, p) for a in acc]))
    np.testing.assert_array_equal(
        got, jtorus.to_numpy(jpbs.sample_extract(jtorus.from_numpy(acc), p)))


def test_blind_rotate_applies_the_body_first(setup):
    """blind_rotate takes lwe_2n with the body b in its last column and
    rotates by -b before the kernel, which gets the mask amounts only."""
    p, sk, srv, dev, rng = setup
    B, N = 6, p.polynomial_size
    acc0 = rng.integers(0, 1 << 32, size=(B, p.glwe_dimension + 1, N),
                        dtype=np.uint64) << np.uint64(32)
    lwe = rng.integers(0, 2 * N, size=(B, p.lwe_dimension + 1))
    lwe[0, -1] = 0
    got = torus.to_numpy(pbs.blind_rotate(
        torus.from_numpy(acc0), torch.from_numpy(lwe), dev))
    want = np.stack([ref.blind_rotate(acc0[i], lwe[i], srv) for i in range(B)])
    np.testing.assert_array_equal(got, want)


def test_pbs_batch_matches_jax_fused_and_oracle(setup):
    """Full KS -> MS -> test-poly rotation -> blind rotation -> extract:
    pbs_batch pre-rotates the test polynomial by -b and passes the mask
    amounts without b, exactly as the JAX pbs_batch does."""
    p, sk, srv, dev, rng = setup
    table = [(7 * x + 3) % 16 for x in range(16)]
    msgs = rng.integers(0, 16, size=32)
    cts = _encrypt(sk, msgs, rng)
    bank = keys.pack_luts([table], p, "cpu")
    before = br.blind_rotate32.launches
    got = torus.to_numpy(pbs.pbs_batch(
        torus.from_numpy(cts), torch.zeros(len(msgs), dtype=torch.int64),
        bank, dev))
    assert br.blind_rotate32.launches == before  # CPU: plain version

    jdev = jkeys.pack_server_keys(srv, with_ntt2=True)
    jout = jpbs.pbs_batch(jtorus.from_numpy(cts),
                          jnp.zeros(len(msgs), jnp.int32),
                          jkeys.pack_luts([table], p), jdev, use_fused=True)
    np.testing.assert_array_equal(got, jtorus.to_numpy(jout))
    for i in range(0, len(msgs), 4):
        np.testing.assert_array_equal(got[i], ref.pbs(cts[i], table, srv))
    for i, m in enumerate(msgs):
        assert ref.shortint_decrypt(sk, got[i]) == table[m]


def test_pbs_batch_takes_the_jax_signatures_use_fused(setup):
    """A caller written for the JAX signature passes use_fused=True: that
    is the whole-rotation kernel, the port's default, and it wins over the
    step-wise keywords as in the JAX package."""
    p, sk, srv, dev, rng = setup
    msgs = rng.integers(0, 16, size=8)
    cts = torus.from_numpy(_encrypt(sk, msgs, rng))
    idx = torch.zeros(len(msgs), dtype=torch.int64)
    bank = keys.pack_luts([[(7 * x + 3) % 16 for x in range(16)]], p, "cpu")
    want = pbs.pbs_batch(cts, idx, bank, dev)
    assert torch.equal(pbs.pbs_batch(cts, idx, bank, dev, use_fused=True),
                       want)
    # a 32-bit set has no step-wise route: use_fused keeps it off that path
    assert torch.equal(pbs.pbs_batch(cts, idx, bank, dev, use_fused=True,
                                     use_pallas=True), want)
    with pytest.raises(ValueError):
        pbs.pbs_batch(cts, idx, bank, dev, use_pallas=True)


def test_pbs_batch_per_item_luts(setup):
    """lut_idx selects a test polynomial per item from the bank."""
    p, sk, srv, dev, rng = setup
    tables = [[(x + t) % 16 for x in range(16)] for t in range(3)]
    msgs = rng.integers(0, 16, size=9)
    idx = np.arange(9) % 3
    cts = _encrypt(sk, msgs, rng)
    got = torus.to_numpy(pbs.pbs_batch(
        torus.from_numpy(cts), torch.from_numpy(idx),
        keys.pack_luts(tables, p, "cpu"), dev))
    for i, m in enumerate(msgs):
        assert ref.shortint_decrypt(sk, got[i]) == tables[idx[i]][m]


def test_64bit_torus_is_not_ported():
    """The 64-bit torus is not run through the 32-bit path: its keys pack
    into the 64-bit kernel's layout (8 byte planes) and not into the turbo
    one, and the 32-bit kernel refuses that key."""
    from fhestring_tpu_torch.params import PARAM_TEST_ZERO_NOISE as P64

    _, srv = ref.keygen(P64, np.random.default_rng(0))
    dev = keys.pack_server_keys(srv, "cpu", params=P64)
    assert dev.bsk_ntt32 is None
    assert dev.bsk_ntt64.shape[3] == 2 * 8
    acc = torch.zeros((1, 2, P64.polynomial_size), dtype=torch.int32)
    amounts = torch.zeros((1, P64.lwe_dimension), dtype=torch.int32)
    with pytest.raises(ValueError, match="khat shape"):
        br.blind_rotate32(acc, amounts, dev.bsk_ntt64)
