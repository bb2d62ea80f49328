"""The twiddle table the CUDA kernels read (``ntt.kernel_twiddles``): each
twiddle with its Shoup quotient, and the lazy butterflies' bounds.

The kernels' transforms (``csrc/ntt64.cuh``) never reduce between stages;
these tests run the same arithmetic in numpy uint32/uint64 at every size
the wrappers accept and hold it equal to the plain version's transforms
(``ntt.ntt_fwd`` / ``ntt.ntt_inv``).  Tolerance: none, integers.
"""

import numpy as np
import pytest
import torch

from fhestring_tpu_torch.crypto import ntt

SIZES = [64, 128, 256, 512, 1024, 2048]
U32 = np.uint64(0xFFFFFFFF)


def _table(n):
    tw = ntt.kernel_twiddles(n, "cpu")
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (2, 2, n, 2)
    return tw.numpy().view(np.uint32).astype(np.uint64)


def _mul_shoup(y, w, wq, p):
    """y * w - mulhi(y, wq) * p in 32-bit words, as the kernel does."""
    return (y * w - ((y * wq) >> np.uint64(32)) * np.uint64(p)) & U32


@pytest.mark.parametrize("n", SIZES)
def test_kernel_twiddles_are_the_twiddles_with_shoup_quotients(n):
    table, tw = _table(n), ntt.twiddles(n)
    for pi, p in enumerate(ntt.PRIMES):
        w, wq = table[pi, ..., 0], table[pi, ..., 1]
        assert np.array_equal(w, tw[pi].astype(np.uint64))
        assert np.array_equal(wq, (w << np.uint64(32)) // np.uint64(p))


@pytest.mark.parametrize("n", [64, 2048])
def test_shoup_product_is_below_2p_for_any_word(n):
    table = _table(n)
    rng = np.random.default_rng(n)
    for pi, p in enumerate(ntt.PRIMES):
        w, wq = table[pi, 0, :, 0], table[pi, 0, :, 1]
        for y in (rng.integers(0, 1 << 32, n, dtype=np.uint64),
                  np.full(n, (1 << 32) - 1, np.uint64)):
            got = _mul_shoup(y, w, wq, p)
            assert int(got.max()) < 2 * p
            assert np.array_equal(got % np.uint64(p), y * w % np.uint64(p))


def _lazy_fwd(a, table, p, n):
    """Cooley-Tukey with u + t and u - t + 2p unreduced; returns the
    transform reduced at the end and the largest word met."""
    a, m, t, peak = a.copy(), 1, n >> 1, 0
    while m < n:
        for i in range(m):
            lo = slice(2 * i * t, 2 * i * t + t)
            hi = slice(2 * i * t + t, 2 * (i + 1) * t)
            v = _mul_shoup(a[hi], table[m + i, 0], table[m + i, 1], p)
            u = a[lo].copy()
            a[lo], a[hi] = u + v, u - v + np.uint64(2 * p)
        peak = max(peak, int(a.max()))
        m, t = 2 * m, t >> 1
    return a % np.uint64(p), peak


def _lazy_inv(a, table, p, n):
    """Gentleman-Sande with u + v unreduced and u - v offset by p << stage;
    the words stay below 2^32."""
    a, h, t, stage, peak = a.copy(), n >> 1, 1, 0, 0
    while h >= 1:
        bound = np.uint64(p << stage)
        for i in range(h):
            lo = slice(2 * i * t, 2 * i * t + t)
            hi = slice(2 * i * t + t, 2 * (i + 1) * t)
            u, v = a[lo].copy(), a[hi].copy()
            assert int(v.max()) < int(bound)
            a[lo] = u + v
            a[hi] = _mul_shoup(u - v + bound, table[h + i, 0],
                               table[h + i, 1], p)
        peak = max(peak, int(a.max()))
        h, t, stage = h >> 1, 2 * t, stage + 1
    return a % np.uint64(p), peak


@pytest.mark.parametrize("n", SIZES)
def test_lazy_transforms_equal_the_plain_versions(n):
    """Worst-case (all p - 1) and random inputs: no word overflows 32 bits
    and the reduced results are the plain transforms'."""
    table = _table(n)
    tw = torch.from_numpy(ntt.twiddles(n))
    rng = np.random.default_rng(n)
    for pi, p in enumerate(ntt.PRIMES):
        for a in (rng.integers(0, p, n, dtype=np.uint64),
                  np.full(n, p - 1, np.uint64)):
            x = torch.from_numpy(np.stack([a, a]).astype(np.int64))
            want_f = ntt.ntt_fwd(x[:, None], tw)[pi, 0].numpy()
            want_i = ntt.ntt_inv(x[:, None], tw)[pi, 0].numpy()
            got_f, peak_f = _lazy_fwd(a, table[pi, 0], p, n)
            got_i, peak_i = _lazy_inv(a, table[pi, 1], p, n)
            assert np.array_equal(got_f, want_f.astype(np.uint64))
            assert np.array_equal(got_i, want_i.astype(np.uint64))
            log_n = n.bit_length() - 1
            assert peak_f < (2 * log_n + 1) * p < 1 << 32
            assert peak_i < (p << log_n) < 1 << 32
