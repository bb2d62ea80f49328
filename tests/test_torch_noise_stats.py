"""Twin of tests/test_noise_stats.py on the port's ``pbs_batch``: the
decryption-failure count and the noise margin at PARAM_TEST_STAT
(production-relative LWE noise at CI dimensions).

The same seed (17), the same 2,048 samples through the same LUT and the
worst designed pack (4x + y of two bootstrapped values, bootstrapped
again): zero decode failures, nonzero fresh-PBS noise, and half a slot
above 7.04 sigma (a 2^-40 two-sided tail).  The first batch of 512 is
also held bit for bit against the JAX package's ``pbs_batch``.  On the
card, ``chip_smoke.py`` phase 23 runs 16,384 PARAM_PROD bootstraps in the
served mode the same way.
"""

import numpy as np
import torch

from fhestring_tpu import torus as jtorus
from fhestring_tpu.crypto import keys as dkeys
from fhestring_tpu.crypto import pbs as dpbs
from fhestring_tpu.numpy_ref import core as jref
from fhestring_tpu.params import PARAM_TEST_STAT as JP
from fhestring_tpu_torch import torus
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.numpy_ref import core as ref
from fhestring_tpu_torch.params import PARAM_TEST_STAT

N_SAMPLES = 2048
B = 512


def phase_errors(sk, cts, expected, p):
    """Each ciphertext's phase minus its encoded value, as a fraction of
    the torus (the JAX test's ``_phase_errors``)."""
    sk_bits = sk.big_lwe_sk.astype(np.uint64)
    a = cts[:, :-1].astype(np.uint64)
    b = cts[:, -1].astype(np.uint64)
    phase = b - (a * sk_bits[None, :]).sum(axis=1)  # uint64 wraps
    enc = expected.astype(np.uint64) * np.uint64(p.delta)
    err = (phase - enc).astype(np.float64)  # uint64 wraps
    err = np.where(err >= 2.0 ** 63, err - 2.0 ** 64, err)
    return err / 2.0 ** 64


def test_bootstrap_failure_rate_and_noise_margin():
    p = PARAM_TEST_STAT
    rng = np.random.default_rng(17)
    sk, srv = ref.keygen(p, rng)
    dev = keys.pack_server_keys(srv, "cpu")
    table = list(range(4)) * 4
    bank = keys.pack_luts([table], p, "cpu")

    failures = 0
    fresh = []
    for batch in range(N_SAMPLES // B):
        msgs = rng.integers(0, 4, size=B)
        cts = np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])
        host = torus.to_numpy(pbs.pbs_batch(
            torus.from_numpy(cts), torch.zeros(B, dtype=torch.int64), bank,
            dev))
        if batch == 0:
            jdev = dkeys.pack_server_keys(
                jref.ServerKeys(params=JP, bsk=srv.bsk, ksk=srv.ksk))
            want = jtorus.to_numpy(dpbs.pbs_batch(
                jtorus.from_numpy(cts), np.zeros(B, np.int32),
                dkeys.pack_luts([table], JP), jdev))
            np.testing.assert_array_equal(host, want)
        exp = np.array([table[m] for m in msgs])
        dec = np.array([ref.shortint_decrypt(sk, host[i]) for i in range(B)])
        failures += int((dec != exp).sum())
        fresh.append(phase_errors(sk, host, exp, p))

        # worst designed pack: 4x + y, then one more bootstrap
        half = B // 2
        packed = np.uint64(4) * host[:half] + host[half:]  # uint64 wraps
        pidx = (4 * exp[:half] + exp[half:]) % 16
        host2 = torus.to_numpy(pbs.pbs_batch(
            torus.from_numpy(packed), torch.zeros(half, dtype=torch.int64),
            bank, dev))
        exp2 = np.array([table[v] for v in pidx])
        dec2 = np.array([ref.shortint_decrypt(sk, host2[i])
                         for i in range(half)])
        failures += int((dec2 != exp2).sum())

    assert failures == 0, f"{failures} decode failures in {N_SAMPLES} samples"
    sigma = float(np.std(np.concatenate(fresh)))
    assert sigma > 0, "zero measured noise: stat params not applied?"
    half_slot = 1.0 / (2 * p.full_space)
    assert half_slot / sigma > 7.04, (sigma, half_slot)
