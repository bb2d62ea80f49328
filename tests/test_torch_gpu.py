"""The blind-rotation CUDA kernels on the card, against their plain
versions: blind_rotate32 (turbo) and blind_rotate64 (PARAM_PROD family, in
its exact, rounded, rounded + approx and approx modes).

These tests need a CUDA device and nvcc; without them they skip.  Run them
on a GPU machine with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (``--noconftest``: tests/conftest.py sets up
JAX, which the port does not need).  This file imports nothing of JAX.

Tolerance: zero.  The kernel, the plain version and the numpy oracle all
compute exact integer arithmetic, so outputs must be bit-identical.
"""

import numpy as np
import pytest
import torch

from fhestring_tpu_torch import (PARAM_TEST32_ZERO_NOISE,
                                 PARAM_TEST_ZERO_NOISE, metrics, shortint,
                                 torus)
from fhestring_tpu_torch.ciphertext import FheString, blocks_from_numpy, to_numpy
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.crypto.kernels import blind_rotate32 as br
from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br64
from fhestring_tpu_torch.crypto.kernels import cuda_build
from fhestring_tpu_torch.numpy_ref import core as ref

pytestmark = pytest.mark.gpu
P = PARAM_TEST32_ZERO_NOISE
P64 = PARAM_TEST_ZERO_NOISE
# (rounded, approx): exact, rounded, production, and approx alone
MODES = [(False, False), (True, False), (True, True), (False, True)]
MODE_IDS = ["exact", "rounded", "production", "approx"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_build.build("blind_rotate32", "blind_rotate64")
    br.build()
    br64.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def key_material(cuda):
    _, srv = ref.keygen(P, np.random.default_rng(11))
    return srv, keys.pack_server_keys(srv, cuda, params=P)


def _random_khat(gen, n_steps, n):
    kh = torch.cat([torch.randint(0, q, (n_steps, 1, 6, 8, n), generator=gen)
                    for q in (40961, 61441)], dim=1)
    return torch.where(kh >= 1 << 15, kh - (1 << 16), kh).to(torch.int16)


@pytest.mark.parametrize("B,n_steps,n", [(1, 3, 256), (33, 16, 256),
                                         (8, 12, 2048), (300, 4, 2048)])
def test_kernel_matches_plain(cuda, B, n_steps, n):
    gen = torch.Generator().manual_seed(B * n)
    acc = torch.randint(-2**31, 2**31, (B, 2, n), dtype=torch.int32,
                        generator=gen).to(cuda)
    amt = torch.randint(0, 2 * n, (B, n_steps), dtype=torch.int32,
                        generator=gen).to(cuda)
    khat = _random_khat(gen, n_steps, n).to(cuda)
    before = br.blind_rotate32.launches
    got = br.blind_rotate32(acc, amt, khat)
    torch.cuda.synchronize()
    assert br.blind_rotate32.launches == before + 1
    assert torch.equal(got, br.blind_rotate32_plain(acc, amt, khat))


def test_kernel_matches_oracle_with_real_keys(cuda, key_material):
    srv, dev = key_material
    rng = np.random.default_rng(2)
    B, N = 5, P.polynomial_size
    acc0 = rng.integers(0, 1 << 32, size=(B, 2, N),
                        dtype=np.uint64) << np.uint64(32)
    lwe = np.zeros((B, P.lwe_dimension + 1), np.int64)
    lwe[:, :-1] = rng.integers(0, 2 * N, size=(B, P.lwe_dimension))
    hi = br.blind_rotate32(torus.hi32(torus.from_numpy(acc0, cuda)),
                           torch.from_numpy(lwe[:, :-1].astype(np.int32)).to(cuda),
                           dev.bsk_ntt32)
    got = torus.to_numpy(torus.from_hi32(hi))
    for i in range(B):
        np.testing.assert_array_equal(got[i], ref.blind_rotate(acc0[i], lwe[i], srv))


@pytest.mark.parametrize("B", [5, 40])
def test_pbs_batch_cuda_equals_cpu(cuda, key_material, B):
    """B = 5 takes the keyswitch's row padding for _int_mm (> 16 rows)."""
    srv, dev = key_material
    cpu = keys.pack_server_keys(srv, "cpu", params=P)
    rng = np.random.default_rng(B)
    cts = rng.integers(0, 1 << 64, size=(B, P.big_lwe_dimension + 1),
                       dtype=np.uint64) & np.uint64(0xFFFFFFFF00000000)
    idx = torch.from_numpy(np.arange(B) % 2)
    tables = [[(3 * x + 1) % 16 for x in range(16)], list(range(16))]
    got = pbs.pbs_batch(torus.from_numpy(cts, cuda), idx.to(cuda),
                        keys.pack_luts(tables, P, cuda), dev)
    want = pbs.pbs_batch(torus.from_numpy(cts), idx,
                         keys.pack_luts(tables, P, "cpu"), cpu)
    np.testing.assert_array_equal(torus.to_numpy(got), torus.to_numpy(want))


def test_contains_on_cuda_equals_cpu(cuda):
    ck = ClientKey(P, seed=1)
    s, pat = ck.encrypt("hello", 1), ck.encrypt_no_padding("ll")
    cpu_out = ck.get_server_key("cpu").contains(s, pat)
    out = ck.get_server_key(cuda).contains(
        FheString(blocks_from_numpy(to_numpy(s.blocks), cuda)),
        FheString(blocks_from_numpy(to_numpy(pat.blocks), cuda)))
    assert torch.equal(out.blocks.ct.cpu(), cpu_out.blocks.ct)
    assert ck.decrypt_char(out) == 1


# ---------------------------------------------------------------------------
# blind_rotate64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def key_material64(cuda):
    _, srv = ref.keygen(P64, np.random.default_rng(12))
    return srv, keys.pack_server_keys(srv, cuda, params=P64)


def _random_khat64(gen, n_steps, n):
    kh = torch.cat([torch.randint(0, q, (n_steps, 1, 2, 16, n), generator=gen)
                    for q in (40961, 61441)], dim=1)
    return torch.where(kh >= 1 << 15, kh - (1 << 16), kh).to(torch.int16)


@pytest.mark.parametrize("rounded,approx", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("B,n_steps,n", [(1, 3, 256), (33, 5, 256),
                                         (8, 4, 2048), (7, 3, 2048),
                                         (300, 2, 2048)])
def test_kernel64_matches_plain(cuda, B, n_steps, n, rounded, approx):
    gen = torch.Generator().manual_seed(B * n + n_steps)
    acc = torch.randint(-2**63, 2**63 - 1, (B, 2, n), dtype=torch.int64,
                        generator=gen).to(cuda)
    amt = torch.randint(0, 2 * n, (B, n_steps), dtype=torch.int32,
                        generator=gen).to(cuda)
    khat = _random_khat64(gen, n_steps, n).to(cuda)
    before = br64.blind_rotate64.launches
    got = br64.blind_rotate64(acc, amt, khat, rounded=rounded, approx=approx)
    torch.cuda.synchronize()
    assert br64.blind_rotate64.launches == before + 1
    assert torch.equal(got, br64.blind_rotate64_plain(
        acc, amt, khat, rounded=rounded, approx=approx))


@pytest.mark.parametrize("rounded", [False, True], ids=["exact", "rounded"])
def test_kernel64_digit_boundaries(cuda, key_material64, rounded):
    """Accumulators whose digits sit at the rounding and sign boundaries
    (state 2^22 - 1, 2^22, 0, 2^23 - 1, with and without bit 40), rotated
    by a = N and by a = N + 1: kernel equal to the plain version."""
    _, dev = key_material64
    N = P64.polynomial_size
    tops = [(1 << 22) - 1, 1 << 22, 0, (1 << 23) - 1, 1, (1 << 22) + 1]
    lows = [0, 1 << 40, (1 << 40) - 1, (1 << 41) - 1, 1 << 39]
    vals = [((t << 41) | lo) % (1 << 64) for t in tops for lo in lows]
    vals = (vals * (2 * N // len(vals) + 1))[:2 * N]
    acc = torus.from_numpy(np.array(vals, np.uint64).reshape(1, 2, N), cuda)
    acc = torch.cat([acc, -acc])
    amt = torch.tensor([N, N + 1], dtype=torch.int32, device=cuda)
    amt = amt[:, None].expand(2, P64.lwe_dimension).contiguous()
    for approx in (False, True):
        got = br64.blind_rotate64(acc, amt, dev.bsk_ntt64, rounded=rounded,
                                  approx=approx)
        want = br64.blind_rotate64_plain(acc, amt, dev.bsk_ntt64,
                                         rounded=rounded, approx=approx)
        assert torch.equal(got, want)


@pytest.mark.parametrize("rounded,approx", MODES, ids=MODE_IDS)
def test_kernel64_matches_oracle_with_real_keys(cuda, key_material64,
                                                rounded, approx):
    srv, dev = key_material64
    rng = np.random.default_rng(3)
    B, N = 5, P64.polynomial_size
    acc0 = rng.integers(0, 1 << 64, size=(B, 2, N), dtype=np.uint64)
    lwe = np.zeros((B, P64.lwe_dimension + 1), np.int64)
    lwe[:, :-1] = rng.integers(0, 2 * N, size=(B, P64.lwe_dimension))
    got = torus.to_numpy(br64.blind_rotate64(
        torus.from_numpy(acc0, cuda),
        torch.from_numpy(lwe[:, :-1].astype(np.int32)).to(cuda),
        dev.bsk_ntt64, rounded=rounded, approx=approx))
    for i in range(B):
        np.testing.assert_array_equal(got[i], ref.blind_rotate(
            acc0[i], lwe[i], srv, rounded=rounded,
            min_shift=3 if approx else 0))


@pytest.mark.parametrize("B", [5, 40])
def test_pbs_batch64_cuda_equals_cpu_in_production_mode(cuda, key_material64,
                                                        B):
    """The production mode (rounded + approx) on the card equals the plain
    version in the same mode on CPU; B = 5 takes the keyswitch's row
    padding for _int_mm."""
    srv, dev = key_material64
    cpu = keys.pack_server_keys(srv, "cpu", params=P64)
    rng = np.random.default_rng(B)
    cts = rng.integers(0, 1 << 64, size=(B, P64.big_lwe_dimension + 1),
                       dtype=np.uint64)
    idx = torch.from_numpy(np.arange(B) % 2)
    tables = [[(3 * x + 1) % 16 for x in range(16)], list(range(16))]
    before = br64.blind_rotate64.launches
    got = pbs.pbs_batch(torus.from_numpy(cts, cuda), idx.to(cuda),
                        keys.pack_luts(tables, P64, cuda), dev,
                        rounded=True, approx=True)
    assert br64.blind_rotate64.launches == before + 1
    want = pbs.pbs_batch(torus.from_numpy(cts), idx,
                         keys.pack_luts(tables, P64, "cpu"), cpu,
                         rounded=True, approx=True)
    np.testing.assert_array_equal(torus.to_numpy(got), torus.to_numpy(want))


def test_contains64_on_cuda_equals_cpu_in_the_same_mode(cuda, monkeypatch):
    """ServerKey.contains on the card (which runs the production mode)
    equals the CPU plain version forced into the same mode, and launches
    the kernel once per PBS batch."""
    ck = ClientKey(P64, seed=1)
    s, pat = ck.encrypt("hello", 1), ck.encrypt_no_padding("ll")
    server = ck.get_server_key(cuda)
    before = br64.blind_rotate64.launches
    metrics.reset()
    out = server.contains(
        FheString(blocks_from_numpy(to_numpy(s.blocks), cuda)),
        FheString(blocks_from_numpy(to_numpy(pat.blocks), cuda)))
    torch.cuda.synchronize()
    batches = metrics.GLOBAL.pbs_calls
    assert batches > 0
    assert br64.blind_rotate64.launches == before + batches

    def production(*args, **kwargs):
        kwargs.update(rounded=True, approx=True)
        return pbs.pbs_batch(*args, **kwargs)

    monkeypatch.setattr(shortint, "pbs_batch", production)
    cpu_out = ck.get_server_key("cpu").contains(s, pat)
    assert torch.equal(out.blocks.ct.cpu(), cpu_out.blocks.ct)
    assert ck.decrypt_char(out) == 1
