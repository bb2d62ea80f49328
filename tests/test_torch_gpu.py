"""The CUDA kernels on the card, against their plain versions:
blind_rotate32 (turbo), blind_rotate64 (PARAM_PROD family, in its exact,
rounded, rounded + approx and approx modes), each in every body (1 block
per item and clusters of 2, 4 and 8), and the step-wise 64-bit route's
rotate_decompose, ext_product and ntt_ext.

These tests need a CUDA device and nvcc; without them they skip.  Run them
on a GPU machine with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (``--noconftest``: tests/conftest.py sets up
JAX, which the port does not need).  This file imports nothing of JAX.

Tolerance: zero.  The kernel, the plain version and the numpy oracle all
compute exact integer arithmetic, so outputs must be bit-identical.
"""

import dataclasses
import gc

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
from fhestring_tpu_torch.crypto.kernels import ext_product as ep
from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne
from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd
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
    ck = ClientKey(P, seed=1, device="cpu")
    s, pat = ck.encrypt("hello", 1), ck.encrypt_no_padding("ll")
    cpu_out = ck.get_server_key(device="cpu").contains(s, pat)
    out = ck.get_server_key(device=cuda).contains(
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
    ck = ClientKey(P64, seed=1, device="cpu")
    s, pat = ck.encrypt("hello", 1), ck.encrypt_no_padding("ll")
    server = ck.get_server_key(device=cuda)
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
    cpu_out = ck.get_server_key(device="cpu").contains(s, pat)
    assert torch.equal(out.blocks.ct.cpu(), cpu_out.blocks.ct)
    assert ck.decrypt_char(out) == 1


# ---------------------------------------------------------------------------
# the bodies of blind_rotate32 and blind_rotate64: 1 block per item, and
# thread-block clusters of 2, 4 and 8 blocks per item
# ---------------------------------------------------------------------------

# Every n where the transforms split their stages otherwise (ntt64.cuh:
# splits): n = 64 and 128 run passes of 1 and 2 stages; from 128 on, the
# swizzle of the work buffers uses bits 5 and 6 of a coefficient's index.
# At N = 2048 the batches the 8-block body is picked for (1, 2, 3, 8, 15;
# one past a wave of 8-clusters: test_eight_blocks_one_past_a_wave).
BODY_SHAPES = [(1, 3, 64), (5, 3, 128), (5, 4, 256), (33, 3, 256),
               (3, 3, 512), (3, 3, 1024), (1, 3, 2048), (2, 3, 2048),
               (3, 3, 2048), (5, 3, 2048), (8, 3, 2048), (15, 3, 2048),
               (33, 2, 2048)]


def _boundary_amounts(gen, B, n_steps, n):
    """Random amounts; item 0 starts with 0, N and 2N - 1."""
    amt = torch.randint(0, 2 * n, (B, n_steps), dtype=torch.int32,
                        generator=gen)
    edge = torch.tensor([0, n, 2 * n - 1], dtype=torch.int32)[:n_steps]
    amt[0, :len(edge)] = edge
    return amt


@pytest.mark.parametrize("cluster", br.CLUSTERS)
@pytest.mark.parametrize("B,n_steps,n", BODY_SHAPES)
def test_every_body_of_kernel32_matches_plain(cuda, B, n_steps, n, cluster):
    gen = torch.Generator().manual_seed(B * n + cluster)
    acc = torch.randint(-2**31, 2**31, (B, 2, n), dtype=torch.int32,
                        generator=gen).to(cuda)
    amt = _boundary_amounts(gen, B, n_steps, n).to(cuda)
    khat = _random_khat(gen, n_steps, n).to(cuda)
    before = br.blind_rotate32.launches, br.blind_rotate32.bodies[cluster]
    got = br.blind_rotate32(acc, amt, khat, cluster=cluster)
    torch.cuda.synchronize()
    assert (br.blind_rotate32.launches,
            br.blind_rotate32.bodies[cluster]) == (before[0] + 1,
                                                   before[1] + 1)
    assert torch.equal(got, br.blind_rotate32_plain(acc, amt, khat))


@pytest.mark.parametrize("rounded,approx", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("cluster", br64.CLUSTERS)
@pytest.mark.parametrize("B,n_steps,n", BODY_SHAPES)
def test_every_body_of_kernel64_matches_plain(cuda, B, n_steps, n, cluster,
                                              rounded, approx):
    gen = torch.Generator().manual_seed(B * n + cluster)
    acc = torch.randint(-2**63, 2**63 - 1, (B, 2, n), dtype=torch.int64,
                        generator=gen).to(cuda)
    amt = _boundary_amounts(gen, B, n_steps, n).to(cuda)
    khat = _random_khat64(gen, n_steps, n).to(cuda)
    before = br64.blind_rotate64.launches, br64.blind_rotate64.bodies[cluster]
    got = br64.blind_rotate64(acc, amt, khat, rounded=rounded, approx=approx,
                              cluster=cluster)
    torch.cuda.synchronize()
    assert (br64.blind_rotate64.launches,
            br64.blind_rotate64.bodies[cluster]) == (before[0] + 1,
                                                     before[1] + 1)
    assert torch.equal(got, br64.blind_rotate64_plain(
        acc, amt, khat, rounded=rounded, approx=approx))


@pytest.mark.parametrize("rounded,approx", [(None, None)] + MODES,
                         ids=["k1"] + [f"k2-{m}" for m in MODE_IDS])
def test_eight_blocks_one_past_a_wave(cuda, rounded, approx):
    """The 8-block body at one item more than a wave of 8-clusters holds at
    N = 2048 (the card runs the last item's cluster after one of the first
    wave has ended), against the plain version, K1 and every mode of K2."""
    n, n_steps = 2048, 2
    gen = torch.Generator().manual_seed(8)
    amt_of = lambda B: _boundary_amounts(gen, B, n_steps, n).to(cuda)
    if rounded is None:
        B = br.max_active_clusters(0, 8, n) + 1
        acc = torch.randint(-2**31, 2**31, (B, 2, n), dtype=torch.int32,
                            generator=gen).to(cuda)
        amt, khat = amt_of(B), _random_khat(gen, n_steps, n).to(cuda)
        before = br.blind_rotate32.bodies[8]
        got = br.blind_rotate32(acc, amt, khat, cluster=8)
        torch.cuda.synchronize()
        assert br.blind_rotate32.bodies[8] == before + 1
        assert torch.equal(got, br.blind_rotate32_plain(acc, amt, khat))
        return
    B = br64.max_active_clusters(0, 8, n, rounded, approx) + 1
    acc = torch.randint(-2**63, 2**63 - 1, (B, 2, n), dtype=torch.int64,
                        generator=gen).to(cuda)
    amt, khat = amt_of(B), _random_khat64(gen, n_steps, n).to(cuda)
    before = br64.blind_rotate64.bodies[8]
    got = br64.blind_rotate64(acc, amt, khat, rounded=rounded, approx=approx,
                              cluster=8)
    torch.cuda.synchronize()
    assert br64.blind_rotate64.bodies[8] == before + 1
    assert torch.equal(got, br64.blind_rotate64_plain(
        acc, amt, khat, rounded=rounded, approx=approx))


@pytest.mark.parametrize("cluster", br64.CLUSTERS)
def test_every_body_matches_oracle_with_real_keys(cuda, key_material,
                                                  key_material64, cluster):
    """Each body over the whole rotation at the CI sets, against the numpy
    oracle: K1 exact, K2 in the production mode."""
    rng = np.random.default_rng(cluster)
    B = 3
    for params, (srv, dev), bits in ((P, key_material, 32),
                                     (P64, key_material64, 64)):
        N, n = params.polynomial_size, params.lwe_dimension
        acc0 = rng.integers(0, 1 << bits, size=(B, 2, N),
                            dtype=np.uint64) << np.uint64(64 - bits)
        lwe = np.zeros((B, n + 1), np.int64)
        lwe[:, :-1] = rng.integers(0, 2 * N, size=(B, n))
        amt = torch.from_numpy(lwe[:, :-1].astype(np.int32)).to(cuda)
        if bits == 32:
            hi = br.blind_rotate32(torus.hi32(torus.from_numpy(acc0, cuda)),
                                   amt, dev.bsk_ntt32, cluster=cluster)
            got, mode = torus.to_numpy(torus.from_hi32(hi)), {}
        else:
            got = torus.to_numpy(br64.blind_rotate64(
                torus.from_numpy(acc0, cuda), amt, dev.bsk_ntt64,
                rounded=True, approx=True, cluster=cluster))
            mode = dict(rounded=True, min_shift=3)
        for i in range(B):
            np.testing.assert_array_equal(
                got[i], ref.blind_rotate(acc0[i], lwe[i], srv, **mode))


@pytest.mark.parametrize("cluster", [2, 4])
def test_cluster_bodies_on_two_streams_at_once(cuda, cluster):
    """Two launches of a cluster body in flight on two streams, K1 on one
    and K2 on the other, then swapped bodies: clusters of different items
    and launches share no state."""
    n, n_steps, B = 2048, 24, 20
    gen = torch.Generator().manual_seed(cluster)
    acc32 = torch.randint(-2**31, 2**31, (B, 2, n), dtype=torch.int32,
                          generator=gen).to(cuda)
    acc64 = torch.randint(-2**63, 2**63 - 1, (B, 2, n), dtype=torch.int64,
                          generator=gen).to(cuda)
    amt = torch.randint(0, 2 * n, (B, n_steps), dtype=torch.int32,
                        generator=gen).to(cuda)
    kh32 = _random_khat(gen, n_steps, n).to(cuda)
    kh64 = _random_khat64(gen, n_steps, n).to(cuda)
    want32 = br.blind_rotate32_plain(acc32, amt, kh32)
    want64 = br64.blind_rotate64_plain(acc64, amt, kh64, rounded=True,
                                       approx=True)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for _ in range(3):
        with torch.cuda.stream(streams[0]):
            a = br.blind_rotate32(acc32, amt, kh32, cluster=cluster)
            c = br64.blind_rotate64(acc64, amt, kh64, rounded=True,
                                    approx=True, cluster=6 - cluster)
        with torch.cuda.stream(streams[1]):
            b = br64.blind_rotate64(acc64, amt, kh64, rounded=True,
                                    approx=True, cluster=cluster)
            d = br.blind_rotate32(acc32, amt, kh32, cluster=6 - cluster)
        got.append((a, b, c, d))
    torch.cuda.synchronize()
    for a, b, c, d in got:
        assert torch.equal(a, want32) and torch.equal(d, want32)
        assert torch.equal(b, want64) and torch.equal(c, want64)


def test_picked_body_is_the_wrappers_choice(cuda):
    """With cluster=None the wrapper runs the body ``pick_cluster`` names,
    and the card runs at least one cluster of each body at N=2048."""
    n, gen = 2048, torch.Generator().manual_seed(0)
    for c in br.CLUSTERS[1:]:
        assert br.max_active_clusters(0, c, n) >= 1
        assert br64.max_active_clusters(0, c, n, True, True) >= 1
        assert br64.max_active_clusters(0, c, n, False, False) >= 1
    for B in (1, 40, 140, 300):
        acc = torch.randint(-2**31, 2**31, (B, 2, n), dtype=torch.int32,
                            generator=gen).to(cuda)
        amt = torch.randint(0, 2 * n, (B, 2), dtype=torch.int32,
                            generator=gen).to(cuda)
        khat = _random_khat(gen, 2, n).to(cuda)
        want = br.pick_cluster(B, n, 0)
        before = br.blind_rotate32.bodies[want]
        br.blind_rotate32(acc, amt, khat)
        assert br.blind_rotate32.bodies[want] == before + 1


# ---------------------------------------------------------------------------
# the step-wise 64-bit route: rotate_decompose (K5), ext_product (K3),
# ntt_ext (K4)
# ---------------------------------------------------------------------------

STEPWISE = [rd.rotate_diff_decompose, ep.ext_product, ne.ntt_ext]


@pytest.fixture(scope="module")
def stepwise(cuda):
    cuda_build.build("rotate_decompose", "ext_product", "ntt_ext")
    rd.build()
    ep.build()
    ne.build()
    return cuda


def _launches():
    return [k.launches for k in STEPWISE]


@pytest.mark.parametrize("B,n_steps,n", [(1, 3, 256), (33, 5, 256),
                                         (8, 2, 2048), (32, 2, 2048),
                                         (33, 2, 2048), (99, 2, 2048)])
def test_stepwise_kernels_match_plain(stepwise, B, n_steps, n):
    """n_steps of K5, then K3 and K4 on its digits, each against its plain
    version, with K3 equal to K4 (both keys hold the same u64 values); the
    accumulator advances by the product, as in pbs._blind_rotate_stepwise.
    Step 0 takes the amounts 0, N and 2N - 1.  At N=2048 K3 takes 1, 2 or
    4 groups of 8 items per block as the batch grows (``pick_body``)."""
    gen = torch.Generator().manual_seed(B * n + n_steps)
    acc = torch.randint(-2**63, 2**63 - 1, (B, 2, n), dtype=torch.int64,
                        generator=gen).to(stepwise)
    amt = torch.randint(0, 2 * n, (n_steps, B), dtype=torch.int32,
                        generator=gen)
    amt[0, :3] = torch.tensor([0, n, 2 * n - 1], dtype=torch.int32)[:B]
    bsk = torch.randint(-2**63, 2**63 - 1, (n_steps, 2, 2, n),
                        dtype=torch.int64, generator=gen)
    limbs = keys.pack_bsk_limbs(bsk, stepwise)
    khat = keys.pack_bsk_hats(bsk, stepwise, keys.KEY_PLANES64)
    before = _launches()
    for j in range(n_steps):
        a = amt[j].to(stepwise)
        dl = rd.rotate_diff_decompose(acc, a)
        assert torch.equal(dl, rd.rotate_diff_decompose_plain(acc, a))
        ext = ep.ext_product(dl, limbs[j])
        assert torch.equal(ext, ep.ext_product_plain(dl, limbs[j]))
        ext4 = ne.ntt_ext(dl, khat[j])
        assert torch.equal(ext4, ne.ntt_ext_plain(dl, khat[j]))
        assert torch.equal(ext4, ext)
        acc = torus.add(acc, ext)
    torch.cuda.synchronize()
    assert _launches() == [b + n_steps for b in before]


def _k3_bodies(n):
    """Every groups at the smallest and the largest chunk that fits, each
    unsplit, split in two and split all the way."""
    out = []
    for groups in ep.GROUPS:
        fits = [c for c in (128, 256, 512, 1024, 2048)
                if c <= n and ep.shared_memory(groups, c) <= ep.SHARED_MEMORY]
        for chunk in {fits[0], fits[-1]}:
            out += [(groups, chunk, s) for s in {1, 2, 2 * n // chunk}]
    return out


@pytest.mark.parametrize("accumulate", [False, True],
                         ids=["fresh", "accumulate"])
@pytest.mark.parametrize("n", [128, 256, 2048])
def test_ext_product_every_body_matches_plain(stepwise, n, accumulate):
    """Each K3 body (groups of 8 items per block, chunk of digit indices,
    blocks that split them) against the plain version at B=99, which
    leaves the last group of every body partly filled; returning a fresh
    tensor, or adding into a given accumulator."""
    gen = torch.Generator().manual_seed(n)
    dl = torch.randint(-128, 128, (3, 99, 2 * n), dtype=torch.int8,
                       generator=gen).to(stepwise)
    bsk = torch.randint(-2**63, 2**63 - 1, (1, 2, 2, n), dtype=torch.int64,
                        generator=gen)
    start = torch.randint(-2**63, 2**63 - 1, (99, 2, n), dtype=torch.int64,
                          generator=gen).to(stepwise)
    limbs = keys.pack_bsk_limbs(bsk, stepwise)[0]
    want = ep.ext_product_plain(dl, limbs)
    bodies = _k3_bodies(n)
    before = ep.ext_product.launches
    for body in bodies:
        if accumulate:
            got = ep.ext_product(dl, limbs, out=start.clone(),
                                 accumulate=True, body=body)
            assert torch.equal(got, start + want), body
        else:
            assert torch.equal(ep.ext_product(dl, limbs, body=body),
                               want), body
    torch.cuda.synchronize()
    assert ep.ext_product.launches == before + len(bodies)


@pytest.mark.parametrize("B", [1, 5, 33, 67])
@pytest.mark.parametrize("n", [128, 2048])
def test_ext_product_matches_plain_at_the_worst_case(stepwise, n, B):
    """The picked body at B in {1, 5, 33, 67}: random inputs, and digit
    limbs and key limbs all -128, the largest int32 planes there are
    (2^27.6 at N=2048)."""
    gen = torch.Generator().manual_seed(n + B)
    dl = torch.randint(-128, 128, (3, B, 2 * n), dtype=torch.int8,
                       generator=gen).to(stepwise)
    bsk = torch.randint(-2**63, 2**63 - 1, (2, 2, 2, n), dtype=torch.int64,
                        generator=gen)
    all_min = (-128 * sum(256**i for i in range(8))) % (1 << 64)
    bsk[1] = torus.from_numpy(np.array([all_min], np.uint64))
    limbs = keys.pack_bsk_limbs(bsk, stepwise)
    assert bool((keys.doubled_limbs(limbs[1])[..., :n] == -128).all())
    assert torch.equal(ep.ext_product(dl, limbs[0]),
                       ep.ext_product_plain(dl, limbs[0]))
    dl.fill_(-128)
    assert torch.equal(ep.ext_product(dl, limbs[1]),
                       ep.ext_product_plain(dl, limbs[1]))


def _product(route):
    """The step loop's product kernel and its key field: K3 against
    bsk_limbs, K4 against bsk_ntt64."""
    return ((ne.ntt_ext, "bsk_ntt64") if route == "k4"
            else (ep.ext_product, "bsk_limbs"))


def _eager(acc, amt, key, product):
    """The step loop launched one kernel at a time (no graph)."""
    return pbs._run_steps(acc.clone(), amt.t().contiguous(), key, product)


def _stepwise_pbs(cts, idx, bank, dev, route):
    """``pbs_batch`` with the step loop of that route as its blind rotation
    (the body is folded into the accumulator, so the loop takes the mask
    amounts alone)."""
    p = dev.params
    lwe_2n = pbs.modswitch(pbs.keyswitch(cts, dev), p)
    acc = pbs.initial_acc(lwe_2n, idx, bank, p)
    amounts = lwe_2n[:, :p.lwe_dimension].to(torch.int32)
    product, field = _product(route)
    return pbs.sample_extract(pbs._blind_rotate_stepwise(
        acc, amounts, getattr(dev, field), product), p)


@pytest.mark.parametrize("B", [1, 5, 33])
@pytest.mark.parametrize("route", ["k3", "k4"])
def test_graph_replay_equals_the_eager_loop(stepwise, key_material64, B,
                                            route):
    """Two different inputs at one B through one cached graph, each equal
    to the eager loop on the card and to the CPU loop (a stale static
    buffer would show on the second); the replay counts n launches of K5
    and of the route's product kernel, the capture none."""
    srv, dev = key_material64
    cpu = keys.pack_server_keys(srv, "cpu", params=P64)
    n, N = P64.lwe_dimension, P64.polynomial_size
    product, field = _product(route)
    key = getattr(dev, field)
    gen = torch.Generator().manual_seed(B)
    graphs = len(pbs._STEP_GRAPHS)
    for turn in range(2):
        acc = torch.randint(-2**63, 2**63 - 1, (B, 2, N), dtype=torch.int64,
                            generator=gen)
        amt = torch.randint(0, 2 * N, (B, n), dtype=torch.int32,
                            generator=gen)
        before = (rd.rotate_diff_decompose.launches, product.launches)
        got = pbs._blind_rotate_stepwise(acc.to(stepwise), amt.to(stepwise),
                                         key, product)
        assert (rd.rotate_diff_decompose.launches,
                product.launches) == (before[0] + n, before[1] + n)
        assert torch.equal(got, _eager(acc.to(stepwise), amt.to(stepwise),
                                       key, product))
        assert torch.equal(got.cpu(), pbs._blind_rotate_stepwise(
            acc, amt, getattr(cpu, field), product))
        assert len(pbs._STEP_GRAPHS) == min(graphs + 1, pbs.STEP_GRAPHS_KEPT)


@pytest.mark.parametrize("n", [256, 2048])
def test_rotate_decompose_digit_boundaries(stepwise, n):
    """Accumulators whose differences put the digits on the rounding and
    sign boundaries (states 2^22 - 1, 2^22, 0, 2^23 - 1, with and without
    the round bit 40), rotated by 0, 1, N - 1, N, N + 1 and 2N - 1."""
    tops = [(1 << 22) - 1, 1 << 22, 0, (1 << 23) - 1, 1, (1 << 22) + 1]
    lows = [0, 1 << 40, (1 << 40) - 1, (1 << 41) - 1, 1 << 39]
    vals = [((t << 41) | lo) % (1 << 64) for t in tops for lo in lows]
    vals = (vals * (2 * n // len(vals) + 1))[:2 * n]
    acc = torus.from_numpy(np.array(vals, np.uint64).reshape(1, 2, n),
                           stepwise)
    amounts = [0, 1, n - 1, n, n + 1, 2 * n - 1]
    acc = torch.cat([acc, -acc] * 3)
    amt = torch.tensor(amounts, dtype=torch.int32, device=stepwise)
    got = rd.rotate_diff_decompose(acc, amt)
    assert torch.equal(got, rd.rotate_diff_decompose_plain(acc, amt))
    digits = (got[0].long() + 256 * got[1].long() + 65536 * got[2].long())
    assert int(digits.min()) >= -(1 << 22) and int(digits.max()) < 1 << 22


@pytest.mark.parametrize("B", [5, 40])
@pytest.mark.parametrize("route", ["k3", "k4"])
def test_stepwise_pbs_batch_cuda_equals_cpu(stepwise, key_material64, B,
                                            route):
    """A bootstrap through each step-wise route on the card equals the
    same route on CPU and K2's exact mode on the card; n launches of K5
    and of the route's product kernel.  The K3 route is pbs_batch's on a
    key packed without its NTT-domain key; the K4 route is the step loop
    called directly."""
    srv, dev = key_material64
    cpu = keys.pack_server_keys(srv, "cpu", params=P64)
    rng = np.random.default_rng(B)
    cts = rng.integers(0, 1 << 64, size=(B, P64.big_lwe_dimension + 1),
                       dtype=np.uint64)
    idx = torch.from_numpy(np.arange(B) % 2)
    tables = [[(3 * x + 1) % 16 for x in range(16)], list(range(16))]
    product = _product(route)[0]
    card_args = (torus.from_numpy(cts, stepwise), idx.to(stepwise),
                 keys.pack_luts(tables, P64, stepwise))
    cpu_args = (torus.from_numpy(cts), idx, keys.pack_luts(tables, P64, "cpu"))
    before = (rd.rotate_diff_decompose.launches, product.launches)
    if route == "k3":
        got = pbs.pbs_batch(*card_args, keys.pack_server_keys(
            srv, stepwise, params=P64, with_ntt2=False))
    else:
        got = _stepwise_pbs(*card_args, dev, route)
    n = P64.lwe_dimension
    assert (rd.rotate_diff_decompose.launches,
            product.launches) == (before[0] + n, before[1] + n)
    whole = pbs.pbs_batch(*card_args, dev)
    want = _stepwise_pbs(*cpu_args, cpu, route)
    np.testing.assert_array_equal(torus.to_numpy(got), torus.to_numpy(want))
    np.testing.assert_array_equal(torus.to_numpy(whole), torus.to_numpy(want))


def test_contains_without_ntt_key_on_cuda_equals_cpu(stepwise):
    """A ServerKey packed with with_ntt2=False serves contains through K5 +
    K3 on the card (n launches of each per PBS batch, no K2), equal to the
    CPU path on the same keys; both run exact."""
    ck = ClientKey(P64, seed=1, device="cpu")
    s, pat = ck.encrypt("hello", 1), ck.encrypt_no_padding("ll")
    server = ck.get_server_key(with_ntt2=False, device=stepwise)
    assert server.backend.sc.keys.bsk_ntt64 is None
    before = (rd.rotate_diff_decompose.launches, ep.ext_product.launches,
              br64.blind_rotate64.launches)
    metrics.reset()
    out = server.contains(
        FheString(blocks_from_numpy(to_numpy(s.blocks), stepwise)),
        FheString(blocks_from_numpy(to_numpy(pat.blocks), stepwise)))
    torch.cuda.synchronize()
    steps = P64.lwe_dimension * metrics.GLOBAL.pbs_calls
    assert steps > 0
    assert (rd.rotate_diff_decompose.launches, ep.ext_product.launches,
            br64.blind_rotate64.launches) == (before[0] + steps,
                                              before[1] + steps, before[2])
    cpu_out = ck.get_server_key(with_ntt2=False, device="cpu").contains(s, pat)
    assert torch.equal(out.blocks.ct.cpu(), cpu_out.blocks.ct)
    assert ck.decrypt_char(out) == 1


# ---------------------------------------------------------------------------
# K4's cluster bodies, the step loop's graph, the CLI
# ---------------------------------------------------------------------------

STEP_SIZES = [128, 256, 512, 1024, 2048]
STEP_BATCHES = [1, 5, 8, 15, 33, 99]


def _step_case(n, B, steps, dev):
    gen = torch.Generator().manual_seed(7 * n + B)
    acc = torch.randint(-2**63, 2**63 - 1, (B, 2, n), dtype=torch.int64,
                        generator=gen).to(dev)
    amt = torch.randint(0, 2 * n, (steps, B), dtype=torch.int32,
                        generator=gen)
    amt[:3, 0] = torch.tensor([0, n, 2 * n - 1], dtype=torch.int32)[:steps]
    bsk = torch.randint(-2**63, 2**63 - 1, (steps, 2, 2, n),
                        dtype=torch.int64, generator=gen)
    return acc, amt.to(dev), bsk


@pytest.mark.parametrize("cluster", ne.CLUSTERS)
@pytest.mark.parametrize("B", STEP_BATCHES)
@pytest.mark.parametrize("n", [64] + STEP_SIZES)
def test_ntt_ext_every_body_matches_plain_and_k3(stepwise, n, B, cluster):
    """Each body of K4, returning a fresh tensor and adding into the
    accumulator, against the one-block body (held to the plain version at
    small sizes) and, from N = 128 on, against K3."""
    acc, amt, bsk = _step_case(n, B, 1, stepwise)
    khat = keys.pack_bsk_hats(bsk, stepwise, keys.KEY_PLANES64)[0]
    dl = rd.rotate_diff_decompose(acc, amt[0])
    want = (ne.ntt_ext_plain(dl, khat) if n <= 256 or B <= 8
            else ne.ntt_ext(dl, khat, cluster=1))
    before = dict(ne.ntt_ext.bodies)
    got = ne.ntt_ext(dl, khat, cluster=cluster)
    assert torch.equal(got, want)
    added = acc.clone()
    assert ne.ntt_ext(dl, khat, out=added, accumulate=True,
                      cluster=cluster) is added
    assert torch.equal(added, acc + want)
    assert ne.ntt_ext.bodies[cluster] == before[cluster] + 2
    if n >= ep.MIN_N:
        assert torch.equal(
            ep.ext_product(dl, keys.pack_bsk_limbs(bsk, stepwise)[0]), want)


@pytest.mark.parametrize("route", ["k3", "k4"])
def test_step_graph_equals_the_eager_loop_on_both_routes(
        stepwise, key_material64, route):
    """The step loop's graph on each route, two inputs through one cached
    graph, against the eager loop and K2's exact mode; a replay counts n
    launches of K5 and n of the route's product kernel (K4: under the body
    the wrapper picks)."""
    _, dev = key_material64
    n, N = P64.lwe_dimension, P64.polynomial_size
    product, field = _product(route)
    key = getattr(dev, field)
    gen = torch.Generator().manual_seed(3)
    for turn in range(2):
        acc = torch.randint(-2**63, 2**63 - 1, (5, 2, N), dtype=torch.int64,
                            generator=gen).to(stepwise)
        amt = torch.randint(0, 2 * N, (5, n), dtype=torch.int32,
                            generator=gen).to(stepwise)
        before = (rd.rotate_diff_decompose.launches, product.launches,
                  dict(ne.ntt_ext.bodies))
        got = pbs._blind_rotate_stepwise(acc, amt, key, product)
        assert (rd.rotate_diff_decompose.launches - before[0],
                product.launches - before[1]) == (n, n)
        picked = ne.pick_cluster(5, N, stepwise.index or 0)
        assert ne.ntt_ext.bodies == {
            c: before[2][c] + (n if route == "k4" and c == picked else 0)
            for c in ne.CLUSTERS}
        assert torch.equal(got, _eager(acc, amt, key, product))
        assert torch.equal(got, br64.blind_rotate64(acc, amt, dev.bsk_ntt64))


def test_cli_on_the_card_passes_a_handful(cuda, capsys):
    """The ported CLI at its default device, on the 64-bit CI set: one
    variant of each family passes against Python's str."""
    from fhestring_tpu_torch import cli

    methods = ["Contains", "Find", "ReplaceN", "RsplitOnce", "SplitClear",
               "StripPrefix", "TrimStart", "Repeat", "Lt"]
    rc = cli.main(["--string", "hello world", "--pattern", "ello", "--n", "2",
                   "--from", "o", "--to", "0", "--params", "test",
                   "--metrics", "--methods", *methods])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[-1] == f"{len(methods)}/{len(methods)} methods passed"
    assert sum(ln.startswith("Test Passed: OK") for ln in out) == len(methods)


# ---------------------------------------------------------------------------
# the 32-bit limb route, and a packed key saved and loaded
# ---------------------------------------------------------------------------

def _random_cts(p, B, seed):
    rng = np.random.default_rng(seed)
    cts = rng.integers(0, 1 << 64, size=(B, p.big_lwe_dimension + 1),
                       dtype=np.uint64)
    if p.torus_bits == 32:
        cts &= np.uint64(0xFFFFFFFF00000000)
    return cts, torch.from_numpy(np.arange(B) % 2)


TABLES = [[(3 * x + 1) % 16 for x in range(16)], list(range(16))]


@pytest.mark.parametrize("B", [5, 40])
def test_32bit_limb_route_cuda_equals_cpu(stepwise, key_material, B):
    """A 32-bit key packed with_ntt2=False on the card: pbs_batch through
    its route (digits in torch ops, one K3 per gadget level, replayed from
    the step graph) equals the same route on CPU, the eager loop on the
    card and K1 on the card; 3n launches of K3, none of K5."""
    srv, dev = key_material
    limbs = keys.pack_server_keys(srv, stepwise, params=P, with_ntt2=False)
    cpu = keys.pack_server_keys(srv, "cpu", params=P, with_ntt2=False)
    cts, idx = _random_cts(P, B, B)
    before = (rd.rotate_diff_decompose.launches, ep.ext_product.launches)
    got = pbs.pbs_batch(torus.from_numpy(cts, stepwise), idx.to(stepwise),
                        keys.pack_luts(TABLES, P, stepwise), limbs,
                        *pbs.served_mode(limbs, stepwise))
    n = P.lwe_dimension
    assert (rd.rotate_diff_decompose.launches,
            ep.ext_product.launches) == (before[0], before[1] + 3 * n)
    whole = pbs.pbs_batch(torus.from_numpy(cts, stepwise), idx.to(stepwise),
                          keys.pack_luts(TABLES, P, stepwise), dev)
    want = pbs.pbs_batch(torus.from_numpy(cts), idx,
                         keys.pack_luts(TABLES, P, "cpu"), cpu)
    np.testing.assert_array_equal(torus.to_numpy(got), torus.to_numpy(want))
    np.testing.assert_array_equal(torus.to_numpy(whole), torus.to_numpy(want))
    acc = torch.randint(-2**63, 2**63 - 1, (B, 2, P.polynomial_size),
                        dtype=torch.int64) & ~0xFFFFFFFF
    amt = torch.randint(0, 2 * P.polynomial_size, (B, n), dtype=torch.int32)
    graphed = pbs._blind_rotate_stepwise(acc.to(stepwise), amt.to(stepwise),
                                         limbs.bsk_limbs, ep.ext_product)
    eager = _eager(acc.to(stepwise), amt.to(stepwise), limbs.bsk_limbs,
                   ep.ext_product)
    assert torch.equal(graphed, eager)
    assert torch.equal(graphed.cpu(), pbs._blind_rotate_stepwise(
        acc, amt, cpu.bsk_limbs, ep.ext_product))


@pytest.mark.parametrize("with_ntt2", [True, False], ids=["ntt", "no_ntt"])
@pytest.mark.parametrize("params", [P, P64], ids=lambda p: p.name)
def test_packed_key_round_trip_on_the_card(stepwise, tmp_path, params,
                                           with_ntt2):
    """A server key packed on the card, saved and loaded onto the card:
    the same device keys, and the same bits of to_upper; a second
    get_server_key(cache_path=) is a hit."""
    from fhestring_tpu_torch import serialize

    ck = ClientKey(params, seed=4, device=stepwise)
    path = str(tmp_path / "packed.npz")
    srv = ck.get_server_key(with_ntt2, path)
    loaded = serialize.load_packed_server_key(path, device=stepwise)
    for field in ("bsk_limbs", "ksk_limbs", "bsk_ntt32", "bsk_ntt64"):
        a = getattr(loaded.backend.sc.keys, field)
        b = getattr(srv.backend.sc.keys, field)
        assert (a is None) == (b is None), field
        assert a is None or (a.is_cuda and torch.equal(a, b)), field
    s = ck.encrypt("Hi", 1)
    out = loaded.to_upper(s)
    assert torch.equal(out.blocks.ct, srv.to_upper(s).blocks.ct)
    assert ck.decrypt(out) == "HI"
    hit = ck.get_server_key(with_ntt2, path)
    assert torch.equal(hit.backend.sc.keys.ksk_limbs,
                       srv.backend.sc.keys.ksk_limbs)


# ---------------------------------------------------------------------------
# Sharding over torch.distributed ranks on the card (parallel.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [0, 1], ids=["col0", "col1"])
@pytest.mark.parametrize("B", [8, 99])
@pytest.mark.parametrize("n", [128, 2048])
def test_ext_product_column_shard_in_every_body(stepwise, n, B, cols):
    """K3 on a one-column shard of the key (the key-sharded blind
    rotation's ``bsk_limbs[:, :, cols]``), in the picked body and every
    body of ``_k3_bodies``: those columns of the full product, bit for
    bit, fresh and adding into an accumulator."""
    gen = torch.Generator().manual_seed(n + B + cols)
    dl = torch.randint(-128, 128, (3, B, 2 * n), dtype=torch.int8,
                       generator=gen).to(stepwise)
    bsk = torch.randint(-2**63, 2**63 - 1, (1, 2, 2, n), dtype=torch.int64,
                        generator=gen)
    limbs = keys.pack_bsk_limbs(bsk, stepwise)[0]
    shard = limbs[:, cols:cols + 1].contiguous()
    want = ep.ext_product_plain(dl, limbs)[:, cols:cols + 1]
    start = torch.randint(-2**63, 2**63 - 1, (B, 1, n), dtype=torch.int64,
                          generator=gen).to(stepwise)
    for body in [None] + _k3_bodies(n):
        assert torch.equal(ep.ext_product(dl, shard, body=body), want), body
        acc = start.clone()
        ep.ext_product(dl, shard, out=acc, accumulate=True, body=body)
        assert torch.equal(acc, torus.add(start, want)), body
    torch.cuda.synchronize()


def _pbs_call(fn, key_path, cts, table, **mode):
    return (fn, (key_path, cts, np.zeros(len(cts), np.int64), [table]),
            mode)


def test_sharded_pbs_over_two_gloo_ranks_on_the_card(stepwise, key_material,
                                                     key_material64,
                                                     tmp_path):
    """Two gloo ranks sharing the card: the batch-sharded PBS at both CI
    sets (PARAM_TEST_ZERO_NOISE in the served mode, rounded + approx) and
    the key-sharded PBS (exact) are bit-identical to one process's
    pbs_batch in the same mode; the polynomial-sharded forward transform
    to the numpy plan; the lane-sharded contains decrypts.  Between them
    the ranks pass CUDA tensors through gloo's all_gather, all_reduce,
    all_to_all and broadcast; each rank ran its kernels."""
    from fhestring_tpu_torch import dryrun, parallel, serialize
    from fhestring_tpu_torch.crypto import ntt_plan
    from fhestring_tpu_torch.server import ServerKey

    table = [(5 * m + 2) % 16 for m in range(16)]
    rng = np.random.default_rng(21)
    sk32, _ = ref.keygen(P, np.random.default_rng(11))
    sk64, _ = ref.keygen(P64, np.random.default_rng(12))
    cts32 = np.stack([ref.shortint_encrypt(sk32, int(m), rng)
                      for m in rng.integers(0, 16, size=5)])
    cts64 = np.stack([ref.shortint_encrypt(sk64, int(m), rng)
                      for m in rng.integers(0, 16, size=8)])
    x = rng.integers(-127, 128, size=(3, 2048)).astype(np.int32)
    path32, path64 = str(tmp_path / "k32.npz"), str(tmp_path / "k64.npz")
    serialize.save_packed_server_key(path32, ServerKey(key_material[1], P))
    serialize.save_packed_server_key(path64,
                                     ServerKey(key_material64[1], P64))
    calls = [_pbs_call(dryrun.batch_sharded, path32, cts32, table),
             _pbs_call(dryrun.batch_sharded, path64, cts64, table,
                       rounded=True, approx=True),
             (dryrun.poly_sharded, (parallel.ntt_fwd_poly_sharded, x),
              dict(n_poly=2048, prime=40961)),
             (dryrun.lane_sharded_contains,
              (P64, 9, "Hi there", "the", 2), {}),
             _pbs_call(dryrun.key_sharded, path64, cts64, table)]
    recs = parallel.run_ranks(2, dryrun.in_turn, calls, device="cuda",
                              timeout=300.0)
    bank32 = keys.pack_luts([table], P, stepwise)
    bank64 = keys.pack_luts([table], P64, stepwise)
    idx = torch.zeros(8, dtype=torch.int64, device=stepwise)
    want = [
        pbs.pbs_batch(torus.from_numpy(cts32, stepwise), idx[:5], bank32,
                      key_material[1]),
        pbs.pbs_batch(torus.from_numpy(cts64, stepwise), idx, bank64,
                      key_material64[1], rounded=True, approx=True),
        None, None,
        pbs.pbs_batch(torus.from_numpy(cts64, stepwise), idx, bank64,
                      key_material64[1])]
    plan = ntt_plan.make_neg_plan(40961, 2048)
    for rank in recs:
        for i in (0, 1, 4):
            np.testing.assert_array_equal(rank[i]["out"],
                                          torus.to_numpy(want[i]))
        np.testing.assert_array_equal(rank[2]["out"],
                                      ntt_plan.neg_fwd(x, plan))
        assert rank[0]["launches"]["blind_rotate32"] == 1
        assert rank[1]["launches"]["blind_rotate64"] == 1
        assert rank[4]["launches"]["rotate_decompose"] == P64.lwe_dimension
        assert rank[4]["launches"]["ext_product"] == P64.lwe_dimension
        assert set(rank[4]["step_parts"]) == {"kernels", "all_gather", "add"}
    assert recs[0][3]["result"] == 1


def test_nccl_refuses_two_ranks_on_one_card(stepwise):
    """NCCL takes one card a rank: two ranks on one card fail at their
    first collective (ncclInvalidUsage), which is why two ranks share the
    card over gloo.  One NCCL rank runs the sharded functions."""
    from fhestring_tpu_torch import dryrun, parallel
    from fhestring_tpu_torch.crypto import ntt_plan

    x = np.random.default_rng(3).integers(-127, 128, size=(2, 2048)).astype(
        np.int32)
    calls = [(dryrun.poly_sharded, (parallel.ntt_fwd_poly_sharded, x),
              dict(n_poly=2048, prime=40961))]
    got = parallel.run_ranks(1, dryrun.in_turn, calls, backend="nccl",
                             device="cuda", timeout=120.0)
    np.testing.assert_array_equal(
        got[0][0]["out"],
        ntt_plan.neg_fwd(x, ntt_plan.make_neg_plan(40961, 2048)))
    if torch.cuda.device_count() == 1:
        with pytest.raises(parallel.RankError):
            parallel.run_ranks(2, dryrun.in_turn, calls, backend="nccl",
                               device="cuda", timeout=120.0)


# ---------------------------------------------------------------------------
# the span recorder on the card
# ---------------------------------------------------------------------------

def test_span_holds_its_kernel_on_the_trace_clock(cuda):
    """A span around a K1 launch and a synchronise holds the kernel's
    interval in a torch.profiler trace, mapped with the benchmark's offset
    (``time.time_ns() - time.perf_counter_ns()``), within 1 ms at each end,
    for each of five launches in one trace.  On an H100 the profiler's
    device timestamps wander from the host's clock within a session
    (-0.29 to +0.48 ms seen), so the two clocks agree to 1 ms, not to
    50 us."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(5)
    acc = torch.randint(-2**31, 2**31, (8, 2, 2048), dtype=torch.int32,
                        generator=gen).to(cuda)
    amt = torch.randint(0, 4096, (8, 64), dtype=torch.int32,
                        generator=gen).to(cuda)
    khat = _random_khat(gen, 64, 2048).to(cuda)
    br.blind_rotate32(acc, amt, khat, cluster=1)
    torch.cuda.synchronize()
    metrics.reset()
    prof = profile(activities=[ProfilerActivity.CUDA])
    offset = time.time_ns() - time.perf_counter_ns()
    prof.start()
    metrics.record_spans(True)
    try:
        for _ in range(5):
            with metrics.span("k1"):
                br.blind_rotate32(acc, amt, khat, cluster=1)
                torch.cuda.synchronize()
    finally:
        metrics.record_spans(False)
        prof.stop()
    spans = metrics.spans()
    metrics.reset()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA
                     and "blind_rotate32" in e.name())
    assert len(spans) == len(kernels) == 5
    ends = []   # (kernel start - span start, span end - kernel end), ns
    for span, (k0, k1) in zip(spans, kernels):
        s0, s1 = span.t0_ns + offset, span.t1_ns + offset
        print(f"\nclock: kernel {(k1 - k0) / 1e3:.1f} us, span "
              f"{(s1 - s0) / 1e3:.1f} us; kernel start - span start "
              f"{(k0 - s0) / 1e3:.1f} us, span end - kernel end "
              f"{(s1 - k1) / 1e3:.1f} us")
        ends.append((k0 - s0, s1 - k1))
    assert all(abs(e) <= 1_000_000 for pair in ends for e in pair), ends


# The methods of the benchmark's three mixes, each with its arguments ("s"
# the string, "p" an encrypted pattern, "t" an encrypted string, else a
# clear argument) and its copies of plain data onto the card a request
# (``host_copies``; the CPU counts the same, tests/test_torch_tracing.py).
MIX_METHODS = {
    # interactive
    "contains": ("sp", 2), "contains_clear": (("s", "lo"), 3),
    "find": ("sp", 9), "starts_with_clear": (("s", "he"), 4),
    "eq": ("st", 7), "to_upper": ("s", 0), "len": ("s", 2),
    "strip_prefix_clear": (("s", "he"), 23),
    # bulk, beside contains, contains_clear and find
    "replace_clear": (("s", "l", "L"), 26), "to_lower": ("s", 0),
    "ends_with_clear": (("s", "lo"), 3),
    # split
    "split": ("sp", 52), "split_clear": (("s", "l"), 53),
    "rsplit": ("sp", 52), "rsplit_clear": (("s", "l"), 53),
}


@pytest.fixture(scope="module", params=[P, P64], ids=lambda p: p.name)
def served(request, cuda):
    ck = ClientKey(request.param, seed=41, device=cuda)
    return ck, ck.get_server_key()


def _result_tensors(obj):
    """Every ciphertext tensor of a method's result, in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in _result_tensors(getattr(obj, f.name))]
    return []


@pytest.mark.parametrize("method", sorted(MIX_METHODS))
def test_methods_do_not_wait_on_the_card(served, method):
    """Under ``set_sync_debug_mode("error")`` a warm request of each method
    of the three mixes runs from its start to its return without a call
    that synchronises the card: its copies of plain data go asynchronously
    (``host_copies`` as many as before, ``blocking_copies`` none) and
    ``FheBackend.take`` reads no index back.  The result is bit-equal to
    the same request with the debug mode off."""
    ck, srv = served
    text = {"s": ck.encrypt("hello", 1), "p": ck.encrypt_no_padding("ll"),
            "t": ck.encrypt("help", 1)}
    spec, copies = MIX_METHODS[method]
    args = [text[a] if a in text else a for a in spec]
    want = getattr(srv, method)(*args)   # warm: LUT banks, kernels loaded
    torch.cuda.synchronize()
    before = metrics.GLOBAL.snapshot()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = getattr(srv, method)(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    d = metrics.GLOBAL.delta(before)
    assert (d.host_copies, d.blocking_copies) == (copies, 0)
    got, want = _result_tensors(got), _result_tensors(want)
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_copies_survive_their_sources(cuda):
    """Each source array is overwritten and dropped as soon as
    ``torus.to_device`` returns, while a long kernel keeps the stream busy,
    and fresh page-locked blocks of the same sizes are filled with junk
    meanwhile: the copies read back as the sources were, and the host
    returned before the stream drained."""
    rng = np.random.default_rng(18)
    made = [rng.integers(-2**62, 2**62, size=(33, 7)),       # LUT indices
            rng.integers(0, 2, size=(5, 9, 1, 1)).astype(bool),  # masks
            rng.integers(0, 2**63, size=(4, 3, 2049), dtype=np.uint64)]
    want = [a.copy() for a in made]
    torch.cuda.synchronize()
    before = metrics.GLOBAL.snapshot()
    torch.cuda._sleep(2_000_000_000)     # about a second on an H100
    outs = []
    for arr in made:
        src = (torus.from_numpy(arr) if arr.dtype == np.uint64
               else torch.from_numpy(arr))
        outs.append(torus.to_device(src, cuda))
        arr[...] = ~arr
        del src
    made.clear()
    gc.collect()
    junk = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True).fill_(1)
            for o in outs]
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    del junk
    d = metrics.GLOBAL.delta(before)
    assert busy, "to_device waited for the stream"
    assert (d.host_copies, d.blocking_copies) == (3, 0)
    assert np.array_equal(torus.to_numpy(outs[2]), want[2])
    for out, w in zip(outs[:2], want[:2]):
        assert np.array_equal(out.cpu().numpy(), w)


def test_the_service_copies_up_without_waiting_and_reads_back_asleep(cuda):
    """While a long kernel keeps the stream busy, the service's decode of a
    received ciphertext returns before the stream drains, and a read-back
    of a result waits for the card with its thread asleep (its CPU time a
    small part of the wait, where a spinning synchronise would take the
    whole); both give the bits they were given."""
    import time

    from fhestring_tpu_torch import service
    rng = np.random.default_rng(20)
    arr = rng.integers(0, 2**63, size=(6, 4, 2049), dtype=np.uint64)
    blob = service._ct_to_bytes(shortint.Blocks(torus.from_numpy(arr), 3,
                                                1.0))
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)     # about a second on an H100
    got = service._ct_from_bytes(blob, cuda)
    busy = not torch.cuda.current_stream().query()
    assert busy, "the decode waited for the stream"
    assert got.ct.device.type == "cuda"
    torch.cuda._sleep(2_000_000_000)
    cpu0, wall0 = time.thread_time(), time.perf_counter()
    back = torus.to_numpy(got.ct)
    cpu, wall = time.thread_time() - cpu0, time.perf_counter() - wall0
    assert wall > 0.3, wall
    assert cpu < 0.2 * wall, (cpu, wall)
    assert np.array_equal(back, arr)


# (method, string, pattern or clear argument, Python's answer), one a client
SERVED_TOGETHER = [
    ("contains", "hello", "ll", 1), ("contains_clear", "abc", "z", 0),
    ("find", "abcab", "ca", 2), ("starts_with_clear", "hey you", "he", 1),
    ("eq", "same", "same", 1), ("to_upper", "aZ.q", None, "AZ.Q"),
    ("len", "four", None, 4), ("strip_prefix_clear", "abc", "a", ("bc", 1)),
]


def test_concurrent_requests_get_their_own_bits(served):
    """8 clients of one server at once, their first batches held until all
    have posted: each result is bit-identical to the same request served
    alone on the card and decrypts to Python's answer, and their batches
    went to the card merged."""
    import threading
    import time

    from fhestring_tpu_torch.service import FheStringServer, RemoteServerKey

    ck, srv = served

    def args(method, string, arg):
        s = ck.encrypt(string, 1)
        if arg is None:
            return (s,)
        if method in ("contains", "find"):
            return (s, ck.encrypt_no_padding(arg))
        if method == "eq":
            return (s, ck.encrypt(arg, 1))
        return (s, arg)
    calls = [(m, args(m, s, a)) for m, s, a, _ in SERVED_TOGETHER]
    alone = [_result_tensors(getattr(srv, m)(*a)) for m, a in calls]
    torch.cuda.synchronize()
    batches = srv.backend.sc.batches
    before = metrics.GLOBAL.snapshot()
    server = FheStringServer(srv).start()
    got = [None] * len(calls)

    def client(i, method, a):
        remote = RemoteServerKey(server.address, device="cpu", timeout=300)
        got[i] = getattr(remote, method)(*a)
    threads = [threading.Thread(target=client, args=(i, m, a), daemon=True)
               for i, (m, a) in enumerate(calls)]
    batches.enter()
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        while len(batches._pending) < len(calls):
            assert time.monotonic() < deadline, "the clients did not post"
            time.sleep(0.001)
    finally:
        batches.leave()
    try:
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
    d = metrics.GLOBAL.delta(before)
    assert d.pbs_posts > d.pbs_calls > 0
    for (method, *_, want), a, b in zip(SERVED_TOGETHER, alone, got):
        assert b is not None, method
        b_tensors = _result_tensors(b)
        assert len(a) == len(b_tensors)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b_tensors)), \
            method
        if method == "to_upper":
            assert ck.decrypt(b) == want
        elif method == "strip_prefix_clear":
            assert ck.decrypt_strip(b) == want
        else:
            assert ck.decrypt_char(b) == want, method
