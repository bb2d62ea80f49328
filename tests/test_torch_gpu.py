"""The CUDA kernels on the card, against their plain versions:
blind_rotate32 (turbo), blind_rotate64 (PARAM_PROD family, in its exact,
rounded, rounded + approx and approx modes), each in every body (1 block
per item and clusters of 2 and 4), and the step-wise 64-bit route's
rotate_decompose, ext_product and ntt_ext.

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
    ck = ClientKey(P, seed=1)
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
    ck = ClientKey(P64, seed=1)
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
# thread-block clusters of 2 and 4 blocks per item
# ---------------------------------------------------------------------------

BODY_SHAPES = [(1, 3, 64), (5, 4, 256), (33, 3, 256), (1, 3, 2048),
               (5, 3, 2048), (33, 2, 2048)]


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
    for c in (2, 4):
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
    khat = keys.pack_bsk_ntt(bsk, stepwise, keys.KEY_PLANES64)
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


@pytest.mark.parametrize("B", [1, 5, 33])
@pytest.mark.parametrize("route", [False, True], ids=["k3", "k4"])
def test_graph_replay_equals_the_eager_loop(stepwise, key_material64, B,
                                            route):
    """Two different inputs at one B through one cached graph, each equal
    to the eager loop on the card and to the CPU loop (a stale static
    buffer would show on the second); the replay counts n launches of K5
    and of the route's product kernel, the capture none."""
    srv, dev = key_material64
    cpu = keys.pack_server_keys(srv, "cpu", params=P64)
    n, N = P64.lwe_dimension, P64.polynomial_size
    product = ne.ntt_ext if route else ep.ext_product
    gen = torch.Generator().manual_seed(B)
    graphs = len(pbs._STEP_GRAPHS)
    for turn in range(2):
        acc = torch.randint(-2**63, 2**63 - 1, (B, 2, N), dtype=torch.int64,
                            generator=gen)
        amt = torch.randint(0, 2 * N, (B, n), dtype=torch.int32,
                            generator=gen)
        before = (rd.rotate_diff_decompose.launches, product.launches)
        got = pbs._blind_rotate_stepwise(acc.to(stepwise), amt.to(stepwise),
                                         dev, route)
        assert (rd.rotate_diff_decompose.launches,
                product.launches) == (before[0] + n, before[1] + n)
        eager = pbs._blind_rotate_stepwise(acc.to(stepwise), amt.to(stepwise),
                                           dev, route, graph=False)
        assert torch.equal(got, eager)
        assert torch.equal(got.cpu(),
                           pbs._blind_rotate_stepwise(acc, amt, cpu, route))
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
@pytest.mark.parametrize("route", [{"use_pallas": True}, {"use_ntt2": True}],
                         ids=["k3", "k4"])
def test_stepwise_pbs_batch_cuda_equals_cpu(stepwise, key_material64, B,
                                            route):
    """pbs_batch through each step-wise route on the card equals the same
    route on CPU and K2's exact mode on the card; n launches of K5 and of
    the route's product kernel."""
    srv, dev = key_material64
    cpu = keys.pack_server_keys(srv, "cpu", params=P64)
    rng = np.random.default_rng(B)
    cts = rng.integers(0, 1 << 64, size=(B, P64.big_lwe_dimension + 1),
                       dtype=np.uint64)
    idx = torch.from_numpy(np.arange(B) % 2)
    tables = [[(3 * x + 1) % 16 for x in range(16)], list(range(16))]
    product = ne.ntt_ext if "use_ntt2" in route else ep.ext_product
    before = (rd.rotate_diff_decompose.launches, product.launches)
    got = pbs.pbs_batch(torus.from_numpy(cts, stepwise), idx.to(stepwise),
                        keys.pack_luts(tables, P64, stepwise), dev, **route)
    n = P64.lwe_dimension
    assert (rd.rotate_diff_decompose.launches,
            product.launches) == (before[0] + n, before[1] + n)
    whole = pbs.pbs_batch(torus.from_numpy(cts, stepwise), idx.to(stepwise),
                          keys.pack_luts(tables, P64, stepwise), dev)
    want = pbs.pbs_batch(torus.from_numpy(cts), idx,
                         keys.pack_luts(tables, P64, "cpu"), cpu, **route)
    np.testing.assert_array_equal(torus.to_numpy(got), torus.to_numpy(want))
    np.testing.assert_array_equal(torus.to_numpy(whole), torus.to_numpy(want))


def test_contains_without_ntt_key_on_cuda_equals_cpu(stepwise):
    """A ServerKey packed with with_ntt2=False serves contains through K5 +
    K3 on the card (n launches of each per PBS batch, no K2), equal to the
    CPU path on the same keys; both run exact."""
    ck = ClientKey(P64, seed=1)
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
# K4's cluster bodies, the step loop's graph, use_fused, the CLI
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
    khat = keys.pack_bsk_ntt(bsk, stepwise, keys.KEY_PLANES64)[0]
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
    use_ntt2 = route == "k4"
    product = ne.ntt_ext if use_ntt2 else ep.ext_product
    gen = torch.Generator().manual_seed(3)
    for turn in range(2):
        acc = torch.randint(-2**63, 2**63 - 1, (5, 2, N), dtype=torch.int64,
                            generator=gen).to(stepwise)
        amt = torch.randint(0, 2 * N, (5, n), dtype=torch.int32,
                            generator=gen).to(stepwise)
        before = (rd.rotate_diff_decompose.launches, product.launches,
                  dict(ne.ntt_ext.bodies))
        got = pbs._blind_rotate_stepwise(acc, amt, dev, use_ntt2)
        assert (rd.rotate_diff_decompose.launches - before[0],
                product.launches - before[1]) == (n, n)
        picked = ne.pick_cluster(5, N, stepwise.index or 0)
        assert ne.ntt_ext.bodies == {
            c: before[2][c] + (n if use_ntt2 and c == picked else 0)
            for c in ne.CLUSTERS}
        assert torch.equal(got, pbs._blind_rotate_stepwise(
            acc, amt, dev, use_ntt2, graph=False))
        assert torch.equal(got, br64.blind_rotate64(acc, amt, dev.bsk_ntt64))


def test_pbs_batch_takes_use_fused(cuda, key_material64):
    """A caller written for the JAX signature: use_fused=True is the
    whole-rotation kernel, which is also the default."""
    srv, dev = key_material64
    rng = np.random.default_rng(2)
    sk = ref.keygen(P64, np.random.default_rng(11))[0]
    cts = torus.from_numpy(np.stack(
        [ref.shortint_encrypt(sk, int(m), rng) for m in range(8)]), cuda)
    bank = keys.pack_luts([[(3 * x + 1) % 16 for x in range(16)]], P64, cuda)
    idx = torch.zeros(8, dtype=torch.int64, device=cuda)
    before = br64.blind_rotate64.launches
    fused = pbs.pbs_batch(cts, idx, bank, dev, use_fused=True, use_pallas=True)
    assert br64.blind_rotate64.launches == before + 1
    assert torch.equal(fused, pbs.pbs_batch(cts, idx, bank, dev))


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
