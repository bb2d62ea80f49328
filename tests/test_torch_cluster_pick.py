"""The pick of the whole-rotation kernels' body (blocks per batch item) and
the wrappers' ``cluster=`` argument, on the CPU.

``cluster_size(batch, sms, n, occupancy)`` is a pure function of the batch,
the card and each kernel's measured wave costs; the bodies
themselves (thread-block clusters of 2, 4 or 8) run only on the card and
are held there by tests/test_torch_gpu.py.  A kernel's bodies are the keys
of its ``WAVE_COST.cluster`` and 1: K1 and K2 have 1, 2, 4 and 8, K4
(``ntt_ext``) 1, 2 and 4.  Tolerance: none, the wrappers'
results on CPU tensors are the plain versions' bit for bit.
"""

import numpy as np
import pytest
import torch

from fhestring_tpu_torch.crypto.kernels import blind_rotate32 as br
from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br64
from fhestring_tpu_torch.crypto.kernels import cluster
from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne

WRAPPERS = [br, br64]
BATCHES = [1, 15, 16, 17, 33, 34, 66, 67, 132, 133, 2048]
SIZES = [64, 128, 256, 512, 1024, 2048]  # every n the wrappers accept


H100_OCCUPANCY = {2: 66, 4: 30, 8: 15}


def _h100_occupancy(c, n):
    """Clusters an H100 runs at once (``cudaOccupancyMaxActiveClusters`` for
    both kernels at every n): its 132 SMs lie in GPCs of uneven size, so
    4-block clusters leave 12 of them idle and 8-block ones 12."""
    return H100_OCCUPANCY[c]


@pytest.mark.parametrize("module", WRAPPERS, ids=["k1", "k2"])
def test_wrappers_pick_with_their_own_costs(module):
    assert module.CLUSTERS == cluster.bodies(module.WAVE_COST) == (1, 2, 4, 8)
    assert set(module.WAVE_COST.cluster) == {2, 4, 8}
    for b in BATCHES:
        assert module.cluster_size(b, 132, 2048, _h100_occupancy) == \
            cluster.cluster_size(b, 132, 2048, module.WAVE_COST,
                                 _h100_occupancy)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("sms", [132, 108, 8])
def test_cluster_size_fits_a_lone_wave(batch, sms):
    """With cluster waves at a fraction of the one-block body's, a batch
    that fits one wave of a body takes the largest such body; without an
    occupancy function a cluster of c takes c SMs."""
    cost = cluster.WaveCost(one_block=(1.0,),
                            cluster={2: 0.5, 4: 0.25, 8: 0.2})
    c = cluster.cluster_size(batch, sms, 2048, cost)
    assert c in cluster.bodies(cost)
    fits = [b for b in cluster.bodies(cost)[1:] if batch * b <= sms]
    if fits:
        assert c == max(fits)
    if batch > sms:
        assert c == 1


@pytest.mark.parametrize("module,want", [
    (br, [8, 8, 4, 4, 2, 2, 2, 4, 1, 4, 1]),
    (br64, [8, 8, 4, 4, 2, 2, 2, 1, 1, 4, 1])], ids=["k1", "k2"])
def test_cluster_size_on_an_h100(module, want):
    """The picks at the batches either side of the switches, as the sweep
    on the card confirmed them (PERF.md): 8 blocks while 15 clusters hold
    the batch, 4 while 30 do, 2 up to 66, then (K1 only, up to 90) three
    waves of 4 or one
    wave of the one-block body, 4 again where five waves of it beat two of
    the one-block body, and 1 for a batch that fills the card."""
    got = [module.cluster_size(b, 132, 2048, _h100_occupancy)
           for b in BATCHES]
    assert got == want


@pytest.mark.parametrize("module", WRAPPERS, ids=["k1", "k2"])
@pytest.mark.parametrize("sms", [132, 108, 8])
def test_cluster_size_is_by_the_wave_model(module, sms):
    """The pick never takes more model time than the one-block body, and a
    batch beyond the one-block table is the one-block body's."""
    cost = module.WAVE_COST
    for batch in range(1, 3 * sms):
        c = module.cluster_size(batch, sms, 2048)
        waves = -(-batch // sms)
        if waves > len(cost.one_block):
            assert c == 1
            continue
        if c > 1:
            time = -(-batch // (sms // c)) * cost.cluster[c]
            assert time < cluster.MARGIN * cost.one_block[waves - 1]
    assert module.cluster_size(0, sms, 2048) == 1


@pytest.mark.parametrize("n", SIZES)
def test_cluster_size_asks_the_occupancy_at_this_n(n):
    """The occupancy is asked for at the caller's n, and a body that does
    not fit there (0 clusters) is never picked."""
    asked = []

    def occupancy(c, n_):
        asked.append((c, n_))
        return 0 if c in (4, 8) else 3

    for module in WRAPPERS:
        assert module.cluster_size(3, 132, n, occupancy) == 2
        assert module.cluster_size(200, 132, n, lambda c, n_: 0) == 1
    assert br.cluster_size(4, 132, n, occupancy) == 1
    assert set(asked) == {(8, n), (4, n), (2, n)}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("module", WRAPPERS, ids=["k1", "k2"])
def test_every_picked_body_is_one_the_wrapper_takes(module, n):
    """At every n the wrappers accept, the pick is a body of CLUSTERS, which
    the wrappers (and the kernels: any power of two from 64 to 2048) take
    at every n."""
    for batch in BATCHES:
        c = module.cluster_size(batch, 132, n, _h100_occupancy)
        module.check_cluster(c)


def test_cluster_size_rejects_nonsense():
    with pytest.raises(ValueError):
        br.cluster_size(-1, 132, 2048)
    with pytest.raises(ValueError):
        br64.cluster_size(1, 0, 2048)


def _inputs32(rng, B, n_steps, n):
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, n),
                                        dtype=np.int64).astype(np.int32))
    amt = torch.from_numpy(rng.integers(0, 2 * n, (B, n_steps),
                                        dtype=np.int64).astype(np.int32))
    kh = np.concatenate([rng.integers(0, q, (n_steps, 1, 6, 8, n))
                         for q in (40961, 61441)], axis=1)
    return acc, amt, torch.from_numpy(kh.astype(np.uint16).view(np.int16))


def _inputs64(rng, B, n_steps, n):
    acc = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (B, 2, n),
                                        dtype=np.int64))
    amt = torch.from_numpy(rng.integers(0, 2 * n, (B, n_steps),
                                        dtype=np.int64).astype(np.int32))
    kh = np.concatenate([rng.integers(0, q, (n_steps, 1, 2, 16, n))
                         for q in (40961, 61441)], axis=1)
    return acc, amt, torch.from_numpy(kh.astype(np.uint16).view(np.int16))


@pytest.mark.parametrize("bad", [0, 3, 6, 16, -1, "2", 2.5, True])
def test_cluster_must_be_a_body(bad):
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="cluster must be one of"):
        br.blind_rotate32(*_inputs32(rng, 1, 1, 64), cluster=bad)
    with pytest.raises(ValueError, match="cluster must be one of"):
        br64.blind_rotate64(*_inputs64(rng, 1, 1, 64), cluster=bad)


@pytest.mark.parametrize("c", [None, 1, 2, 4, 8])
def test_cluster_is_ignored_on_cpu_k1(c):
    """On CPU tensors the wrapper returns the plain version's result bit for
    bit whatever body is named, and counts no launch."""
    args = _inputs32(np.random.default_rng(1), 3, 4, 64)
    before = br.blind_rotate32.launches, dict(br.blind_rotate32.bodies)
    got = br.blind_rotate32(*args, cluster=c)
    assert torch.equal(got, br.blind_rotate32_plain(*args))
    assert (br.blind_rotate32.launches,
            br.blind_rotate32.bodies) == before


@pytest.mark.parametrize("rounded,approx", [(False, False), (True, True)],
                         ids=["exact", "production"])
@pytest.mark.parametrize("c", [None, 1, 2, 4, 8])
def test_cluster_is_ignored_on_cpu_k2(c, rounded, approx):
    args = _inputs64(np.random.default_rng(2), 3, 3, 64)
    mode = dict(rounded=rounded, approx=approx)
    before = br64.blind_rotate64.launches, dict(br64.blind_rotate64.bodies)
    got = br64.blind_rotate64(*args, cluster=c, **mode)
    assert torch.equal(got, br64.blind_rotate64_plain(*args, **mode))
    assert (br64.blind_rotate64.launches,
            br64.blind_rotate64.bodies) == before


@pytest.mark.parametrize("module", WRAPPERS, ids=["k1", "k2"])
def test_eight_blocks_while_a_wave_of_them_holds_the_batch(module):
    """On an H100 (132 SMs, 15 clusters of 8 at once) each wrapper runs a
    batch that one wave of 8-block clusters holds on the 8-block body, and
    the next batches, up to the 30 clusters of 4, on the 4-block body."""
    room = H100_OCCUPANCY[8]
    for b in range(1, room + 1):
        assert module.cluster_size(b, 132, 2048, _h100_occupancy) == 8, b
    for b in range(room + 1, H100_OCCUPANCY[4] + 1):
        assert module.cluster_size(b, 132, 2048, _h100_occupancy) == 4, b


@pytest.mark.parametrize("sms", [132, 108])
@pytest.mark.parametrize("module", WRAPPERS, ids=["k1", "k2"])
def test_no_room_for_eight_blocks_never_picks_them(module, sms):
    """A card that runs no cluster of 8 (its GPCs too small, or the body's
    shared memory refused) never gets the 8-block body, at any batch, and
    the other bodies are picked as by the same costs without it."""
    def occupancy(c, n_):
        return 0 if c == 8 else sms // c

    without = cluster.WaveCost(
        module.WAVE_COST.one_block,
        {c: t for c, t in module.WAVE_COST.cluster.items() if c != 8})
    for b in range(0, 3 * sms):
        got = module.cluster_size(b, sms, 2048, occupancy)
        assert got != 8
        assert got == cluster.cluster_size(b, sms, 2048, without, occupancy)


def test_only_k1_and_k2_take_eight_blocks():
    """K4 (``ntt_ext``) shares the cluster code but has no 8-block body: its
    bodies are 1, 2 and 4, its check refuses 8 and its pick never names it,
    while K1's and K2's checks take 8."""
    assert ne.CLUSTERS == cluster.bodies(ne.WAVE_COST) == (1, 2, 4)
    br.check_cluster(8)
    br64.check_cluster(8)
    with pytest.raises(ValueError, match=r"cluster must be one of \(1, 2, 4\)"):
        ne.check_cluster(8)
    for b in range(1, 300):
        assert cluster.cluster_size(b, 132, 2048, ne.WAVE_COST,
                                    _h100_occupancy) != 8
    dl = torch.zeros((3, 1, 2 * 64), dtype=torch.int8)
    khat = torch.zeros((2, 2, 16, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match="cluster must be one of"):
        ne.ntt_ext(dl, khat, cluster=8)
    assert torch.equal(ne.ntt_ext(dl, khat, cluster=4),
                       ne.ntt_ext_plain(dl, khat))
