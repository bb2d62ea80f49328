"""The step-wise 64-bit blind rotation (K5 + K3, K5 + K4) and the route
choice of the served path, against the JAX package.

At the 64-bit CI sets PARAM_TEST_ZERO_NOISE and PARAM_TEST_NOISY:
``pbs_batch(use_pallas=True)`` (the K3 route) and ``pbs_batch(use_ntt2=
True)`` (the K4 route) against the JAX ``pbs_batch`` on CPU and against
the port's whole-rotation kernel in the exact mode; the K3 route also
against the JAX ``pbs_batch(use_pallas=True)``, whose Pallas kernel runs
interpreted.  A ServerKey packed with ``with_ntt2=False`` serves contains
and find through the K3 route with the JAX engine's outputs and PBS
counts.  The route choice (``shortint.pbs_route``) is checked for every
case of the JAX package's ``_pbs_padded``.  Keys and ciphertexts are made
with numpy from a seed and given to both packages.

Tolerance: zero.  Every route is exact integer arithmetic.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhestring_tpu import metrics as jmetrics
from fhestring_tpu import params as jparams
from fhestring_tpu import torus as jtorus
from fhestring_tpu.client import ClientKey as JaxClientKey
from fhestring_tpu.crypto import keys as jkeys
from fhestring_tpu.crypto import pbs as jpbs
from fhestring_tpu.numpy_ref import core as ref
from fhestring_tpu_torch import (PARAM_TEST32_ZERO_NOISE, PARAM_TEST_NOISY,
                                 PARAM_TEST_ZERO_NOISE, metrics, shortint,
                                 torus)
from fhestring_tpu_torch.ciphertext import FheString, blocks_from_numpy, to_numpy
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br64
from fhestring_tpu_torch.crypto.kernels import ext_product as ep
from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd
from fhestring_tpu_torch.server import ServerKey

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

TABLE = [(5 * x + 2) % 16 for x in range(16)]
ROUTES = {"k3": {"use_pallas": True}, "k4": {"use_ntt2": True}}
S, PAT = "hello world", "ello"


@pytest.fixture(scope="module", params=[PARAM_TEST_ZERO_NOISE,
                                        PARAM_TEST_NOISY],
                ids=lambda p: p.name)
def setup(request):
    """Keys (both bootstrap keys packed), 12 ciphertexts, and the JAX
    package's exact pbs_batch of them (its CPU path), once per set."""
    p = request.param
    rng = np.random.default_rng(11)
    sk, srv = ref.keygen(p, rng)
    msgs = rng.integers(0, 16, size=12)
    cts = np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])
    jout = jpbs.pbs_batch(jtorus.from_numpy(cts), jnp.zeros(len(msgs), jnp.int32),
                          jkeys.pack_luts([TABLE], p), jkeys.pack_server_keys(srv))
    dev = keys.pack_server_keys(srv, "cpu", params=p)
    return p, sk, srv, dev, msgs, cts, jtorus.to_numpy(jout)


def _pbs(cts, dev, **route):
    p = dev.params
    return torus.to_numpy(pbs.pbs_batch(
        torus.from_numpy(cts), torch.zeros(len(cts), dtype=torch.int64),
        keys.pack_luts([TABLE], p, "cpu"), dev, **route))


@pytest.mark.parametrize("route", list(ROUTES))
def test_stepwise_pbs_batch_matches_jax_and_the_whole_rotation(setup, route):
    p, sk, _, dev, msgs, cts, jax_out = setup
    got = _pbs(cts, dev, **ROUTES[route])
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, _pbs(cts, dev))   # K2, exact mode
    for i, m in enumerate(msgs):
        assert ref.shortint_decrypt(sk, got[i]) == TABLE[m]


def test_k3_route_matches_jax_use_pallas_route():
    """The JAX package's K3 route (use_pallas=True: its XLA prologue and
    ext_product_u64, interpreted on CPU) at PARAM_TEST_ZERO_NOISE."""
    p = PARAM_TEST_ZERO_NOISE
    rng = np.random.default_rng(12)
    sk, srv = ref.keygen(p, rng)
    cts = np.stack([ref.shortint_encrypt(sk, m, rng) for m in range(8)])
    jout = jpbs.pbs_batch(jtorus.from_numpy(cts), jnp.zeros(8, jnp.int32),
                          jkeys.pack_luts([TABLE], p), jkeys.pack_server_keys(srv),
                          use_pallas=True)
    dev = keys.pack_server_keys(srv, "cpu", params=p, with_ntt2=False)
    np.testing.assert_array_equal(_pbs(cts, dev, use_pallas=True),
                                  jtorus.to_numpy(jout))


@pytest.fixture(scope="module")
def served():
    """The JAX ServerKey (CPU: no NTT key) and the port's ServerKey packed
    with with_ntt2=False on the same keys, and both packages' inputs."""
    jck = JaxClientKey(jparams.PARAM_TEST_ZERO_NOISE, seed=21)
    dev = keys.pack_server_keys(jck._server_raw, "cpu",
                                params=PARAM_TEST_ZERO_NOISE, with_ntt2=False)
    jin = (jck.encrypt(S, 1), jck.encrypt_no_padding(PAT))
    pin = tuple(FheString(blocks_from_numpy(jtorus.to_numpy(x.blocks.ct), "cpu"))
                for x in jin)
    return jck, jck.get_server_key(), ServerKey(dev, PARAM_TEST_ZERO_NOISE), jin, pin


@pytest.mark.parametrize("method", ["contains", "find"])
def test_served_without_ntt_key_matches_jax_engine(served, monkeypatch,
                                                   method):
    """Every PBS batch of the request runs n steps of K5 + K3 and no
    whole-rotation kernel; outputs and PBS counts equal the JAX engine's."""
    jck, jsrv, srv, jin, pin = served
    assert srv.backend.sc.keys.bsk_ntt64 is None
    calls = {"k5": 0, "k3": 0}

    def spy(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    def refuse(*args, **kwargs):
        raise AssertionError("whole-rotation kernel called")

    monkeypatch.setattr(rd, "rotate_diff_decompose",
                        spy("k5", rd.rotate_diff_decompose))
    monkeypatch.setattr(ep, "ext_product", spy("k3", ep.ext_product))
    monkeypatch.setattr(br64, "blind_rotate64", refuse)
    metrics.reset()
    out = getattr(srv, method)(*pin)
    counts = (metrics.GLOBAL.pbs_calls, metrics.GLOBAL.pbs_items,
              metrics.GLOBAL.pbs_items_padded)
    jmetrics.reset()
    jout = getattr(jsrv, method)(*jin)
    assert counts == (jmetrics.GLOBAL.pbs_calls, jmetrics.GLOBAL.pbs_items,
                      jmetrics.GLOBAL.pbs_items_padded)
    np.testing.assert_array_equal(to_numpy(out.blocks),
                                  jtorus.to_numpy(jout.blocks.ct))
    steps = PARAM_TEST_ZERO_NOISE.lwe_dimension * counts[0]
    assert calls == {"k5": steps, "k3": steps}
    assert jck.decrypt_char(jout) == (int(PAT in S) if method == "contains"
                                      else S.find(PAT))


def _keys(p, **tensors):
    return keys.DeviceServerKeys(params=p, ksk_limbs=torch.zeros(1),
                                 **tensors)


@pytest.mark.parametrize("case,want", [
    ("32-bit", {}),
    ("64-bit, NTT key, card", {"rounded": True, "approx": True}),
    ("64-bit, no NTT key, card", {"use_pallas": True}),
    ("64-bit, NTT key, CPU", {"rounded": False, "approx": False}),
    ("64-bit, no NTT key, CPU", {"use_pallas": True}),
])
def test_route_choice_mirrors_the_jax_package(case, want):
    """fhestring_tpu/shortint.py _pbs_padded: K1 for a 32-bit set; K2
    rounded + approx on an accelerator with the NTT key; the K3 route
    without it; exact on CPU."""
    key = torch.zeros(1)
    if case == "32-bit":
        dev = _keys(PARAM_TEST32_ZERO_NOISE, bsk_ntt32=key)
    elif "no NTT key" in case:
        dev = _keys(PARAM_TEST_ZERO_NOISE, bsk_limbs=key)
    else:
        dev = _keys(PARAM_TEST_ZERO_NOISE, bsk_ntt64=key, bsk_limbs=key)
    assert shortint.pbs_route(dev, on_cpu="CPU" in case) == want


def test_32bit_set_without_ntt_key_is_refused():
    dev = _keys(PARAM_TEST32_ZERO_NOISE)
    with pytest.raises(ValueError, match="ROADMAP"):
        shortint.pbs_route(dev, on_cpu=False)


@pytest.mark.parametrize("bad", ["rounded", "32-bit", "no limb key",
                                 "no NTT key"])
def test_stepwise_route_refusals(bad):
    p = PARAM_TEST32_ZERO_NOISE if bad == "32-bit" else PARAM_TEST_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(0))
    dev = keys.pack_server_keys(srv, "cpu", params=p,
                                with_ntt2=bad != "no NTT key")
    route = {"use_ntt2": True} if bad == "no NTT key" else {"use_pallas": True}
    if bad == "no limb key":
        dev.bsk_limbs = None
    acc = torch.zeros((1, 2, p.polynomial_size), dtype=torch.int64)
    lwe = torch.zeros((1, p.lwe_dimension + 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        pbs.blind_rotate(acc, lwe, dev, rounded=bad == "rounded", **route)


@pytest.mark.parametrize("params", [PARAM_TEST_ZERO_NOISE,
                                    PARAM_TEST32_ZERO_NOISE],
                         ids=lambda p: p.name)
def test_get_server_key_packs_the_ntt_key_unless_told_not_to(params):
    ck = ClientKey(params, seed=3)
    ntt_name = "bsk_ntt64" if params.torus_bits == 64 else "bsk_ntt32"
    for with_ntt2, packed in ((None, True), (True, True), (False, False)):
        dev = ck.get_server_key(with_ntt2=with_ntt2).backend.sc.keys
        assert (getattr(dev, ntt_name) is not None) == packed
        assert (dev.bsk_limbs is not None) == (params.torus_bits == 64)


# ---------------------------------------------------------------------------
# the step loop: eager on the CPU, a replayed CUDA graph on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_cpu_route_never_builds_a_graph(setup, monkeypatch, route):
    """On CPU tensors the steps run one by one: no capture, no replay, and
    still the JAX package's bits."""
    p, _, _, dev, _, cts, jax_out = setup

    def refuse(*args, **kwargs):
        raise AssertionError("graph machinery reached on the CPU")

    for name in ("_step_graph", "_capture_steps", "_replay_steps"):
        monkeypatch.setattr(pbs, name, refuse)
    np.testing.assert_array_equal(_pbs(cts, dev, **ROUTES[route]), jax_out)
    assert not pbs._STEP_GRAPHS


@pytest.mark.parametrize("route", list(ROUTES))
def test_stepwise_route_leaves_its_input_accumulator_alone(route):
    """The loop updates an accumulator in place; the caller's tensor is not
    that accumulator."""
    p = PARAM_TEST_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(5))
    dev = keys.pack_server_keys(srv, "cpu", params=p)
    rng = np.random.default_rng(6)
    acc = torus.from_numpy(rng.integers(0, 1 << 64, dtype=np.uint64,
                                        size=(3, 2, p.polynomial_size)))
    amounts = torch.from_numpy(rng.integers(
        0, 2 * p.polynomial_size, size=(3, p.lwe_dimension)).astype(np.int32))
    before = acc.clone()
    out = pbs._blind_rotate_stepwise(acc, amounts, dev, route == "k4")
    assert torch.equal(acc, before) and not torch.equal(out, before)
    want = br64.blind_rotate64(acc, amounts, dev.bsk_ntt64)
    assert torch.equal(out, want)


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _spy_on_the_wrappers(monkeypatch):
    """On the CPU a wrapper runs its plain version and counts no launch.
    Have the step loop's wrappers count as they do on the card, and a
    capture run its body once on the CPU: the graph then holds what a
    capture on the card holds."""
    from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne

    def counting(wrapper, body):
        def spy(*args, **kwargs):
            out = wrapper(*args, **kwargs)
            spy.launches += 1
            if body is not None:
                spy.bodies[body] += 1
            return out
        spy.launches = 0
        spy.bodies = dict.fromkeys(getattr(wrapper, "bodies", {}), 0)
        return spy

    spies = {
        "k5": counting(rd.rotate_diff_decompose, None),
        "k4": counting(ne.ntt_ext, 1),
        "k3": counting(ep.ext_product, None),
    }
    monkeypatch.setattr(ne, "pick_cluster", lambda batch, n, index: 1)
    monkeypatch.setattr(rd, "rotate_diff_decompose", spies["k5"])
    monkeypatch.setattr(ne, "ntt_ext", spies["k4"])
    monkeypatch.setattr(ep, "ext_product", spies["k3"])
    for module in (rd, ep):
        monkeypatch.setattr(module, "prepare", lambda device: None)
    monkeypatch.setattr(ne, "prepare", lambda device, n: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph: contextlib.nullcontext())
    return spies


@pytest.mark.parametrize("route", list(ROUTES))
def test_replay_counts_n_launches_per_kernel(monkeypatch, route):
    """A replay runs no wrapper, so ``_replay_steps`` adds the graph's n
    kernel nodes of K5 and of the route's product kernel (K4's also under
    the body the capture picked) to their counts, and nothing to the other
    product kernel's.  The capture itself counts nothing."""
    n, batch, size = 7, 3, 128
    spies = _spy_on_the_wrappers(monkeypatch)
    use_ntt2 = route == "k4"
    rng = np.random.default_rng(9)
    bsk = rng.integers(0, 1 << 64, size=(n, 2, 2, size), dtype=np.uint64)
    key = (keys.pack_bsk_ntt(bsk, "cpu", keys.KEY_PLANES64) if use_ntt2
           else keys.pack_bsk_limbs(bsk, "cpu"))
    entry = pbs._capture_steps((batch, 2, size), n, key, use_ntt2)
    assert [spy.launches for spy in spies.values()] == [0, 0, 0]
    assert spies["k4"].bodies == {1: 0, 2: 0, 4: 0}
    assert entry.graph.replays == 0
    assert entry.k4_body == (1 if use_ntt2 else None)
    for replays in (1, 2):
        pbs._replay_steps(entry, use_ntt2)
        assert entry.graph.replays == replays
        got = {name: spy.launches for name, spy in spies.items()}
        assert got == {"k5": replays * n,
                       "k4": replays * n if use_ntt2 else 0,
                       "k3": 0 if use_ntt2 else replays * n}
    assert spies["k4"].bodies == {1: 2 * n if use_ntt2 else 0, 2: 0, 4: 0}


def test_step_graphs_are_cached_by_shape_route_and_key(monkeypatch):
    """One capture per (route, accumulator shape, steps, key tensor); the
    least recently used graph goes once more than STEP_GRAPHS_KEPT are
    held."""
    captured = []

    def fake_capture(shape, n, key, use_ntt2):
        captured.append((tuple(shape), n, use_ntt2))
        return pbs._StepGraph(_FakeGraph(), key, torch.zeros(1),
                              torch.zeros(1), torch.zeros(1), None)

    monkeypatch.setattr(pbs, "_capture_steps", fake_capture)
    monkeypatch.setattr(pbs, "_STEP_GRAPHS", type(pbs._STEP_GRAPHS)())
    monkeypatch.setattr(pbs, "STEP_GRAPHS_KEPT", 3)
    key, other = torch.zeros(4), torch.zeros(4)
    first = pbs._step_graph((5, 2, 64), 7, key, False)
    assert pbs._step_graph((5, 2, 64), 7, key, False) is first
    assert pbs._step_graph((5, 2, 64), 7, key, True) is not first
    assert pbs._step_graph((15, 2, 64), 7, key, False) is not first
    assert len(captured) == 3
    assert pbs._step_graph((5, 2, 64), 7, key, False) is first   # now newest
    pbs._step_graph((5, 2, 64), 7, other, False)                 # a 4th
    assert len(captured) == 4 and len(pbs._STEP_GRAPHS) == 3
    assert pbs._step_graph((5, 2, 64), 7, key, False) is first   # was kept
    pbs._step_graph((5, 2, 64), 7, key, True)                    # was dropped
    assert len(captured) == 5


@pytest.mark.parametrize("kernel", ["k5", "k4"])
def test_out_forms_equal_the_returning_forms(kernel):
    """``out=`` of K5 and K4 (the loop's buffers): the same bits, written
    into the given tensor; a wrong buffer is refused.  (K3's ``out=`` and
    ``accumulate=`` are held in test_torch_ext_product.py.)"""
    from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne

    n, batch = 128, 3
    rng = np.random.default_rng(8)
    acc = torus.from_numpy(rng.integers(0, 1 << 64, size=(batch, 2, n),
                                        dtype=np.uint64))
    amounts = torch.from_numpy(rng.integers(0, 2 * n, size=batch)
                               .astype(np.int32))
    dl = rd.rotate_diff_decompose(acc, amounts)
    if kernel == "k5":
        out = torch.full_like(dl, 7)
        assert rd.rotate_diff_decompose(acc, amounts, out=out) is out
        assert torch.equal(out, dl)
        bad = torch.zeros((3, batch, n), dtype=torch.int8)
        with pytest.raises(ValueError):
            rd.rotate_diff_decompose(acc, amounts, out=bad)
    else:
        bsk = rng.integers(0, 1 << 64, size=(1, 2, 2, n), dtype=np.uint64)
        khat = keys.pack_bsk_ntt(bsk, "cpu", keys.KEY_PLANES64)[0]
        want = ne.ntt_ext(dl, khat)
        out = torch.full_like(want, 7)
        assert ne.ntt_ext(dl, khat, out=out) is out
        assert torch.equal(out, want)
        with pytest.raises(ValueError):
            ne.ntt_ext(dl, khat, out=out.to(torch.int32))
        added = acc.clone()
        assert ne.ntt_ext(dl, khat, out=added, accumulate=True) is added
        assert torch.equal(added, acc + want)
        with pytest.raises(ValueError):
            ne.ntt_ext(dl, khat, accumulate=True)
