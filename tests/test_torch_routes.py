"""The blind-rotation routes of ``pbs_batch`` and the served path's mode,
against the JAX package.

- The JAX package's ``use_ntt`` route (the CRT-NTT external product, its
  ``step_ntt`` in XLA) against the port's exact mode: the same
  arithmetic, run by the family's whole-rotation kernel.
- The limb-plane route of a key packed ``with_ntt2=False``: at 32 bits the
  digits of the 3 gadget levels in torch ops and one K3 per level against
  ``bsk_limbs``, where the JAX package runs ``_ext_planes_einsum``; at 64
  bits K5 + K3.

Each at both CI families, PARAM_TEST32_ZERO_NOISE and
PARAM_TEST_ZERO_NOISE, against the JAX ``pbs_batch`` on CPU; then the
route and mode of every kind of packed key on either device (the kernel
wrappers spied on, so that the card's cases run on the CPU), the modes a
route refuses, and one request through a ``with_ntt2=False`` 32-bit server
against the JAX engine's bits and PBS counts.  Keys and ciphertexts are
made with numpy from a seed and given to both packages.

Tolerance: zero.  Every route is exact integer arithmetic.
"""

import collections

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
from fhestring_tpu_torch import (PARAM_TEST32_ZERO_NOISE,
                                 PARAM_TEST_ZERO_NOISE, metrics, parallel,
                                 shortint, torus)
from fhestring_tpu_torch.ciphertext import FheString, blocks_from_numpy, to_numpy
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.crypto.kernels import blind_rotate32 as br
from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br64
from fhestring_tpu_torch.crypto.kernels import ext_product as ep
from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd
from fhestring_tpu_torch.server import ServerKey

torch.set_num_threads(1)

TABLE = [(5 * x + 2) % 16 for x in range(16)]
FAMILIES = [PARAM_TEST32_ZERO_NOISE, PARAM_TEST_ZERO_NOISE]
JAX_PARAMS = {PARAM_TEST32_ZERO_NOISE.name: jparams.PARAM_TEST32_ZERO_NOISE,
              PARAM_TEST_ZERO_NOISE.name: jparams.PARAM_TEST_ZERO_NOISE}


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda p: p.name)
def setup(request):
    """Keys, 12 ciphertexts, and the JAX package's pbs_batch of them by its
    default route and by use_ntt, once per family."""
    p = request.param
    rng = np.random.default_rng(17)
    sk, srv = ref.keygen(p, rng)
    msgs = rng.integers(0, 16, size=12)
    cts = np.stack([ref.shortint_encrypt(sk, int(m), rng) for m in msgs])
    args = (jtorus.from_numpy(cts), jnp.zeros(len(msgs), jnp.int32),
            jkeys.pack_luts([TABLE], p))
    jout = jpbs.pbs_batch(*args, jkeys.pack_server_keys(srv))
    jntt = jpbs.pbs_batch(*args, jkeys.pack_server_keys(srv, with_ntt=True),
                          use_ntt=True)
    return p, sk, srv, msgs, cts, jtorus.to_numpy(jout), jtorus.to_numpy(jntt)


def _pbs(cts, dev, **mode):
    return torus.to_numpy(pbs.pbs_batch(
        torus.from_numpy(cts), torch.zeros(len(cts), dtype=torch.int64),
        keys.pack_luts([TABLE], dev.params, "cpu"), dev, **mode))


def test_use_ntt_matches_jax(setup):
    """The JAX package's use_ntt route against its default route and the
    port's exact mode on a key packed with its NTT-domain key (all exact,
    so the same bits): the port runs the use_ntt arithmetic through the
    family's whole-rotation kernel."""
    p, sk, srv, msgs, cts, jout, jntt = setup
    np.testing.assert_array_equal(jout, jntt)
    dev = keys.pack_server_keys(srv, "cpu", params=p)
    assert dev.ntt_key is not None
    got = _pbs(cts, dev)
    np.testing.assert_array_equal(got, jntt)
    assert [ref.shortint_decrypt(sk, c) for c in got] == [TABLE[m]
                                                          for m in msgs]


def test_limb_route_without_ntt_key_matches_jax(setup):
    """A key packed with_ntt2=False is served exact by the limb-plane
    route, with the JAX package's bits."""
    p, sk, srv, msgs, cts, jout, _ = setup
    dev = keys.pack_server_keys(srv, "cpu", params=p, with_ntt2=False)
    assert dev.bsk_limbs is not None
    assert dev.bsk_ntt32 is None and dev.bsk_ntt64 is None
    assert pbs.served_mode(dev, "cpu") == (False, False)
    np.testing.assert_array_equal(_pbs(cts, dev), jout)


def test_32bit_limb_key_in_the_jax_layout():
    """The 32-bit bsk_limbs, rows level-major, is the JAX package's
    bsk_limbs once un-reversed and put back in its row order; and the raw
    key comes back from it and from the NTT-domain key."""
    p = PARAM_TEST32_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(3))
    dev = keys.pack_server_keys(srv, "cpu", params=p, with_ntt2=True)
    limbs = keys.pack_bsk_limbs(srv.bsk, "cpu", p.pbs_level)
    jax_limbs = keys.jax_bsk_limbs(limbs, p.pbs_level)
    np.testing.assert_array_equal(
        jax_limbs.numpy(), np.asarray(jkeys.pack_server_keys(srv).bsk_limbs))
    raw = torus.from_numpy(srv.bsk)
    assert torch.equal(keys.bsk_from_limbs(jax_limbs), raw)
    assert torch.equal(keys.bsk_from_hats(dev.bsk_ntt32, p), raw)
    kp1 = p.glwe_dimension + 1
    for lev in range(p.pbs_level):   # level lev's rows are one slice
        assert torch.equal(limbs[:, lev * kp1:(lev + 1) * kp1],
                           keys.pack_bsk_limbs(srv.bsk[:, lev::p.pbs_level],
                                               "cpu"))


def test_64bit_raw_key_from_the_ntt_key():
    p = PARAM_TEST_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(4))
    dev = keys.pack_server_keys(srv, "cpu", params=p)
    assert torch.equal(keys.bsk_from_hats(dev.bsk_ntt64, p),
                       torus.from_numpy(srv.bsk))


KEY_STATES = {"NTT key": ("ntt",), "limbs only": ("limbs",),
              "both": ("ntt", "limbs"), "neither": ()}


def _zero_keys(p, packed):
    """DeviceServerKeys of the set's shapes, zero, holding the fields that
    ``packed`` names: "ntt" (the family's NTT-domain key), "limbs"."""
    n, N, kp1 = p.lwe_dimension, p.polynomial_size, p.glwe_dimension + 1
    R = kp1 * p.pbs_level
    tensors = {}
    if "ntt" in packed:
        tensors[keys.ntt_field(p)] = torch.zeros(
            (n, 2, R, kp1 * keys.key_planes(p), N), dtype=torch.int16)
    if "limbs" in packed:
        tensors["bsk_limbs"] = torch.zeros((n, R, kp1, 8, 2 * N),
                                           dtype=torch.int8)
    return keys.DeviceServerKeys(
        params=p, ksk_limbs=torch.zeros((1, 8), dtype=torch.int8), **tensors)


def _spy_kernels(monkeypatch):
    """Count the launches of each kernel wrapper blind_rotate reaches, K1
    and K2 by mode, without running any."""
    taken = collections.Counter()

    def whole(name):
        def run(acc, amounts, khat, rounded=False, approx=False):
            taken[name, rounded, approx] += 1
            return acc
        return run

    def step(name):
        def run(*args, out=None, **kwargs):
            taken[name] += 1
            return out
        return run

    monkeypatch.setattr(br, "blind_rotate32", whole("K1"))
    monkeypatch.setattr(br64, "blind_rotate64", whole("K2"))
    monkeypatch.setattr(rd, "rotate_diff_decompose", step("K5"))
    monkeypatch.setattr(ep, "ext_product", step("K3"))
    return taken


@pytest.mark.parametrize("device", ["cpu", "cuda"], ids=["CPU", "card"])
@pytest.mark.parametrize("state", list(KEY_STATES))
@pytest.mark.parametrize("p", FAMILIES, ids=lambda p: p.name)
def test_served_route_and_mode(monkeypatch, p, state, device):
    """The served path's mode (``served_mode``) and the route
    ``blind_rotate`` takes in that mode, for every kind of packed key, as
    the JAX package's ``_pbs_padded`` chooses them: the whole-rotation
    kernel with the NTT-domain key, K2 rounded + approx on the card and
    exact on CPU, K1 exact; the limb-plane route without it, exact (K5 +
    K3 a step at 64 bits, one K3 per gadget level at 32); a key with
    neither is refused."""
    taken = _spy_kernels(monkeypatch)
    dev = _zero_keys(p, KEY_STATES[state])
    mode = pbs.served_mode(dev, device)
    acc = torch.zeros((1, 2, p.polynomial_size), dtype=torch.int64)
    lwe = torch.zeros((1, p.lwe_dimension + 1), dtype=torch.int64)
    fast = (p.torus_bits == 64 and device == "cuda"
            and "ntt" in KEY_STATES[state])
    assert mode == (fast, fast)
    if state == "neither":
        with pytest.raises(ValueError, match="neither"):
            pbs.blind_rotate(acc, lwe, dev, *mode)
        assert not taken
        return
    pbs.blind_rotate(acc, lwe, dev, *mode)
    n = p.lwe_dimension
    if state == "limbs only" and p.torus_bits == 32:
        want = {"K3": n * p.pbs_level}
    elif state == "limbs only":
        want = {"K5": n, "K3": n}
    else:
        want = {("K1" if p.torus_bits == 32 else "K2", *mode): 1}
    assert dict(taken) == want


@pytest.mark.parametrize("case", ["K1 rounded", "K1 approx",
                                  "limbs rounded", "limbs approx"])
def test_new_route_refusals(case):
    """At 32 bits K1 and the limb-plane route run the exact mode only."""
    p = PARAM_TEST32_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(0))
    dev = keys.pack_server_keys(srv, "cpu", params=p,
                                with_ntt2=case.startswith("K1"))
    acc = torch.zeros((1, 2, p.polynomial_size), dtype=torch.int64)
    lwe = torch.zeros((1, p.lwe_dimension + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="exact mode only"):
        pbs.blind_rotate(acc, lwe, dev, rounded=case.endswith("rounded"),
                         approx=case.endswith("approx"))


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "sharded"])
def test_pbs_padded_passes_the_served_mode_by_name(monkeypatch, sharded):
    """The shortint layer calls ``pbs_batch(flat, idx, bank, keys)`` (or
    ``parallel.pbs_batch_sharded`` with the group) with ``served_mode``'s
    mode as ``rounded`` and ``approx`` and no other keyword: the call
    shape that code wrapping ``shortint.pbs_batch`` relies on."""
    calls = []

    def spy(flat, idx, bank, keys_, *group, **mode):
        calls.append((keys_, group, mode))
        return flat

    monkeypatch.setattr(shortint, "pbs_batch", spy)
    monkeypatch.setattr(parallel, "pbs_batch_sharded", spy)
    monkeypatch.setattr(shortint, "served_mode", lambda k, d: (True, False))
    p = PARAM_TEST_ZERO_NOISE
    dev = _zero_keys(p, ("ntt",))
    sc = shortint.ShortintContext(dev)
    sc.group = "group" if sharded else None
    flat = torch.zeros((3, p.big_lwe_dimension + 1), dtype=torch.int64)
    out = sc._pbs_padded(flat, torch.zeros(3, dtype=torch.int64),
                         torch.zeros((1, 2 * p.polynomial_size)))
    assert out.shape == flat.shape
    assert len(calls) == 1 and calls[0][0] is dev
    assert calls[0][1:] == (("group",) if sharded else (),
                            {"rounded": True, "approx": False})


@pytest.mark.parametrize("method", ["contains", "to_upper"])
def test_turbo_request_without_ntt_key_matches_jax_engine(monkeypatch,
                                                          method):
    """One request through a 32-bit server packed with_ntt2=False: every
    PBS batch runs 3 K3 products a step and no whole-rotation kernel; the
    outputs and PBS counts equal the JAX engine's (its CPU server has no
    NTT key either, and runs its einsum route)."""
    jck = JaxClientKey(jparams.PARAM_TEST32_ZERO_NOISE, seed=23)
    p = PARAM_TEST32_ZERO_NOISE
    srv = ServerKey(keys.pack_server_keys(jck._server_raw, "cpu", params=p,
                                          with_ntt2=False), p)
    jin = (jck.encrypt("hi all", 1), jck.encrypt_no_padding("ll"))
    pin = tuple(FheString(blocks_from_numpy(jtorus.to_numpy(x.blocks.ct),
                                            "cpu")) for x in jin)
    args = {"contains": 2, "to_upper": 1}[method]
    k3 = []

    def spy(*a, **kw):
        k3.append(1)
        return ep_product(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("whole-rotation kernel called")

    ep_product = ep.ext_product
    monkeypatch.setattr(ep, "ext_product", spy)
    monkeypatch.setattr(br, "blind_rotate32", refuse)
    metrics.reset()
    out = getattr(srv, method)(*pin[:args])
    counts = (metrics.GLOBAL.pbs_calls, metrics.GLOBAL.pbs_items,
              metrics.GLOBAL.pbs_items_padded)
    jmetrics.reset()
    jout = getattr(jck.get_server_key(), method)(*jin[:args])
    assert counts == (jmetrics.GLOBAL.pbs_calls, jmetrics.GLOBAL.pbs_items,
                      jmetrics.GLOBAL.pbs_items_padded)
    np.testing.assert_array_equal(to_numpy(out.blocks),
                                  jtorus.to_numpy(jout.blocks.ct))
    assert len(k3) == p.pbs_level * p.lwe_dimension * counts[0]
    want = "HI ALL" if method == "to_upper" else 1
    got = jck.decrypt(jout) if method == "to_upper" else jck.decrypt_char(jout)
    assert got == want


def test_32bit_route_digits_equal_decompose():
    """The 32-bit route's digits, all three levels at once, against
    ``decompose`` level by level: every top 24-bit value with each rounding
    case of the bits below, and a step's prologue on random accumulators."""
    top = torch.arange(1 << 24, dtype=torch.int64) << 40
    for low in (0, (1 << 39) - 1, 1 << 39):
        v = top + low
        assert torch.equal(pbs.gadget_digits32(v), pbs.decompose(v, 8, 3))
    gen = torch.Generator().manual_seed(5)
    acc = torch.randint(-2**63, 2**63 - 1, (9, 2, 256), generator=gen)
    a = torch.randint(0, 512, (9,), dtype=torch.int32, generator=gen)
    dl = pbs._digit_buffer(acc.shape, 3, "cpu")
    pbs._digits_levels(acc, a, dl)
    diff = pbs.negacyclic_rotate(acc, a.to(torch.int64)) - acc
    assert torch.equal(dl[:, 0].view(3, 9, 2, 256).long(),
                       pbs.decompose(diff, 8, 3))
    assert not dl[:, 1:].any()
