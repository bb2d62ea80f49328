"""The two blind-rotation routes that ``pbs_batch`` gained to serve every
key the JAX package serves, against the JAX package.

- ``use_ntt=True``: the CRT-NTT external product against ``bsk_ntt``
  (``pack_server_keys(with_ntt=True)``), either family, through the
  family's whole-rotation kernel in exact mode (its plain version on CPU
  tensors); the JAX package's ``step_ntt`` (XLA).
- The limb-plane route of a key packed ``with_ntt2=False``
  (``use_pallas=True``): at 32 bits the digits of the 3 gadget levels in
  torch ops and one K3 per level against ``bsk_limbs``, where the JAX
  package runs ``_ext_planes_einsum``; at 64 bits K5 + K3.

Each at both CI families, PARAM_TEST32_ZERO_NOISE and
PARAM_TEST_ZERO_NOISE, against the JAX ``pbs_batch`` on CPU; then the
keyword precedence use_fused > use_ntt2 > use_ntt > use_pallas, the served
route choice, and one request through a ``with_ntt2=False`` 32-bit server
against the JAX engine's bits and PBS counts.  Keys and ciphertexts are
made with numpy from a seed and given to both packages.

Tolerance: zero.  Every route is exact integer arithmetic.
"""

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
                                 PARAM_TEST_ZERO_NOISE, metrics, shortint,
                                 torus)
from fhestring_tpu_torch.ciphertext import FheString, blocks_from_numpy, to_numpy
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.crypto.kernels import blind_rotate32 as br
from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br64
from fhestring_tpu_torch.crypto.kernels import ext_product as ep
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


def _pbs(cts, dev, **route):
    return torus.to_numpy(pbs.pbs_batch(
        torus.from_numpy(cts), torch.zeros(len(cts), dtype=torch.int64),
        keys.pack_luts([TABLE], dev.params, "cpu"), dev, **route))


def test_use_ntt_matches_jax(setup):
    """pbs_batch(use_ntt=True) against the JAX package's use_ntt route and
    its default route (both exact, so the same bits)."""
    p, sk, srv, msgs, cts, jout, jntt = setup
    np.testing.assert_array_equal(jout, jntt)
    dev = keys.pack_server_keys(srv, "cpu", params=p, with_ntt2=False,
                                with_ntt=True)
    got = _pbs(cts, dev, use_ntt=True)
    np.testing.assert_array_equal(got, jntt)
    assert [ref.shortint_decrypt(sk, c) for c in got] == [TABLE[m]
                                                          for m in msgs]


def test_use_ntt_key_is_the_whole_rotation_key(setup):
    """with_ntt packs the family's NTT-domain key; packed with with_ntt2 as
    well, the two fields hold one tensor."""
    p, _, srv, *_ = setup
    both = keys.pack_server_keys(srv, "cpu", params=p, with_ntt=True)
    family = both.bsk_ntt32 if p.torus_bits == 32 else both.bsk_ntt64
    assert both.bsk_ntt is family
    alone = keys.pack_server_keys(srv, "cpu", params=p, with_ntt2=False,
                                  with_ntt=True)
    assert torch.equal(alone.bsk_ntt, family)
    assert alone.bsk_ntt32 is None and alone.bsk_ntt64 is None


def test_limb_route_without_ntt_key_matches_jax(setup):
    """A key packed with_ntt2=False served by pbs_route's keywords (the
    limb-plane route) gives the JAX package's bits."""
    p, sk, srv, msgs, cts, jout, _ = setup
    dev = keys.pack_server_keys(srv, "cpu", params=p, with_ntt2=False)
    assert dev.bsk_limbs is not None
    assert dev.bsk_ntt32 is None and dev.bsk_ntt64 is None
    route = shortint.pbs_route(dev, on_cpu=True)
    assert route == {"use_pallas": True}
    np.testing.assert_array_equal(_pbs(cts, dev, **route), jout)


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


def _spy_routes(monkeypatch):
    """Record which route blind_rotate takes, without running it."""
    taken = []

    def record(name):
        def run(*args, **kwargs):
            taken.append(name)
            return args[0]
        return run

    monkeypatch.setattr(br, "blind_rotate32", record("fused"))
    monkeypatch.setattr(br64, "blind_rotate64", record("fused"))
    monkeypatch.setattr(pbs, "_blind_rotate_ntt", record("ntt"))

    def stepwise(acc, amounts, keys_, use_ntt2, graph=True):
        taken.append("ntt2" if use_ntt2 else "pallas")
        return acc

    monkeypatch.setattr(pbs, "_blind_rotate_stepwise", stepwise)
    return taken


@pytest.mark.parametrize("flags,want", [
    ({}, "fused"),
    ({"use_fused": True, "use_ntt2": True, "use_ntt": True,
      "use_pallas": True}, "fused"),
    ({"use_ntt2": True, "use_ntt": True, "use_pallas": True}, "ntt2"),
    ({"use_ntt": True, "use_pallas": True}, "ntt"),
    ({"use_pallas": True}, "pallas"),
])
def test_keyword_precedence(monkeypatch, flags, want):
    """use_fused > use_ntt2 > use_ntt > use_pallas, as the JAX package's
    blind_rotate reads them (fhestring_tpu/crypto/pbs.py)."""
    taken = _spy_routes(monkeypatch)
    p = PARAM_TEST_ZERO_NOISE
    dev = keys.DeviceServerKeys(params=p, ksk_limbs=torch.zeros(1))
    acc = torch.zeros((1, 2, p.polynomial_size), dtype=torch.int64)
    lwe = torch.zeros((1, p.lwe_dimension + 1), dtype=torch.int64)
    pbs.blind_rotate(acc, lwe, dev, **flags)
    assert taken == [want]


@pytest.mark.parametrize("bad", ["no bsk_ntt", "ntt2 at 32 bits",
                                 "rounded"])
def test_new_route_refusals(bad):
    p = PARAM_TEST32_ZERO_NOISE if bad == "ntt2 at 32 bits" \
        else PARAM_TEST_ZERO_NOISE
    _, srv = ref.keygen(p, np.random.default_rng(0))
    dev = keys.pack_server_keys(srv, "cpu", params=p)
    flags = {"use_ntt2": True} if bad == "ntt2 at 32 bits" else {
        "use_ntt": True}
    acc = torch.zeros((1, 2, p.polynomial_size), dtype=torch.int64)
    lwe = torch.zeros((1, p.lwe_dimension + 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        pbs.blind_rotate(acc, lwe, dev, rounded=bad == "rounded", **flags)


@pytest.mark.parametrize("case,want", [
    ("NTT key", {}),
    ("limbs only", {"use_pallas": True}),
    ("both", {}),
])
def test_pbs_route_at_32_bits(case, want):
    """The served route of a 32-bit key: K1 with its NTT key, the limb
    route without it (where the JAX package runs its einsum)."""
    t = torch.zeros(1)
    tensors = {"NTT key": {"bsk_ntt32": t}, "limbs only": {"bsk_limbs": t},
               "both": {"bsk_ntt32": t, "bsk_limbs": t}}[case]
    dev = keys.DeviceServerKeys(params=PARAM_TEST32_ZERO_NOISE,
                                ksk_limbs=t, **tensors)
    for on_cpu in (True, False):
        assert shortint.pbs_route(dev, on_cpu=on_cpu) == want


def test_pbs_route_refuses_a_key_with_neither():
    dev = keys.DeviceServerKeys(params=PARAM_TEST32_ZERO_NOISE,
                                ksk_limbs=torch.zeros(1))
    with pytest.raises(ValueError, match="neither"):
        shortint.pbs_route(dev, on_cpu=True)


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
