"""Key and ciphertext checkpoints of the port (``serialize.py``), and the
npz format both ways between the port and the JAX package.

- Twins of the five tests of tests/test_serialize.py on the port.
- Each of the five kinds (client key, server key, packed server key,
  FheString, FheChar) saved by one package and loaded by the other, both
  directions, at both CI families (PARAM_TEST_ZERO_NOISE and
  PARAM_TEST32_ZERO_NOISE).  Keys made from the same seed are the same
  keys in both packages, so each load is held to what the loading package
  makes itself.
- A packed server key saved by either package serves a method in the
  other with the saver's bits.
- ``ClientKey.get_server_key(cache_path=)``: miss, hit, a file of another
  parameter set, and a file without the NTT-domain key.

Tolerance: zero.  Files carry integers; every route is exact.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhestring_tpu import params as jparams
from fhestring_tpu import serialize as jser
from fhestring_tpu import torus as jtorus
from fhestring_tpu.client import ClientKey as JaxClientKey
from fhestring_tpu.crypto import keys as jkeys
from fhestring_tpu.crypto import pbs as jpbs
from fhestring_tpu_torch import (PARAM_TEST32_ZERO_NOISE,
                                 PARAM_TEST_ZERO_NOISE, serialize, torus)
from fhestring_tpu_torch.ciphertext import FheString, blocks_from_numpy, to_numpy
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.crypto import keys, pbs
from fhestring_tpu_torch.numpy_ref import core as ref

torch.set_num_threads(1)

FAMILIES = [PARAM_TEST_ZERO_NOISE, PARAM_TEST32_ZERO_NOISE]
TABLE = [(5 * x + 2) % 16 for x in range(16)]
JAX_PARAMS = {PARAM_TEST32_ZERO_NOISE.name: jparams.PARAM_TEST32_ZERO_NOISE,
              PARAM_TEST_ZERO_NOISE.name: jparams.PARAM_TEST_ZERO_NOISE}
DEVICE_FIELDS = ("bsk_limbs", "ksk_limbs", "bsk_ntt32", "bsk_ntt64")


# ---------------------------------------------------------------------------
# twins of tests/test_serialize.py
# ---------------------------------------------------------------------------

def test_client_key_roundtrip(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=5, device="cpu")
    path = str(tmp_path / "ck.npz")
    serialize.save_client_key(path, ck)
    ck2 = serialize.load_client_key(path, device="cpu")

    # the restored client decrypts ciphertexts made by the original...
    s = ck.encrypt("roundtrip", 1)
    assert ck2.decrypt(s) == "roundtrip"
    # ...and its fresh encryptions decrypt under the original key
    t = ck2.encrypt("hello", 2)
    assert ck.decrypt(t) == "hello"


def test_server_key_roundtrip_and_eval(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=5, device="cpu")
    path = str(tmp_path / "sk.npz")
    serialize.save_server_key(path, ck)
    srv = serialize.load_server_key(path, device="cpu")

    s = ck.encrypt("abcd", 1)
    pat = ck.encrypt_no_padding("bc")
    assert ck.decrypt_char(srv.contains(s, pat)) == 1
    assert ck.decrypt_char(srv.len(s)) == 4


def test_server_key_file_has_no_secrets(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=5, device="cpu")
    path = str(tmp_path / "sk.npz")
    serialize.save_server_key(path, ck)
    data = np.load(path, allow_pickle=False)
    assert "lwe_sk" not in data and "glwe_sk" not in data


def test_ciphertext_roundtrip(tmp_path):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=6, device="cpu")
    s = ck.encrypt("persist", 2)
    path = str(tmp_path / "ct.npz")
    serialize.save_fhe_string(path, s)
    s2 = serialize.load_fhe_string(path, device="cpu")
    assert ck.decrypt(s2) == "persist"

    srv = ck.get_server_key()
    c = srv.len(s2)
    cpath = str(tmp_path / "char.npz")
    serialize.save_fhe_char(cpath, c)
    assert ck.decrypt_char(serialize.load_fhe_char(cpath, device="cpu")) == 7


def test_packed_server_key_roundtrip(tmp_path):
    """The device-format key checkpoint restores a working server without
    re-packing, with the NTT-domain bootstrap key, and get_server_key(
    cache_path=) hits it."""
    ck = ClientKey(PARAM_TEST32_ZERO_NOISE, seed=3, device="cpu")
    path = str(tmp_path / "packed.npz")
    srv = ck.get_server_key(with_ntt2=True, cache_path=path)
    assert srv.backend.sc.keys.bsk_ntt32 is not None

    loaded = serialize.load_packed_server_key(path, device="cpu")
    assert loaded.params == ck.params
    assert loaded.backend.sc.keys.bsk_ntt32 is not None
    s = ck.encrypt("Hi th", 1)
    assert ck.decrypt(loaded.to_upper(s)) == "HI TH"

    # cache hit path: same file, no re-pack
    srv2 = ck.get_server_key(cache_path=path)
    assert ck.decrypt_char(srv2.contains_clear(s, "th")) == 1


# ---------------------------------------------------------------------------
# the five kinds across the two packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=FAMILIES, ids=lambda p: p.name)
def pair(request):
    """A port ClientKey and a JAX ClientKey from the same seed (the same
    keys) at one CI family."""
    p = request.param
    ck = ClientKey(p, seed=31, device="cpu")
    jck = JaxClientKey(JAX_PARAMS[p.name], seed=31)
    np.testing.assert_array_equal(ck._server_raw.bsk, jck._server_raw.bsk)
    return ck, jck


def dataclasses_equal(a, b):
    """The two packages' CryptoParams are different classes."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_device_keys(got, want):
    for field in DEVICE_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert torch.equal(a, b), field


def _jax_device_keys_equal(got, want):
    for field in ("bsk_limbs", "ksk_limbs"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_client_key_across_packages(pair, tmp_path, direction):
    ck, jck = pair
    path = str(tmp_path / "ck.npz")
    if direction == "port_to_jax":
        serialize.save_client_key(path, ck)
        loaded = jser.load_client_key(path)
        assert loaded.decrypt(jck.encrypt("abc", 1)) == "abc"
        t = loaded.encrypt("xyz", 1)
        assert ck.decrypt(FheString(blocks_from_numpy(
            jtorus.to_numpy(t.blocks.ct), "cpu"))) == "xyz"
    else:
        jser.save_client_key(path, jck)
        loaded = serialize.load_client_key(path, device="cpu")
        s = loaded.encrypt("xyz", 1)
        assert ck.decrypt(s) == "xyz"
    for name in ("lwe_sk", "glwe_sk"):
        np.testing.assert_array_equal(getattr(loaded.secret, name),
                                      getattr(ck.secret, name))
    for name in ("bsk", "ksk"):
        np.testing.assert_array_equal(getattr(loaded._server_raw, name),
                                      getattr(ck._server_raw, name))
    assert dataclasses_equal(loaded.params, ck.params)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_server_key_across_packages(pair, tmp_path, direction):
    ck, jck = pair
    path = str(tmp_path / "sk.npz")
    if direction == "port_to_jax":
        serialize.save_server_key(path, ck)
        loaded = jser.load_server_key(path, with_ntt2=False)
        _jax_device_keys_equal(loaded.backend.sc.keys,
                               jkeys.pack_server_keys(jck._server_raw))
    else:
        jser.save_server_key(path, jck)
        loaded = serialize.load_server_key(path, device="cpu")
        _same_device_keys(loaded.backend.sc.keys, keys.pack_server_keys(
            ck._server_raw, "cpu"))
    assert dataclasses_equal(loaded.params, ck.params)


@pytest.mark.parametrize("with_ntt2", [True, False], ids=["ntt", "no_ntt"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_packed_server_key_across_packages(pair, tmp_path, direction,
                                           with_ntt2):
    """The JAX loader reads the port's file as its own packing of the same
    keys (limb planes; the port's NTT keys are under names it ignores);
    the port loads the JAX file into what it packs itself, rebuilding the
    NTT-domain key where the file has the JAX one."""
    ck, jck = pair
    path = str(tmp_path / "packed.npz")
    if direction == "port_to_jax":
        srv = ck.get_server_key(with_ntt2)
        serialize.save_packed_server_key(path, srv)
        data = np.load(path, allow_pickle=False)
        assert not set(serialize._PACKED_OPTIONAL) & set(data.files)
        loaded = jser.load_packed_server_key(path)
        _jax_device_keys_equal(loaded.backend.sc.keys,
                               jkeys.pack_server_keys(jck._server_raw))
        # and back: the port reads its own file into the keys it saved
        again = serialize.load_packed_server_key(path, device="cpu")
        _same_device_keys(again.backend.sc.keys, srv.backend.sc.keys)
    else:
        jsrv = jck.get_server_key(with_ntt2=with_ntt2)
        jser.save_packed_server_key(path, jsrv)
        loaded = serialize.load_packed_server_key(path, device="cpu")
        _same_device_keys(loaded.backend.sc.keys,
                          ck.get_server_key(with_ntt2).backend.sc.keys)
    assert dataclasses_equal(loaded.params, ck.params)


@pytest.mark.parametrize("writer", ["port_listing_bsk_ntt", "jax_with_ntt"])
def test_packed_key_with_use_ntt_key_round_trips(tmp_path, writer):
    """Files that hold the key of the JAX package's use_ntt route, which
    the port runs no more: a file of the port that lists the fields
    ``["bsk_ntt64", "bsk_ntt"]`` loads with ``bsk_ntt64`` (the name
    ``bsk_ntt`` asks for nothing) and serves the saved key's bits; a JAX
    file packed ``with_ntt=True`` loads as a limb-only key and gives the
    JAX package's bits."""
    p = PARAM_TEST_ZERO_NOISE
    ck = ClientKey(p, seed=8, device="cpu")
    path = str(tmp_path / "ntt.npz")
    rng = np.random.default_rng(8)
    cts = np.stack([ref.shortint_encrypt(ck.secret, m, rng)
                    for m in range(8)])
    idx = torch.zeros(len(cts), dtype=torch.int64)
    bank = keys.pack_luts([TABLE], p, "cpu")
    if writer == "port_listing_bsk_ntt":
        srv = ck.get_server_key()
        serialize.save_packed_server_key(path, srv)
        arrays = dict(np.load(path))
        arrays["torch_hats_fields"] = json.dumps(["bsk_ntt64", "bsk_ntt"])
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        want_keys = srv.backend.sc.keys
        want = pbs.pbs_batch(torus.from_numpy(cts), idx, bank, want_keys)
    else:
        jck = JaxClientKey(jparams.PARAM_TEST_ZERO_NOISE, seed=8)
        from fhestring_tpu.server import ServerKey as JaxServerKey

        jdev = jkeys.pack_server_keys(jck._server_raw, with_ntt=True)
        jser.save_packed_server_key(path, JaxServerKey(jdev, jck.params))
        want_keys = keys.pack_server_keys(ck._server_raw, "cpu",
                                          with_ntt2=False)
        want = torus.from_numpy(jtorus.to_numpy(jpbs.pbs_batch(
            jtorus.from_numpy(cts), jnp.zeros(len(cts), jnp.int32),
            jkeys.pack_luts([TABLE], jck.params), jdev)))
    dk = serialize.load_packed_server_key(path, device="cpu").backend.sc.keys
    _same_device_keys(dk, want_keys)
    assert (dk.bsk_ntt64 is None) == (writer == "jax_with_ntt")
    got = pbs.pbs_batch(torus.from_numpy(cts), idx, bank, dk)
    assert torch.equal(got, want)
    assert [ref.shortint_decrypt(ck.secret, c) for c in torus.to_numpy(
        got)] == [TABLE[m] for m in range(8)]


@pytest.mark.parametrize("p", FAMILIES, ids=lambda p: p.name)
def test_packed_file_lists_the_ntt_key_and_stores_no_copy(tmp_path, p):
    """The port's NTT-domain key is not stored: the file holds the JAX
    arrays and the list of fields to rebuild, and the key rebuilt from the
    limb planes is the packed one."""
    ck = ClientKey(p, seed=9, device="cpu")
    srv = ck.get_server_key()
    path = str(tmp_path / "packed.npz")
    serialize.save_packed_server_key(path, srv)
    family = "bsk_ntt32" if p.torus_bits == 32 else "bsk_ntt64"
    data = np.load(path)
    assert sorted(data.files) == sorted(
        ["version", "kind", "params", "bsk_limbs", "ksk_limbs",
         "torch_hats_fields"])
    assert str(data["torch_hats_fields"]) == f'["{family}"]'
    dk = serialize.load_packed_server_key(path, device="cpu").backend.sc.keys
    _same_device_keys(dk, srv.backend.sc.keys)


@pytest.mark.parametrize("kind", ["fhe_string", "fhe_char"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_ciphertexts_across_packages(pair, tmp_path, direction, kind):
    ck, jck = pair
    path = str(tmp_path / f"{kind}.npz")
    save, load = {
        ("fhe_string", "port_to_jax"): (serialize.save_fhe_string,
                                        jser.load_fhe_string),
        ("fhe_string", "jax_to_port"): (jser.save_fhe_string,
                                        serialize.load_fhe_string),
        ("fhe_char", "port_to_jax"): (serialize.save_fhe_char,
                                      jser.load_fhe_char),
        ("fhe_char", "jax_to_port"): (jser.save_fhe_char,
                                      serialize.load_fhe_char),
    }[(kind, direction)]
    maker = ck if direction == "port_to_jax" else jck
    ct = maker.encrypt("q-z", 2) if kind == "fhe_string" \
        else maker.encrypt_char(ord("q"))
    ct.blocks.degree, ct.blocks.noise_var = 2, 1.5
    save(path, ct)
    if direction == "port_to_jax":
        got = load(path)
        bits = jtorus.to_numpy(got.blocks.ct)
        assert (jck.decrypt(got) if kind == "fhe_string"
                else jck.decrypt_char(got)) == ("q-z" if kind == "fhe_string"
                                                else ord("q"))
    else:
        got = load(path, device="cpu")
        bits = to_numpy(got.blocks)
    want = (to_numpy(ct.blocks) if direction == "port_to_jax"
            else jtorus.to_numpy(ct.blocks.ct))
    np.testing.assert_array_equal(bits, want)
    assert (got.blocks.degree, got.blocks.noise_var) == (2, 1.5)


# ---------------------------------------------------------------------------
# a packed key from one package serves in the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_packed_key_serves_in_the_other_package(pair, tmp_path, direction):
    """to_upper through the loaded key equals the saver's own output on the
    same ciphertext, bit for bit (both CPU paths are exact)."""
    ck, jck = pair
    path = str(tmp_path / "packed.npz")
    jin = jck.encrypt("Hi", 1)
    pin = FheString(blocks_from_numpy(jtorus.to_numpy(jin.blocks.ct), "cpu"))
    if direction == "port_to_jax":
        srv = ck.get_server_key(False)
        serialize.save_packed_server_key(path, srv)
        want = to_numpy(srv.to_upper(pin).blocks)
        got = jtorus.to_numpy(
            jser.load_packed_server_key(path).to_upper(jin).blocks.ct)
    else:
        jsrv = jck.get_server_key()
        jser.save_packed_server_key(path, jsrv)
        want = jtorus.to_numpy(jsrv.to_upper(jin).blocks.ct)
        got = to_numpy(serialize.load_packed_server_key(
            path, device="cpu").to_upper(pin).blocks)
    np.testing.assert_array_equal(got, want)
    assert jck.decrypt(jin) == "Hi"
    assert ck.decrypt(FheString(blocks_from_numpy(got, "cpu"))) == "HI"


# ---------------------------------------------------------------------------
# get_server_key(cache_path=)
# ---------------------------------------------------------------------------

def _refuse_packing(monkeypatch):
    from fhestring_tpu_torch import client

    def refuse(*args, **kwargs):
        raise AssertionError("packed although the cache holds the keys")

    monkeypatch.setattr(client, "pack_server_keys", refuse)


def test_cache_miss_then_hit(tmp_path, monkeypatch):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=12, device="cpu")
    path = str(tmp_path / "cache")                  # no .npz suffix
    srv = ck.get_server_key(cache_path=path)
    assert [f.name for f in tmp_path.iterdir()] == ["cache"]
    _refuse_packing(monkeypatch)
    hit = ck.get_server_key(cache_path=path)
    _same_device_keys(hit.backend.sc.keys, srv.backend.sc.keys)


def test_cache_of_another_parameter_set_is_refused(tmp_path):
    path = str(tmp_path / "cache.npz")
    ClientKey(PARAM_TEST32_ZERO_NOISE, seed=1, device="cpu").get_server_key(
        cache_path=path)
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=1, device="cpu")
    with pytest.raises(ValueError, match="test32_zero_noise"):
        ck.get_server_key(cache_path=path)


def test_cache_without_ntt_key_is_repacked(tmp_path, monkeypatch):
    """A file packed without the NTT-domain key serves a with_ntt2=False
    request as it is, and is re-packed and overwritten for one that asks
    for the key; after that it is a hit."""
    ck = ClientKey(PARAM_TEST32_ZERO_NOISE, seed=2, device="cpu")
    path = str(tmp_path / "cache.npz")
    ck.get_server_key(False, path)
    assert "torch_hats_fields" not in np.load(path).files
    assert ck.get_server_key(False, path).backend.sc.keys.bsk_ntt32 is None
    srv = ck.get_server_key(True, path)
    assert srv.backend.sc.keys.bsk_ntt32 is not None
    assert str(np.load(path)["torch_hats_fields"]) == '["bsk_ntt32"]'
    _refuse_packing(monkeypatch)
    hit = ck.get_server_key(True, path)
    _same_device_keys(hit.backend.sc.keys, srv.backend.sc.keys)
