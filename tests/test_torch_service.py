"""The port's serving layer over a real socket (``service.py``), and the
wire format both ways between the port and the JAX package.

- Twins of the three tests of tests/test_service.py on the port's server
  and client.
- A port client (``RemoteServerKey``) against the JAX package's
  ``FheStringServer``, and a JAX client against the port's: the same
  ciphertexts decrypt to Python's answers, and the port's server returns
  the bits its ServerKey computes in process.

Every server listens on 127.0.0.1 at a port the system picks and is
stopped by its fixture's finalizer; every socket, the JAX client's too
(through ``socket.setdefaulttimeout``), has a timeout, so a hang fails in
seconds.  At PARAM_TEST_ZERO_NOISE and, for the cross-package cases, also
PARAM_TEST32_ZERO_NOISE.  Tolerance: zero (decrypted values and bits).
"""

import socket

import numpy as np
import pytest
import torch

from fhestring_tpu import params as jparams
from fhestring_tpu import torus as jtorus
from fhestring_tpu.client import ClientKey as JaxClientKey
from fhestring_tpu.service import FheStringServer as JaxServer
from fhestring_tpu.service import RemoteServerKey as JaxRemote
from fhestring_tpu_torch import PARAM_TEST32_ZERO_NOISE, PARAM_TEST_ZERO_NOISE
from fhestring_tpu_torch.ciphertext import FheString, blocks_from_numpy, to_numpy
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.service import FheStringServer, RemoteServerKey

torch.set_num_threads(1)

TIMEOUT = 120.0  # seconds a socket may wait; a request here takes a few
JAX_PARAMS = {PARAM_TEST32_ZERO_NOISE.name: jparams.PARAM_TEST32_ZERO_NOISE,
              PARAM_TEST_ZERO_NOISE.name: jparams.PARAM_TEST_ZERO_NOISE}


@pytest.fixture(scope="module", autouse=True)
def socket_timeout():
    before = socket.getdefaulttimeout()
    socket.setdefaulttimeout(TIMEOUT)
    yield
    socket.setdefaulttimeout(before)


@pytest.fixture(scope="module")
def remote(request):
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=21, device="cpu")
    server = FheStringServer(ck.get_server_key()).start()
    request.addfinalizer(server.stop)
    return ck, RemoteServerKey(server.address, device="cpu", timeout=TIMEOUT)


def test_remote_predicates(remote):
    ck, srv = remote
    s = ck.encrypt("hello world", 1)
    pat = ck.encrypt_no_padding("world")
    assert ck.decrypt_char(srv.contains(s, pat)) == 1
    assert ck.decrypt_char(srv.contains_clear(s, "xyz")) == 0
    assert ck.decrypt_char(srv.len(s)) == 11


def test_remote_rewrite_and_split(remote):
    ck, srv = remote
    s = ck.encrypt("a.b", 1)
    assert ck.decrypt(srv.to_upper(s)) == "A.B"
    parts, found = ck.decrypt_split(srv.split_clear(s, "."))
    assert [p for p in parts if p] == ["a", "b"]
    assert found == 1
    out, flag = ck.decrypt_strip(srv.strip_prefix_clear(s, "a"))
    assert (out, flag) == (".b", 1)


def test_remote_error_reporting(remote):
    ck, srv = remote
    with pytest.raises(AttributeError):
        srv.not_a_method
    with pytest.raises(RuntimeError, match="KeyError"):
        srv._call("no_such_op")


def test_server_runs_on_its_keys_device(remote):
    ck, srv = remote
    assert srv.device == torch.device("cpu")
    out = srv.to_lower(ck.encrypt("Q", 1))
    assert out.blocks.ct.device.type == "cpu"
    assert ck.decrypt(out) == "q"


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module",
                params=[PARAM_TEST_ZERO_NOISE, PARAM_TEST32_ZERO_NOISE],
                ids=lambda p: p.name)
def clients(request):
    """Port and JAX ClientKeys from one seed: the same secret keys."""
    p = request.param
    return (ClientKey(p, seed=27, device="cpu"),
            JaxClientKey(JAX_PARAMS[p.name], seed=27))


@pytest.fixture(scope="module")
def jax_server(request, clients):
    _, jck = clients
    server = JaxServer(jck.get_server_key()).start()
    request.addfinalizer(server.stop)
    return server


@pytest.fixture(scope="module")
def port_server(request, clients):
    ck, _ = clients
    server = FheStringServer(ck.get_server_key()).start()
    request.addfinalizer(server.stop)
    return server


def test_port_client_against_jax_server(clients, jax_server):
    ck, _ = clients
    srv = RemoteServerKey(jax_server.address, device="cpu", timeout=TIMEOUT)
    s = ck.encrypt("ab.c", 1)
    assert ck.decrypt_char(srv.contains(s, ck.encrypt_no_padding("b."))) == 1
    assert ck.decrypt(srv.to_upper(s)) == "AB.C"
    parts, found = ck.decrypt_split(srv.split_clear(s, "."))
    assert ([p for p in parts if p], found) == (["ab", "c"], 1)


def test_jax_client_against_port_server(clients, port_server):
    """The JAX client's ciphertexts through the port's server: Python's
    answers, and the bits the port's ServerKey computes in process."""
    ck, jck = clients
    srv = JaxRemote(port_server.address)
    s = jck.encrypt("ab.c", 1)
    assert jck.decrypt_char(srv.contains_clear(s, "b.")) == 1
    up = srv.to_upper(s)
    assert jck.decrypt(up) == "AB.C"
    local = port_server.server_key.to_upper(
        FheString(blocks_from_numpy(jtorus.to_numpy(s.blocks.ct), "cpu")))
    np.testing.assert_array_equal(jtorus.to_numpy(up.blocks.ct),
                                  to_numpy(local.blocks))
    out, flag = jck.decrypt_strip(srv.strip_suffix_clear(s, ".c"))
    assert (out, flag) == ("ab", 1)
