"""The port's torch FheBackend: the repairs it carries and the engine paths
beyond the six slice methods.

- ``FheBackend.scan`` is an eager Python loop, so a PBS inside its body is
  counted once per executed step; the port's metrics has no scan
  multiplier.  Counts of a scan-based method equal the JAX package's
  (whose traced ``lax.scan`` restores them with ``scan_scope``).
- ``FheBackend.dynamic_slice`` / ``dynamic_update_slice`` clamp the start
  as ``jax.lax.dynamic_slice`` and ``ClearBackend.dynamic_slice`` do.

Tolerance: zero.  Outputs are exact: ciphertexts bit-identical to the JAX
package's, decrypted values equal to the clear backend's.
"""

import numpy as np
import pytest
import torch

from fhestring_tpu import metrics as jmetrics
from fhestring_tpu import torus as jtorus
from fhestring_tpu.client import ClientKey as JaxClientKey
from fhestring_tpu.params import PARAM_TEST32_ZERO_NOISE as JAX_P
from fhestring_tpu_torch import PARAM_TEST32_ZERO_NOISE, metrics
from fhestring_tpu_torch.ciphertext import FheString, blocks_from_numpy, to_numpy
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.engine.backend import ClearBackend

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

P = PARAM_TEST32_ZERO_NOISE


@pytest.fixture(scope="module")
def client():
    ck = ClientKey(P, seed=9, device="cpu")
    return ck, ck.get_server_key()


def test_scan_counts_each_step_once(client):
    ck, srv = client
    b = srv.backend
    x = b.trivial_bits(np.ones(3, np.uint8))

    def body(carry, step):
        return b.declare_bits(b.not_(b.and_(carry, carry)), 1, 1.0)

    metrics.reset()
    out = b.scan(body, x, {"i": np.arange(5)}, 5)
    assert metrics.GLOBAL.pbs_calls == 5
    assert metrics.GLOBAL.pbs_items == 15
    assert ck.decrypt_bits(out).tolist() == [0, 0, 0]


def test_scan_method_counts_match_jax_package(client):
    """replace with a longer `to` runs the engine's scan path."""
    jck = JaxClientKey(JAX_P, seed=9)
    jsrv = jck.get_server_key()
    js = jck.encrypt("aX", 1)
    jmetrics.reset()
    jout = jsrv.replace_clear(js, "X", "yz")
    jcounts = (jmetrics.GLOBAL.pbs_calls, jmetrics.GLOBAL.pbs_items)

    ck, srv = client
    s = FheString(blocks_from_numpy(jtorus.to_numpy(js.blocks.ct), "cpu"))
    metrics.reset()
    out = srv.replace_clear(s, "X", "yz")
    assert (metrics.GLOBAL.pbs_calls, metrics.GLOBAL.pbs_items) == jcounts
    np.testing.assert_array_equal(to_numpy(out.blocks),
                                  jtorus.to_numpy(jout.blocks.ct))
    assert jck.decrypt(jout) == "ayz"


@pytest.mark.parametrize("start", [-3, 0, 2, 4, 9])
def test_dynamic_slice_clamps_like_clear_backend(client, start):
    ck, srv = client
    b, clear = srv.backend, ClearBackend()
    vals = np.arange(1, 7, dtype=np.uint8)
    chars = b.trivial_chars(vals)
    got = b.dynamic_slice(chars, start, 3)
    assert ck.decrypt_blocks_to_bytes(got).tolist() == \
        clear.dynamic_slice(vals, start, 3).tolist()
    bits = b.trivial_bits(vals & 1)
    got = b.dynamic_slice_bits(bits, start, 2)
    assert ck.decrypt_bits(got).tolist() == \
        clear.dynamic_slice(vals & 1, start, 2).tolist()


@pytest.mark.parametrize("start", [-1, 1, 5])
def test_dynamic_update_slice_clamps_like_clear_backend(client, start):
    ck, srv = client
    b, clear = srv.backend, ClearBackend()
    vals = np.arange(1, 7, dtype=np.uint8)
    upd = np.array([100, 101], np.uint8)
    got = b.dynamic_update_slice(b.trivial_chars(vals), b.trivial_chars(upd),
                                 start)
    assert ck.decrypt_blocks_to_bytes(got).tolist() == \
        clear.dynamic_update_slice(vals, upd, start).tolist()
