"""The served slice end to end: ClientKey -> ServerKey -> decrypt, the port
against the JAX package, at the 32-bit CI set and at the 64-bit one.

Both ServerKeys are built from the same numpy ServerKeys (the JAX
ClientKey's) and get the same encrypted strings ("hello world" x "ello", as
benchmarks/methods.py sends them).  For contains, contains_clear, to_upper,
len, eq and find the port's output ciphertexts must be identical to the
JAX package's, decrypt to what Python's str gives, and cost the same PBS
calls and items as the JAX package's metrics count.  Those counts depend
only on the string lengths and the set's noise budget; they are also the
counts of benchmarks/methods_turbo_r5c.jsonl (32-bit set, budget 192) and
of chip_smoke.py's table for PARAM_PROD (budget 34, as PARAM_TEST_ZERO_NOISE),
which the card's run holds its counts to.

Tolerance: zero.  Every layer is exact integer arithmetic.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fhestring_tpu import metrics as jmetrics
from fhestring_tpu import params as jparams
from fhestring_tpu import torus as jtorus
from fhestring_tpu.client import ClientKey as JaxClientKey
from fhestring_tpu_torch import (PARAM_TEST32_ZERO_NOISE,
                                 PARAM_TEST_ZERO_NOISE, metrics)
from fhestring_tpu_torch.ciphertext import (FheString, blocks_from_numpy,
                                            to_numpy)
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.crypto.keys import pack_server_keys
from fhestring_tpu_torch.server import ServerKey

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = PARAM_TEST32_ZERO_NOISE
JAX_P = jparams.PARAM_TEST32_ZERO_NOISE
S, PAT = "hello world", "ello"
# (port set, JAX set, test-id prefix): the 32-bit ids keep the bare names
PSETS = {"q32": (P, JAX_P, ""),
         "q64": (PARAM_TEST_ZERO_NOISE, jparams.PARAM_TEST_ZERO_NOISE, "q64-")}

# method -> (call, expected, kind, (pbs_items, pbs_calls) at these strings)
METHODS = {
    "contains": (lambda k, s, p, pp: k.contains(s, p), int(PAT in S), "char", (194, 5)),
    "contains_clear": (lambda k, s, p, pp: k.contains_clear(s, PAT),
                       int(PAT in S), "char", (194, 5)),
    "to_upper": (lambda k, s, p, pp: k.to_upper(s), S.upper(), "string", (36, 3)),
    "len": (lambda k, s, p, pp: k.len(s), len(S), "char", (38, 5)),
    "eq": (lambda k, s, p, pp: k.eq(s, pp), int(S == PAT), "char", (131, 25)),
    "find": (lambda k, s, p, pp: k.find(s, p), S.find(PAT), "char", (239, 13)),
}
# chip_smoke.py's method names
SMOKE_NAMES = {"contains": "Contains", "contains_clear": "ContainsClear",
               "to_upper": "ToUpper", "len": "Len", "eq": "Eq", "find": "Find"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def both():
    """Per parameter family, built at first use: the JAX client and server,
    the port's server on the same keys, and the inputs of both."""
    made = {}

    def get(family):
        if family not in made:
            port_p, jax_p, _ = PSETS[family]
            jck = JaxClientKey(jax_p, seed=21)
            jsrv = jck.get_server_key()
            srv = ServerKey(pack_server_keys(jck._server_raw, "cpu",
                                             params=port_p), port_p)
            jin = (jck.encrypt(S, 1), jck.encrypt_no_padding(PAT),
                   jck.encrypt(PAT, 1))
            pin = tuple(FheString(blocks_from_numpy(
                jtorus.to_numpy(x.blocks.ct), "cpu")) for x in jin)
            made[family] = (jck, jsrv, srv, jin, pin, {})
        return made[family]
    return get


def _run_jax(both, family, method):
    """The JAX ServerKey's output and (calls, items, padded items), once."""
    jck, jsrv, _, jin, _, jax_runs = both(family)
    if method not in jax_runs:
        jmetrics.reset()
        jout = METHODS[method][0](jsrv, *jin)
        jax_runs[method] = (jout, (jmetrics.GLOBAL.pbs_calls,
                                   jmetrics.GLOBAL.pbs_items,
                                   jmetrics.GLOBAL.pbs_items_padded))
    return jax_runs[method]


def test_same_seed_same_keys_and_ciphertexts():
    jck = JaxClientKey(JAX_P, seed=4)
    ck = ClientKey(P, seed=4, device="cpu")
    np.testing.assert_array_equal(ck.secret.lwe_sk, jck.secret.lwe_sk)
    np.testing.assert_array_equal(ck.secret.glwe_sk, jck.secret.glwe_sk)
    np.testing.assert_array_equal(ck._server_raw.bsk, jck._server_raw.bsk)
    np.testing.assert_array_equal(ck._server_raw.ksk, jck._server_raw.ksk)
    a, b = ck.encrypt("hi there", 2), jck.encrypt("hi there", 2)
    np.testing.assert_array_equal(to_numpy(a.blocks), jtorus.to_numpy(b.blocks.ct))
    assert ck.decrypt(a) == "hi there"


def test_blocks_numpy_roundtrip():
    rng = np.random.default_rng(0)
    cts = rng.integers(0, 1 << 64, size=(3, 4, 9), dtype=np.uint64)
    blocks = blocks_from_numpy(cts, "cpu")
    assert blocks.shape == (3, 4)
    np.testing.assert_array_equal(to_numpy(blocks), cts)


CASES = [pytest.param(family, method, id=prefix + method)
         for family, (_, _, prefix) in PSETS.items() for method in METHODS]


@pytest.mark.parametrize("family,method", CASES)
def test_method_matches_jax_package(both, family, method):
    jck, jsrv, srv, jin, pin, _ = both(family)
    call, expected, kind, table_counts = METHODS[method]

    jout, jcounts = _run_jax(both, family, method)
    metrics.reset()
    out = call(srv, *pin)
    counts = (metrics.GLOBAL.pbs_calls, metrics.GLOBAL.pbs_items,
              metrics.GLOBAL.pbs_items_padded)

    np.testing.assert_array_equal(to_numpy(out.blocks),
                                  jtorus.to_numpy(jout.blocks.ct))
    got = jck.decrypt(jout) if kind == "string" else jck.decrypt_char(jout)
    assert got == (expected if expected != -1 else 255)
    assert counts == jcounts
    if family == "q32":
        assert (counts[1], counts[0]) == table_counts


@pytest.mark.parametrize("method", list(METHODS))
def test_chip_smoke_prod_counts_equal_jax_engine(both, method):
    """chip_smoke.py holds the card's PARAM_PROD run to a table of (PBS
    items, batches) per request; the JAX engine gives the same counts at
    PARAM_TEST_ZERO_NOISE (the same noise budget, 34)."""
    smoke = _chip_smoke()
    assert PARAM_TEST_ZERO_NOISE.noise_budget == smoke.PROD_NOISE_BUDGET
    _, (calls, items, _) = _run_jax(both, "q64", method)
    assert smoke.PROD_COUNTS[SMOKE_NAMES[method]] == (items, calls)
