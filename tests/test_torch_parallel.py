"""Twins of tests/test_parallel.py: the port's ``parallel.py`` on
``torch.distributed`` ranks (gloo, CPU) against the JAX package's sharded
functions on the 8-device virtual mesh (tests/conftest.py).

The same numpy inputs (``ref.keygen(PARAM_TEST_ZERO_NOISE,
default_rng(7))``, the same tables and seeds) go through both; every
output is compared bit for bit (tolerance 0).  The port runs at world 2
and, where the JAX code allows it, at world 4: one ``run_ranks`` spawn
per world (``dryrun.in_turn`` over the rank functions of ``dryrun``), in
a module fixture; every rank loads the JAX test's server key from a file
the port packed and saved.  The key-sharded PBS needs (k+1) % world == 0,
so at world 4 it is not run (the JAX test runs it on a 2-device mesh as
well).  A hung rank fails the spawn within 60 s.
"""

import dataclasses

import jax
import numpy as np
import pytest

from fhestring_tpu import PARAM_TEST_ZERO_NOISE as JP
from fhestring_tpu import parallel as jparallel
from fhestring_tpu import torus as jtorus
from fhestring_tpu.crypto import keys as dkeys
from fhestring_tpu.crypto import ntt2
from fhestring_tpu.crypto import pbs as dpbs
from fhestring_tpu.numpy_ref import core as jref
from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE, dryrun, metrics
from fhestring_tpu_torch import parallel as tparallel
from fhestring_tpu_torch import serialize
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.crypto import keys as tkeys
from fhestring_tpu_torch.server import ServerKey
from fhestring_tpu_torch.crypto import ntt_plan

N, PRIME = 2048, ntt2.PRIMES3[1]  # 40961
PBS_TABLE = [(5 * m + 2) % 16 for m in range(16)]
KEY_TABLE = [(3 * m + 1) % 16 for m in range(16)]
CONTAINS = ("sixteen chars ab", "chars", 8)  # text, pattern, padding
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def inputs():
    """The inputs of tests/test_parallel.py, drawn in its order."""
    rng = np.random.default_rng(7)
    sk, srv = jref.keygen(JP, rng)
    msgs = rng.integers(0, 16, size=16)
    cts = np.stack([jref.shortint_encrypt(sk, int(m), rng) for m in msgs])
    kmsgs = rng.integers(0, 16, size=8)
    kcts = np.stack([jref.shortint_encrypt(sk, int(m), rng) for m in kmsgs])
    x = np.random.default_rng(0).integers(-127, 128, size=(3, N)).astype(
        np.int32)
    r1 = np.random.default_rng(1)
    ahat = r1.integers(-(PRIME // 2), PRIME // 2 + 1, size=(3, N)).astype(
        np.int32)
    x2 = r1.integers(-127, 128, size=(2, N)).astype(np.int32)
    r2 = np.random.default_rng(2)
    R, B = 4, 2
    digits = r2.integers(-127, 128, size=(R, B, N)).astype(np.int32)
    key = r2.integers(-127, 128, size=(R, N)).astype(np.int64)
    plan = ntt2.make_neg_plan(PRIME, N)
    khat = np.stack([ntt2.neg_fwd(key[i], plan) for i in range(R)])
    khat = np.broadcast_to(khat[:, None], (R, B, N)).astype(np.int32)
    x2_hat = ntt2.neg_fwd(x2.astype(np.int64), plan)
    return dict(sk=sk, srv=srv, dev=dkeys.pack_server_keys(srv), msgs=msgs,
                cts=cts, kmsgs=kmsgs, kcts=kcts, x=x, ahat=ahat, x2=x2,
                x2_hat=x2_hat, digits=digits, khat=khat)


def _pbs_call(fn, key_path, cts, table, **mode):
    return (fn, (key_path, cts, np.zeros(len(cts), np.int64), [table]),
            mode)


def _poly_call(fn, *arrays):
    return (dryrun.poly_sharded, (fn,) + arrays, dict(n_poly=N, prime=PRIME))


def _calls(inp, world, key_path):
    calls = {
        "pbs": _pbs_call(dryrun.batch_sharded, key_path, inp["cts"],
                         PBS_TABLE),
        "fwd": _poly_call(tparallel.ntt_fwd_poly_sharded, inp["x"]),
        "inv": _poly_call(tparallel.ntt_inv_poly_sharded, inp["ahat"]),
        "round_trip": _poly_call(tparallel.ntt_inv_poly_sharded,
                                 inp["x2_hat"]),
        "ext": _poly_call(tparallel.ext_group_poly_sharded, inp["digits"],
                          inp["khat"]),
    }
    if world == 2:
        calls["contains"] = (dryrun.lane_sharded_contains,
                             (PARAM_TEST_ZERO_NOISE, 9) + CONTAINS, {})
        calls["keysharded"] = _pbs_call(dryrun.key_sharded, key_path,
                                        inp["kcts"], KEY_TABLE)
    else:  # a batch the world does not divide: padded, then cut back
        calls["pbs14"] = _pbs_call(dryrun.batch_sharded, key_path,
                                   inp["cts"][:14], PBS_TABLE)
    return calls


@pytest.fixture(scope="module")
def key_path(inputs, tmp_path_factory):
    """The JAX test's server key, packed by the port and saved with
    serialize: every rank loads it."""
    path = str(tmp_path_factory.mktemp("keys") / "server_key.npz")
    serialize.save_packed_server_key(path, ServerKey(
        tkeys.pack_server_keys(inputs["srv"], "cpu", PARAM_TEST_ZERO_NOISE),
        PARAM_TEST_ZERO_NOISE))
    return path


def _run(inp, world, key_path):
    calls = _calls(inp, world, key_path)
    recs = tparallel.run_ranks(world, dryrun.in_turn, list(calls.values()),
                               device="cpu", timeout=TIMEOUT)
    return {name: [r[i] for r in recs] for i, name in enumerate(calls)}


@pytest.fixture(scope="module")
def world2(inputs, key_path):
    return _run(inputs, 2, key_path)


@pytest.fixture(scope="module")
def world4(inputs, key_path):
    return _run(inputs, 4, key_path)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def port(request, world2, world4):
    return {2: world2, 4: world4}[request.param]


@pytest.fixture(scope="module")
def jax_out(inputs):
    """The JAX package's sharded functions on the 8-device mesh (the
    key-sharded PBS on 2 devices), once for both worlds."""
    mesh = jparallel.make_poly_mesh(8)
    return dict(
        pbs=_jax_pbs(inputs, inputs["cts"], PBS_TABLE,
                     jparallel.pbs_batch_sharded, jparallel.make_mesh(8)),
        fwd=np.asarray(jparallel.ntt_fwd_poly_sharded(inputs["x"], N, PRIME,
                                                      mesh)),
        inv=np.asarray(jparallel.ntt_inv_poly_sharded(inputs["ahat"], N,
                                                      PRIME, mesh)),
        ext=np.asarray(jparallel.ext_group_poly_sharded(
            inputs["digits"], inputs["khat"], N, PRIME, mesh)))


def _same_on_every_rank(recs):
    """Every rank returns the whole result; they must agree."""
    for r in recs[1:]:
        np.testing.assert_array_equal(r["out"], recs[0]["out"])
    return recs[0]["out"]


def test_mesh_has_8_devices_and_ranks_run(world2, world4):
    """The JAX side has its 8 virtual devices; each port world ran."""
    assert len(jax.devices()) == 8
    assert len(world2["pbs"]) == 2 and len(world4["pbs"]) == 4


def _jax_pbs(inp, cts, table, fn=None, mesh=None):
    bank = dkeys.pack_luts([table], JP)
    idx = np.zeros(len(cts), np.int32)
    dct = jtorus.from_numpy(cts)
    if fn is None:
        return jtorus.to_numpy(dpbs.pbs_batch(dct, idx, bank, inp["dev"]))
    return jtorus.to_numpy(fn(dct, idx, bank, inp["dev"], mesh))


def test_sharded_pbs_matches_unsharded(inputs, jax_out, port):
    got = _same_on_every_rank(port["pbs"])
    np.testing.assert_array_equal(got, jax_out["pbs"])
    for i, m in enumerate(inputs["msgs"]):
        assert jref.shortint_decrypt(inputs["sk"], got[i]) == PBS_TABLE[m]


def test_sharded_pbs_pads_a_batch_the_world_does_not_divide(inputs, world4):
    want = _jax_pbs(inputs, inputs["cts"][:14], PBS_TABLE)
    got = _same_on_every_rank(world4["pbs14"])
    assert got.shape == (14, JP.big_lwe_dimension + 1)
    np.testing.assert_array_equal(got, want)


def test_lane_sharded_contains_matches(world2):
    """The lane-sharded contains decrypts to 1 (as the JAX test's GSPMD
    run), with the counts of an unsharded run (bootstrap stubbed: the
    counts do not depend on it)."""
    text, pattern, padding = CONTAINS
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=9, device="cpu")
    srv = ck.get_server_key()
    s, pat = ck.encrypt(text, padding), ck.encrypt_no_padding(pattern)
    with dryrun.identity_bootstrap():
        metrics.reset()
        srv.contains(s, pat)
    alone = (metrics.GLOBAL.pbs_items, metrics.GLOBAL.pbs_calls)
    recs = world2["contains"]
    assert recs[0]["result"] == 1
    assert all(r["pbs"] == alone for r in recs)
    assert alone[0] > 0


def test_keysharded_pbs_matches_unsharded(inputs, world2):
    """BSK column-sharded, KSK row-sharded (exact mode): bit-identical to
    the JAX key-sharded PBS on a 2-device mesh (which tests/test_parallel.py
    holds to pbs_batch)."""
    want = _jax_pbs(inputs, inputs["kcts"], KEY_TABLE,
                    jparallel.pbs_batch_keysharded,
                    jparallel.make_key_mesh(2))
    recs = world2["keysharded"]
    got = _same_on_every_rank(recs)
    np.testing.assert_array_equal(got, want)
    for i, m in enumerate(inputs["kmsgs"]):
        assert jref.shortint_decrypt(inputs["sk"], got[i]) == KEY_TABLE[m]
    # each rank held half of each key
    for r in recs:
        assert r["bytes"] == {k: v // 2 for k, v in
                              r["unsharded_bytes"].items()}


def test_ntt_fwd_poly_sharded_bit_identical(inputs, jax_out, port):
    got = _same_on_every_rank(port["fwd"])
    np.testing.assert_array_equal(got, jax_out["fwd"])
    plan = ntt_plan.make_neg_plan(PRIME, N)
    np.testing.assert_array_equal(got, ntt_plan.neg_fwd(inputs["x"], plan))


def test_ntt_inv_poly_sharded_bit_identical(jax_out, port):
    np.testing.assert_array_equal(_same_on_every_rank(port["inv"]),
                                  jax_out["inv"])


def test_ntt_inv_poly_sharded_round_trip(inputs, port):
    """inv(fwd(x)) == x (sigma_0 folds 1/N): the port's sharded inverse of
    the forward's hats gives the input polynomials back."""
    np.testing.assert_array_equal(_same_on_every_rank(port["round_trip"]),
                                  inputs["x2"])


def test_ext_group_poly_sharded_bit_identical(jax_out, port):
    np.testing.assert_array_equal(_same_on_every_rank(port["ext"]),
                                  jax_out["ext"])


def test_ntt_plan_is_the_jax_plan():
    """``crypto/ntt_plan.py`` is a copy of ntt2's plan: the same constants
    at every supported prime, and the same transforms."""
    for prime in (PRIME, ntt2.PRIMES3[2]):
        ours, theirs = (ntt_plan.make_neg_plan(prime, N),
                        ntt2.make_neg_plan(prime, N))
        for f in dataclasses.fields(theirs):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if isinstance(b, tuple):
                assert len(a) == len(b)
                for u, v in zip(a, b):
                    np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, size=(2, N))
    plan = ntt_plan.make_neg_plan(PRIME, N)
    jplan = ntt2.make_neg_plan(PRIME, N)
    np.testing.assert_array_equal(ntt_plan.neg_fwd(x, plan),
                                  ntt2.neg_fwd(x, jplan))
    h = ntt2.neg_fwd(x, jplan)
    for g in range(ntt_plan.NUM_GROUPS):
        np.testing.assert_array_equal(ntt_plan.neg_inv(h, plan, g),
                                      ntt2.neg_inv(h, jplan, g))


def test_run_ranks_reports_a_failing_rank():
    """A rank that raises fails the run with its traceback; ranks not done
    in time are killed and fail it too."""
    bad = [_poly_call(tparallel.ntt_fwd_poly_sharded,
                      np.zeros((1, 100), np.int32))]
    bad[0][2]["n_poly"] = 100
    with pytest.raises(tparallel.RankError, match="failed:"):
        tparallel.run_ranks(2, dryrun.in_turn, bad, device="cpu",
                            timeout=TIMEOUT)
    with pytest.raises(tparallel.RankError, match="not done within"):
        tparallel.run_ranks(2, dryrun.in_turn, bad, device="cpu",
                            timeout=0.5)


def test_run_ranks_defaults_to_the_card(monkeypatch):
    """run_ranks with no device means the card: where there is none it
    raises, naming device="cpu", before it spawns a rank, and never falls
    back to the CPU."""
    import inspect

    import torch

    assert inspect.signature(tparallel.run_ranks).parameters[
        "device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tparallel.run_ranks(2, dryrun.dryrun_multichip)
