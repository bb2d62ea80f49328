"""The port's multi-process dry run (``fhestring_tpu_torch.dryrun``), the
twin of ``__graft_entry__.dryrun_multichip``, at world 2 over gloo on the
CPU at PARAM_TEST_ZERO_NOISE.

Every stage checks itself inside the ranks and raises on a wrong result:
the lane-sharded contains and the key-sharded PBS decrypt to Python's
answers (the latter also bit-identical to ``pbs_batch``).  The two split
stages run with the bootstrap replaced by the identity
(``dryrun.identity_bootstrap``) in the sharded and in the unsharded run,
held equal bit for bit and in counts: a real split costs thousands of
bootstraps (the query split + trim, over a minute a rank on one CPU
core), which does not fit Tier-1.  One spawn, in a module fixture; a hung
rank fails it within 60 s.
"""

import os

import pytest

from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE, dryrun, parallel

WORLD = 2


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    key_path = os.path.join(tmp_path_factory.mktemp("dryrun"), "key.npz")
    return parallel.run_ranks(
        WORLD, dryrun.dryrun_multichip, PARAM_TEST_ZERO_NOISE, None, None,
        key_path, True, device="cpu", timeout=60.0)


def test_lane_sharded_contains(records):
    """"abab" + 2 NULs, lane-sharded, contains "b": rank 0 decrypts 1, and
    every rank counted the same batches."""
    rec = records[0]["contains"]
    assert rec["result"] == 1
    assert rec["padding"] == WORLD
    assert rec["pbs"][0] > 0
    assert all(r["contains"]["pbs"] == rec["pbs"] for r in records)


def test_query_sharded_split_trim(records):
    """One query a rank; the gathered results are each query's own."""
    rec = records[0]["split_trim"]
    assert rec["queries"] == ["a0 b0", "a1 b1"]
    assert rec["pbs"][1] > 0
    assert all(r["split_trim"]["pbs"] == rec["pbs"] for r in records)


def test_key_sharded_pbs(records):
    """On a group of k+1 = 2 ranks, each holding half of each key."""
    p = PARAM_TEST_ZERO_NOISE
    rows = p.big_lwe_dimension * p.ks_level // WORLD       # of K
    for r in records:
        assert r["keysharded"]["bytes"] == {
            "ksk": rows * (p.lwe_dimension + 1) * 8,
            "bsk": p.lwe_dimension * 2 * 1 * 8 * 2 * p.polynomial_size}


def test_lane_sharded_split_is_one_ranks(records):
    """Sharded and unsharded identity runs agree (checked in the ranks);
    every rank has the same bits."""
    import numpy as np

    bufs = [r["lane_split"]["buffers"] for r in records]
    assert bufs[0].ndim == 4
    for b in bufs[1:]:
        np.testing.assert_array_equal(b, bufs[0])
    assert records[0]["lane_split"]["pbs"][1] > 0


def test_command_line_wants_a_card(capsys, monkeypatch):
    """The default device is the card: without one, exit 2 and say so."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["--world", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
