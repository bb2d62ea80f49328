"""PBS counters and the measure() context (metrics.py).

On the port: a twin of tests/test_metrics.py with the imports switched to
fhestring_tpu_torch and the keys on the CPU.  Its fourth test,
exec_count_scope under a caller's jax.jit, has no counterpart: the port
counts every PBS eagerly and has no exec_count_scope."""

import torch

from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE, metrics
from fhestring_tpu_torch.client import ClientKey

torch.set_num_threads(1)


def test_pbs_counters_tick_and_measure():
    metrics.reset()
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=11, device="cpu")
    srv = ck.get_server_key()
    s = ck.encrypt("abc", 1)
    pat = ck.encrypt_no_padding("bc")

    with metrics.measure("contains"):
        bit = srv.contains(s, pat)
        assert ck.decrypt_char(bit) == 1

    rec = metrics.last()
    assert rec is not None and rec.name == "contains"
    assert rec.pbs_calls > 0
    assert rec.pbs_items > 0
    assert rec.pbs_items_padded >= rec.pbs_items
    assert rec.seconds > 0

    rep = metrics.report()
    assert rep["global"]["pbs_calls"] >= rec.pbs_calls
    assert rep["records"][-1]["name"] == "contains"


def test_reset_clears():
    metrics.reset()
    assert metrics.GLOBAL.pbs_calls == 0
    assert metrics.report()["records"] == []


def test_pbs_counts_identical_cold_vs_warm(monkeypatch):
    """Round-1 verdict item: PBS tallies must not undercount on jit-cached
    re-execution. Engine ops dispatch _pbs_padded eagerly and scans re-trace
    per call under scan_scope, so a warm re-run of the same method must
    count exactly the same PBS as the cold run — including a scan-based
    method (replace) and a batched split.

    The port's bootstrap is the identity here (the engine never branches on
    ciphertext values, so the counts are those of the real one): these two
    methods take minutes of real CPU bootstraps in the port.  The outputs
    are then not decryptable, and the port is eager, so the JAX test's
    decrypt (its fence for asynchronous work) is left out."""
    from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE, shortint
    from fhestring_tpu_torch.client import ClientKey

    monkeypatch.setattr(shortint, "pbs_batch",
                        lambda flat, idx, bank, keys, **route: flat)

    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=2, device="cpu")
    srv = ck.get_server_key()
    s = ck.encrypt("aXbX", 1)

    def run_once():
        metrics.reset()
        out = srv.replace_clear(s, "X", "yz")   # shorter-from: scan path
        sp = srv.split_clear(s, "X")            # split scan + batched pass
        assert len(out) and sp.buffers.ct.shape[0]
        return (metrics.GLOBAL.pbs_calls, metrics.GLOBAL.pbs_items,
                metrics.GLOBAL.pbs_items_padded)

    cold = run_once()
    warm = run_once()
    assert cold == warm, (cold, warm)
    assert cold[0] > 0
