"""PBS counters and the span recorder (metrics.py).

On the port: a twin of tests/test_metrics.py with the imports switched to
fhestring_tpu_torch and the keys on the CPU; where the JAX package's
``measure()`` records a block, the port's span recorder records the
server's method.  Its fourth test, exec_count_scope under a caller's
jax.jit, has no counterpart: the port counts every PBS eagerly and has no
exec_count_scope."""

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

    metrics.record_spans(True)
    try:
        bit = srv.contains(s, pat)
    finally:
        metrics.record_spans(False)
    assert ck.decrypt_char(bit) == 1

    g = metrics.GLOBAL
    assert g.pbs_calls > 0 and g.pbs_items > 0
    assert g.pbs_items_padded >= g.pbs_items
    assert g.host_copies > 0
    top = [x for x in metrics.spans() if x.parent is None]
    assert [x.name for x in top] == ["server.contains"]
    assert top[0].t1_ns > top[0].t0_ns

    tot = metrics.span_totals()
    assert tot["server.contains"]["count"] == 1
    assert tot["pbs.dispatch"]["count"] == g.pbs_calls
    assert tot["copy"]["count"] == g.host_copies
    assert 0 < tot["server.contains"]["self_ms"] < tot["server.contains"]["ms"]


def test_reset_clears():
    metrics.record_spans(True)
    try:
        with metrics.span("x"):
            metrics.record_pbs(3, 8)
            metrics.GLOBAL.host_copies += 1
    finally:
        metrics.record_spans(False)
    assert metrics.spans() and metrics.GLOBAL.pbs_calls
    metrics.reset()
    assert metrics.GLOBAL == metrics.Counters()
    assert metrics.spans() == []
    assert metrics.span_totals() == {}


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


def test_counters_are_exact_under_threads():
    """Threads that count at once, switching every microsecond, lose no
    count: the copies (``torus.to_device``), the dispatches
    (``record_pbs``) and the scans' steps (``FheBackend.scan``)."""
    import sys
    import threading

    from fhestring_tpu_torch import torus
    from fhestring_tpu_torch.engine.backend import FheBackend

    metrics.reset()
    threads, rounds = 8, 3000
    t = torch.zeros(2, dtype=torch.int64)

    def work():
        for _ in range(rounds):
            torus.to_device(t, "cpu")
            metrics.record_pbs(2, 8)
            FheBackend.scan(None, lambda carry, x: carry, 0, {}, 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    g, n = metrics.GLOBAL, threads * rounds
    assert (g.host_copies, g.pbs_calls, g.pbs_items, g.pbs_items_padded,
            g.scan_steps) == (n, n, 2 * n, 8 * n, 3 * n)
    metrics.reset()
