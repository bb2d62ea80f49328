"""The port's span recorder and its ``host_copies`` and ``scan_steps``
counters (metrics.py), and the spans the service, the server, the
engine's scans, the PBS dispatch and the copies of plain data onto the
device record.

On the CPU at PARAM_TEST_ZERO_NOISE.  Where bits do not matter the
bootstrap is the identity (the engine never branches on ciphertext values,
so spans and counts are those of the real one); the cross-package cases
run real bootstraps and decrypt.  Every socket has a timeout, so a hang
fails in seconds.  Tolerance: zero (counts, ids and bits).
"""

import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fhestring_tpu.client import ClientKey as JaxClientKey
from fhestring_tpu.params import PARAM_TEST_ZERO_NOISE as JAX_P
from fhestring_tpu.service import FheStringServer as JaxServer
from fhestring_tpu.service import RemoteServerKey as JaxRemote
from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE, metrics, shortint, torus
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.service import FheStringServer, RemoteServerKey

torch.set_num_threads(1)

TIMEOUT = 120.0
SERVICE_SPANS = ["client.encode", "service.receive", "service.decode",
                 "server.{}", "service.encode", "service.send",
                 "client.decode"]
# the interactive cells' methods, each with its arguments: "s" the string,
# "p" an encrypted pattern, "t" an encrypted string, else a clear argument
METHODS = {"contains": "sp", "contains_clear": ("s", "lo"), "find": "sp",
           "starts_with_clear": ("s", "he"), "eq": "st", "to_upper": "s",
           "len": "s", "strip_prefix_clear": ("s", "he")}


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and nothing
    recorded."""
    metrics.record_spans(False)
    metrics.reset()
    yield
    metrics.record_spans(False)
    metrics.reset()


@pytest.fixture
def identity_pbs(monkeypatch):
    monkeypatch.setattr(shortint, "pbs_batch",
                        lambda flat, idx, bank, keys, **route: flat)


@pytest.fixture(scope="module")
def keys():
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=31, device="cpu")
    return ck, ck.get_server_key()


def _args(ck, spec):
    text = {"s": ck.encrypt("hello", 1), "p": ck.encrypt_no_padding("ll"),
            "t": ck.encrypt("help", 1)}
    return [text[a] if a in text else a for a in spec]


def _by_name(records, name):
    return [s for s in records if s.name == name]


def test_recorder_is_off_by_default():
    code = ("from fhestring_tpu_torch import metrics\n"
            "assert not metrics.recording()\n"
            "with metrics.span('x'):\n"
            "    pass\n"
            "assert metrics.spans() == []\n"
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_off_records_nothing(keys, identity_pbs):
    """While off: one shared no-op object for every span and request
    scope, no span from a served request, and no request id on the
    wire."""
    ck, srv = keys
    assert metrics.span("a") is metrics.span("b", width=3)
    assert metrics.span("a") is metrics.request()
    with metrics.request() as req, metrics.span("a") as sp:
        assert req is None and sp is None
    seen = []
    server = FheStringServer(srv)
    dispatch = server._dispatch

    def spy(header, blobs):
        seen.append(dict(header))
        return dispatch(header, blobs)
    server._dispatch = spy
    server.start()
    try:
        remote = RemoteServerKey(server.address, device="cpu",
                                 timeout=TIMEOUT)
        remote.len(ck.encrypt("ab", 1))
        srv.contains_clear(ck.encrypt("ab", 1), "b")
    finally:
        server.stop()
    assert metrics.spans() == []
    assert seen and "request" not in seen[0]
    assert metrics.GLOBAL.pbs_calls > 0


def test_nested_parents_and_self_time():
    metrics.record_spans(True)
    with metrics.span("outer"):
        time.sleep(0.002)
        with metrics.span("inner", width=5):
            time.sleep(0.003)
        with metrics.span("inner"):
            with metrics.span("leaf"):
                time.sleep(0.001)

    def elsewhere():
        with metrics.span("elsewhere"):
            pass
    t = threading.Thread(target=elsewhere)
    with metrics.span("second"):
        t.start()
        t.join(10)
    assert not t.is_alive()
    rec = metrics.spans()
    outer, = _by_name(rec, "outer")
    inner = _by_name(rec, "inner")
    leaf, = _by_name(rec, "leaf")
    second, = _by_name(rec, "second")
    assert outer.parent is None and [s.parent for s in inner] == [outer.id] * 2
    assert leaf.parent == inner[1].id
    assert inner[0].attrs == {"width": 5} and inner[1].attrs == {}
    assert {s.request for s in [outer, leaf] + inner} == {outer.request}
    assert second.request != outer.request
    other, = _by_name(rec, "elsewhere")   # opened while "second" was
    assert other.parent is None and other.request not in (
        second.request, outer.request)
    for s in rec:
        assert s.t0_ns <= s.t1_ns
    assert outer.t0_ns <= inner[0].t0_ns and inner[1].t1_ns <= outer.t1_ns
    tot = metrics.span_totals()
    dur = {s.id: s.t1_ns - s.t0_ns for s in rec}
    assert tot["inner"]["count"] == 2
    assert tot["outer"]["self_ms"] == pytest.approx(
        (dur[outer.id] - dur[inner[0].id] - dur[inner[1].id]) / 1e6,
        abs=1e-9)
    assert tot["inner"]["self_ms"] == pytest.approx(
        (dur[inner[0].id] + dur[inner[1].id] - dur[leaf.id]) / 1e6,
        abs=1e-9)
    assert tot["outer"]["self_ms"] >= 2.0
    assert tot["leaf"]["self_ms"] == tot["leaf"]["ms"]


def test_one_request_over_loopback(keys, identity_pbs):
    """One call: one client.call and one server.<method> under one request
    id, from two threads, with the service's spans in order inside the
    round trip; every PBS dispatch inside the method."""
    ck, srv = keys
    server = FheStringServer(srv).start()
    try:
        remote = RemoteServerKey(server.address, device="cpu",
                                 timeout=TIMEOUT)
        s, pat = ck.encrypt("hello", 1), ck.encrypt_no_padding("ll")
        metrics.record_spans(True)
        remote.contains(s, pat)
        metrics.record_spans(False)
    finally:
        server.stop()
    rec = metrics.spans()
    call, = _by_name(rec, "client.call")
    method, = _by_name(rec, "server.contains")
    assert {s.request for s in rec} == {call.request}
    order = [n.format("contains") for n in SERVICE_SPANS]
    found = [next(s for s in rec if s.name == n) for n in order]
    assert [s.t0_ns for s in found] == sorted(s.t0_ns for s in found)
    # each span ends before the next begins, but the server's thread may
    # close service.send after the client has its bytes
    for a, b in zip(found[:-2], found[1:-1]):
        assert a.t1_ns <= b.t0_ns, (a.name, b.name)
    for s in found:
        assert call.t0_ns <= s.t0_ns <= call.t1_ns
        if s.name.startswith("client."):
            assert s.t1_ns <= call.t1_ns
    # the client's spans nest in client.call; the server's thread has none
    assert {s.parent for s in found if s.name.startswith("client.")} == {
        call.id}
    assert {s.parent for s in found if not s.name.startswith("client.")} == {
        None}
    dispatch = _by_name(rec, "pbs.dispatch")
    assert dispatch and {s.parent for s in dispatch} == {method.id}
    assert len(rec) == len(order) + 1 + len(dispatch) + len(
        _by_name(rec, "copy"))


@pytest.fixture(scope="module")
def cross():
    """Port and JAX ClientKeys from one seed: the same secret keys."""
    return (ClientKey(PARAM_TEST_ZERO_NOISE, seed=27, device="cpu"),
            JaxClientKey(JAX_P, seed=27))


def test_port_client_with_request_id_against_jax_server(cross):
    ck, jck = cross
    server = JaxServer(jck.get_server_key()).start()
    try:
        metrics.record_spans(True)
        remote = RemoteServerKey(server.address, device="cpu",
                                 timeout=TIMEOUT)
        s = ck.encrypt("ab.c", 1)
        assert ck.decrypt_char(remote.contains_clear(s, "b.")) == 1
        assert ck.decrypt(remote.to_upper(s)) == "AB.C"
    finally:
        server.stop()
    calls = _by_name(metrics.spans(), "client.call")
    assert len(calls) == 2 and calls[0].request != calls[1].request


def test_jax_client_against_port_server_recording(cross):
    """No request id in the JAX client's header: the port's server gives
    the request one of its own."""
    ck, jck = cross
    server = FheStringServer(ck.get_server_key()).start()
    before = socket.getdefaulttimeout()
    socket.setdefaulttimeout(TIMEOUT)
    try:
        metrics.record_spans(True)
        remote = JaxRemote(server.address)
        assert jck.decrypt(remote.to_upper(jck.encrypt("ab.c", 1))) == "AB.C"
    finally:
        socket.setdefaulttimeout(before)
        server.stop()
    rec = metrics.spans()
    method, = _by_name(rec, "server.to_upper")
    assert not _by_name(rec, "client.call")
    served = [s for s in rec if s.name.startswith(("service.", "server."))]
    assert len(served) == 5 and {s.request for s in served} == {
        method.request}


@pytest.mark.parametrize("method", ["contains", "find", "strip_prefix_clear"])
def test_dispatch_spans_match_pbs_counters(keys, identity_pbs, method):
    ck, srv = keys
    args = _args(ck, METHODS[method])
    metrics.record_spans(True)
    getattr(srv, method)(*args)
    rec = metrics.spans()
    dispatch = _by_name(rec, "pbs.dispatch")
    assert len(dispatch) == metrics.GLOBAL.pbs_calls > 0
    assert sum(s.attrs["width"] for s in dispatch) == metrics.GLOBAL.pbs_items
    top, = [s for s in rec if s.parent is None]
    assert top.name == f"server.{method}"
    assert len(_by_name(rec, "copy")) == metrics.GLOBAL.host_copies


@pytest.mark.parametrize("recording", [True, False])
def test_a_split_records_one_scan_and_counts_its_steps(keys, identity_pbs,
                                                      recording):
    """split_clear runs one engine scan over the padded string and the NUL
    it pushes: one engine.scan span, inside the method, whose steps are
    the scan_steps it adds; with the recorder off only the counter."""
    ck, srv = keys
    s = ck.encrypt("hello", 1)
    before = metrics.GLOBAL.scan_steps
    metrics.record_spans(recording)
    srv.split_clear(s, "l")
    metrics.record_spans(False)
    steps = len(s) + 1
    assert metrics.GLOBAL.scan_steps - before == steps == 7
    rec = metrics.spans()
    if not recording:
        assert rec == []
        return
    scan, = _by_name(rec, "engine.scan")
    method, = _by_name(rec, "server.split_clear")
    assert scan.attrs == {"steps": steps} and scan.parent == method.id
    inside = [d for d in _by_name(rec, "pbs.dispatch")
              if d.parent == scan.id]
    assert inside and all(scan.t0_ns <= d.t0_ns <= d.t1_ns <= scan.t1_ns
                          for d in inside)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_host_copies_cold_warm_and_served(identity_pbs, method):
    """A method's copies onto the device are the same on a fresh server
    key (its LUT cache empty), again on the same key, and through the
    service."""
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=33, device="cpu")
    srv = ck.get_server_key()
    args = _args(ck, METHODS[method])

    def copies(call):
        before = metrics.GLOBAL.host_copies
        call()
        return metrics.GLOBAL.host_copies - before

    cold = copies(lambda: getattr(srv, method)(*args))
    warm = copies(lambda: getattr(srv, method)(*args))
    server = FheStringServer(srv).start()
    try:
        remote = RemoteServerKey(server.address, device="cpu",
                                 timeout=TIMEOUT)
        served = copies(lambda: getattr(remote, method)(*args))
    finally:
        server.stop()
    assert cold == warm == served, (cold, warm, served)


def _site_pmask(srv, rng):
    mask = rng.integers(0, 2, size=(3, 5))
    want = torch.from_numpy((np.asarray(mask) != 0).reshape(3, 5, 1, 1)).to(
        "cpu")
    return srv.backend._pmask(mask, 2), want


def _site_trivial(srv, rng):
    p = srv.params
    values = rng.integers(0, 4, size=(2, 3), dtype=np.uint64)
    ct = np.zeros(values.shape + (p.big_lwe_dimension + 1,), np.uint64)
    ct[..., -1] = (values % np.uint64(p.full_space)) * np.uint64(p.delta)
    return srv.backend.sc.trivial(values).ct, torus.from_numpy(ct, "cpu")


def _site_trivial_bits_dyn(srv, rng):
    p = srv.params
    v = rng.integers(0, 3, size=(4,))
    ct = np.zeros(v.shape + (p.big_lwe_dimension + 1,), np.uint64)
    ct[..., -1] = (v != 0).astype(np.uint64) * np.uint64(p.delta)
    return srv.backend.trivial_bits_dyn(v).ct, torus.from_numpy(ct, "cpu")


def _site_take(srv, rng):
    x = srv.backend.sc.trivial(rng.integers(0, 4, size=(6, 2),
                                            dtype=np.uint64))
    idx = rng.integers(0, 6, size=(2, 3))
    want = x.ct[torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                device=x.ct.device)]
    return srv.backend.take(x, idx).ct, want


def _site_apply_lut_multi(srv, rng, monkeypatch):
    seen = []
    monkeypatch.setattr(shortint, "pbs_batch",
                        lambda flat, idx, bank, keys, **route:
                        seen.append(idx) or flat)
    sc = srv.backend.sc
    a = sc.trivial(rng.integers(0, 4, size=(5,), dtype=np.uint64))
    table_idx = rng.integers(0, 2, size=(5,))
    sc.apply_lut_multi(a, [list(range(16)), [0] * 16], table_idx)
    want = torch.as_tensor(np.asarray(table_idx).reshape(-1),
                           dtype=torch.int64).to(a.ct.device)
    return seen[0][:5], want


@pytest.mark.parametrize("site", ["pmask", "trivial", "trivial_bits_dyn",
                                  "take", "apply_lut_multi"])
def test_copy_helper_keeps_the_sites_bits(keys, monkeypatch, site):
    """Each of the five sites returns, through ``torus.to_device``, the
    very tensor (dtype, device, values) its old expression gave, and counts
    one copy more for it."""
    _, srv = keys
    rng = np.random.default_rng(len(site))
    fn = globals()[f"_site_{site}"]
    before = metrics.GLOBAL.host_copies
    args = (srv, rng, monkeypatch) if site == "apply_lut_multi" else (srv,
                                                                        rng)
    got, want = fn(*args)
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want)
    # the site's own copy, plus the trivial inputs built for take and the
    # multi-LUT
    made = 2 if site in ("take", "apply_lut_multi") else 1
    assert metrics.GLOBAL.host_copies - before == made


@pytest.mark.parametrize("dtype", [torch.int64, torch.bool])
def test_to_device_on_the_cpu_counts_one_copy_that_waits_for_nothing(dtype):
    """On the CPU ``torus.to_device`` is ``t.to(device)``: one
    ``host_copies``, one ``copy`` span, and no ``blocking_copies``, since
    nothing waits on a card."""
    t = torch.ones((3, 2), dtype=dtype)
    before = metrics.GLOBAL.snapshot()
    metrics.record_spans(True)
    out = torus.to_device(t, torch.device("cpu"))
    metrics.record_spans(False)
    d = metrics.GLOBAL.delta(before)
    assert (d.host_copies, d.blocking_copies) == (1, 0)
    assert [s.name for s in metrics.spans()] == ["copy"]
    assert out is t


class _NoReadBack(TorchDispatchMode):
    """Refuses ``aten._local_scalar_dense``, the op by which a tensor's
    value reaches the host as a Python number (on the card it waits for the
    stream)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor was read back to the host")
        return func(*args, **(kwargs or {}))


def _refuse(*args, **kwargs):
    raise AssertionError("an index tensor became a Python int")


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
@pytest.mark.parametrize("ndim", [0, 1, 2])
def test_take_equals_np_take_and_reads_no_index_back(keys, monkeypatch,
                                                     ndim, axis):
    """``FheBackend.take`` with a 0-d, 1-d or 2-d index, at every axis of
    the raw ciphertext tensor, gives ``np.take``'s result, and never turns
    its index tensor into a Python int: ``Tensor.item`` and
    ``Tensor.__index__`` are refused, and so is the read-back a 0-d index
    tensor costs inside indexing."""
    _, srv = keys
    rng = np.random.default_rng(10 * ndim + axis % 3)
    ct = torch.from_numpy(rng.integers(-2**62, 2**62, size=(3, 4, 5)))
    size = ct.shape[axis]
    idx = rng.integers(0, size, size=(2, 3)[:ndim])
    want = np.take(ct.numpy(), idx, axis=axis)
    before = metrics.GLOBAL.host_copies
    monkeypatch.setattr(torch.Tensor, "item", _refuse)
    monkeypatch.setattr(torch.Tensor, "__index__", _refuse)
    with _NoReadBack():
        got = srv.backend.take(shortint.Blocks(ct, 3, 1.0), idx, axis=axis)
    monkeypatch.undo()
    assert metrics.GLOBAL.host_copies - before == 1
    assert got.ct.shape == want.shape
    assert np.array_equal(got.ct.numpy(), want)
    assert (got.degree, got.noise_var) == (3, 1.0)


def test_merged_dispatch_records_its_posts_and_the_waits(keys, identity_pbs):
    """Two requests whose first batches wait on a third member of the set
    (this test's thread): one ``pbs.wait`` span a post that waited, inside
    its request's method span, with the posts of the dispatch it waited
    for; ``pbs.dispatch`` spans whose ``posts`` add up to ``pbs_posts``;
    and ``pbs_wait_ns`` counting the waits.  A lone request records no
    wait and one post a dispatch."""
    ck, srv = keys
    batches = srv.backend.sc.batches
    s = ck.encrypt("hello", 1)
    metrics.record_spans(True)
    out = {}

    def call(method):
        out[method] = getattr(srv, method)(s)
    threads = [threading.Thread(target=call, args=(m,), daemon=True)
               for m in ("to_upper", "len")]
    batches.enter()
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + TIMEOUT
        while len(batches._pending) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.001)
    finally:
        batches.leave()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads) and len(out) == 2
    rec = metrics.spans()
    g = metrics.GLOBAL
    dispatch, waits = _by_name(rec, "pbs.dispatch"), _by_name(rec, "pbs.wait")
    assert len(dispatch) == g.pbs_calls
    assert sum(d.attrs["width"] for d in dispatch) == g.pbs_items
    assert sum(d.attrs["posts"] for d in dispatch) == g.pbs_posts
    assert g.pbs_posts > g.pbs_calls and g.pbs_wait_ns > 0
    assert max(d.attrs["posts"] for d in dispatch) == 2
    methods = {m.id: m for m in rec if m.name.startswith("server.")}
    assert len(methods) == 2 and len(waits) >= 2
    for w in waits:
        assert w.parent in methods and w.request == methods[w.parent].request
        assert 1 <= w.attrs["posts"] <= 2
    assert sorted(w.attrs["posts"] for w in waits)[-2:] == [2, 2]
    metrics.reset()
    srv.to_upper(s)
    rec = metrics.spans()
    assert not _by_name(rec, "pbs.wait")
    assert {d.attrs["posts"] for d in _by_name(rec, "pbs.dispatch")} == {1}
    assert metrics.GLOBAL.pbs_posts == metrics.GLOBAL.pbs_calls > 0
