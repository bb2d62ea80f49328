"""Concurrent requests' bootstraps merged into shared PBS batches
(``batching.py``), and the service that serves many clients at once
(``service.py``).

- Several clients of one ``FheStringServer``, each with its own
  ``RemoteServerKey``: every result is bit-identical to the same request
  served alone and decrypts to Python's answer, and batches did merge.
- One caller: the same dispatches, widths and counts as without the
  coalescer, and one post a dispatch.
- A request that raises inside its method, before or after a post, or a
  dispatch that raises, leaves the coalescer serving the others.
- The merge itself: each post's LUT indices offset into the merged bank.
- The gate: with a fence, a set waits for the card to begin the last
  merged dispatch, and posts made meanwhile join it.
- 40 connections opened at once are all accepted and answered.

On the CPU at PARAM_TEST_ZERO_NOISE; where bits do not matter the
bootstrap is the identity.  A test that holds the set open (``held``)
enters the coalescer from the test's own thread, waits until the workers
have posted, and leaves, so that their first batches merge whatever the
threads' timing.  Every thread is joined and every socket waits with a
timeout, so a deadlock fails in seconds and never hangs the suite.
Tolerance: zero (bits and counts).
"""

import contextlib
import socket
import threading
import time

import pytest
import torch

from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE, metrics, service, shortint
from fhestring_tpu_torch.batching import Coalescer, merge
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.service import FheStringServer, RemoteServerKey

torch.set_num_threads(1)

TIMEOUT = 120.0  # seconds a thread or socket may wait
# (method, string, pattern or clear argument, Python's answer): a mix of
# methods at different lengths, one a client
REQUESTS = [
    ("contains", "abc", "bc", 1),
    ("contains_clear", "xy", "z", 0),
    ("find", "abca", "c", 2),
    ("starts_with_clear", "hey", "he", 1),
    ("eq", "ab", "ab", 1),
    ("to_upper", "aZ.", None, "AZ."),
    ("len", "abcd", None, 4),
    ("strip_prefix_clear", "ab", "a", ("b", 1)),
]


@pytest.fixture(autouse=True)
def clean():
    metrics.record_spans(False)
    metrics.reset()
    yield
    metrics.record_spans(False)
    metrics.reset()


@pytest.fixture(scope="module")
def keys():
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=33, device="cpu")
    return ck, ck.get_server_key()


@pytest.fixture
def identity_pbs(monkeypatch):
    monkeypatch.setattr(shortint, "pbs_batch",
                        lambda flat, idx, bank, keys, **route: flat)


def _args(ck, method, string, arg):
    s = ck.encrypt(string, 1)
    if arg is None:
        return (s,)
    if method in ("contains", "find"):
        return (s, ck.encrypt_no_padding(arg))
    if method == "eq":
        return (s, ck.encrypt(arg, 1))
    return (s, arg)


def _decrypt(ck, method, out):
    if method == "to_upper":
        return ck.decrypt(out)
    if method == "strip_prefix_clear":
        return ck.decrypt_strip(out)
    return ck.decrypt_char(out)


def _tensors(out):
    """The result's ciphertext tensors."""
    if hasattr(out, "blocks"):
        return [out.blocks.ct]
    return [out.string.blocks.ct, out.pattern_found.blocks.ct]


def _wait_for(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


@contextlib.contextmanager
def held(batches: Coalescer, posts: int):
    """Keep the set open from this thread until ``posts`` posts wait."""
    batches.enter()
    try:
        yield
        _wait_for(lambda: len(batches._pending) >= posts, f"{posts} posts")
    finally:
        batches.leave()


def _run_threads(fns):
    """Run each function on a thread of its own; their results, or the
    exceptions they raised."""
    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # returned, for the test to look at
            out[i] = e
    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    return threads, out


def _join(threads):
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a thread hangs"


def test_clients_get_their_own_bits_from_merged_batches(keys):
    """8 clients at once: each result bit-identical to the same request
    served alone, decrypting to Python's answer; batches merged."""
    ck, srv = keys
    args = [_args(ck, m, s, a) for m, s, a, _ in REQUESTS]
    alone = [getattr(srv, m)(*a) for (m, *_), a in zip(REQUESTS, args)]
    alone_calls = metrics.GLOBAL.pbs_calls
    assert metrics.GLOBAL.pbs_posts == alone_calls
    metrics.reset()
    server = FheStringServer(srv).start()
    try:
        remotes = [RemoteServerKey(server.address, device="cpu",
                                   timeout=TIMEOUT) for _ in REQUESTS]
        with held(srv.backend.sc.batches, len(REQUESTS)):
            threads, got = _run_threads([
                (lambda r=r, m=m, a=a: getattr(r, m)(*a))
                for r, (m, *_), a in zip(remotes, REQUESTS, args)])
        _join(threads)
    finally:
        server.stop()
    for (method, *_, want), a, b in zip(REQUESTS, alone, got):
        assert not isinstance(b, Exception), (method, b)
        assert _decrypt(ck, method, b) == want, method
        assert all(torch.equal(x, y) for x, y in
                   zip(_tensors(a), _tensors(b))), method
    g = metrics.GLOBAL
    assert g.pbs_posts > g.pbs_calls > 0
    assert g.pbs_calls < alone_calls
    assert g.pbs_wait_ns > 0


@pytest.mark.parametrize("method,string,arg",
                         [(m, s, a) for m, s, a, _ in REQUESTS])
def test_one_caller_dispatches_as_without_the_coalescer(
        keys, identity_pbs, monkeypatch, method, string, arg):
    """One in-process caller: the same dispatches at the same widths as a
    shortint layer that calls its dispatch directly, one post each."""
    ck, srv = keys
    args = _args(ck, method, string, arg)
    widths = []
    record = metrics.record_pbs
    monkeypatch.setattr(metrics, "record_pbs", lambda n, padded: (
        widths.append((n, padded)), record(n, padded)))
    with monkeypatch.context() as direct:
        direct.setattr(shortint.ShortintContext, "_pbs_padded",
                       lambda self, flat, idx, bank:
                       self._dispatch(flat, idx, bank))
        want = getattr(srv, method)(*args)
    before, want_widths = metrics.GLOBAL.snapshot(), list(widths)
    widths.clear()
    got = getattr(srv, method)(*args)
    d = metrics.GLOBAL.delta(before)
    assert widths == want_widths
    assert (d.pbs_calls, d.pbs_items_padded) == (
        len(want_widths), sum(p for _, p in want_widths))
    assert d.pbs_items == sum(n for n, _ in want_widths)
    assert d.pbs_posts == d.pbs_calls > 0
    assert all(torch.equal(x, y) for x, y in
               zip(_tensors(want), _tensors(got)))
    assert srv.backend.sc.batches._inside == 0


class _Raise(Exception):
    pass


@pytest.mark.parametrize("when", ["before_a_post", "after_a_post"])
def test_a_request_that_raises_leaves_the_set(keys, identity_pbs, when):
    """Two requests wait on a third, which raises inside its method: they
    go out merged, it reports its exception, and the key serves on."""
    ck, srv = keys
    sc = srv.backend.sc
    s = ck.encrypt("abc", 1)
    real = srv.engine.len

    def failing(blocks):
        if when == "after_a_post":
            sc.refresh(sc.trivial([1]))
        _wait_for(lambda: len(sc.batches._pending) == 2, "two posts")
        raise _Raise(when)
    srv.engine.len = failing
    try:
        # the failing request enters first, so that the others wait on it
        threads, out = _run_threads([lambda: srv.len(s)])
        _wait_for(lambda: sc.batches._inside == 1, "the failing request")
        more, out2 = _run_threads([lambda: srv.to_upper(s),
                                   lambda: srv.to_upper(s)])
        _join(threads + more)
    finally:
        srv.engine.len = real
    out = out2 + out
    assert isinstance(out[2], _Raise)
    assert not any(isinstance(x, Exception) for x in out[:2]), out
    assert torch.equal(out[0].blocks.ct, out[1].blocks.ct)
    assert sc.batches._inside == 0 and sc.batches._pending == []
    assert metrics.GLOBAL.pbs_posts > metrics.GLOBAL.pbs_calls
    threads, out = _run_threads([lambda: srv.len(s)])   # serves on
    _join(threads)
    assert out[0].blocks.ct.shape == s.blocks.ct.shape[1:]


def test_a_dispatch_that_raises_fails_its_posts_only(keys, identity_pbs,
                                                    monkeypatch):
    """Every post of a merged dispatch that raises gets its exception;
    the coalescer then serves the next requests."""
    ck, srv = keys
    sc = srv.backend.sc
    s = ck.encrypt("ab", 1)
    real = shortint.pbs_batch

    def once(*a, **kw):
        monkeypatch.setattr(shortint, "pbs_batch", real)
        raise _Raise("dispatch")
    monkeypatch.setattr(shortint, "pbs_batch", once)
    with held(sc.batches, 3):
        threads, out = _run_threads([lambda: srv.to_upper(s)] * 3)
    _join(threads)
    assert all(isinstance(x, _Raise) for x in out), out
    assert sc.batches._inside == 0
    with held(sc.batches, 2):
        threads, out = _run_threads([lambda: srv.to_upper(s)] * 2)
    _join(threads)
    assert all(torch.equal(x.blocks.ct, out[0].blocks.ct) for x in out)


def _lut_dispatch(flat, idx, bank, posts):
    """A stand-in for the PBS: each row's first column plus its LUT's
    first entry."""
    return flat[:, :1] + bank[idx][:, :1]


def test_merge_offsets_each_post_into_its_bank():
    banks = [torch.arange(4 * 3).reshape(4, 3) * 10,
             torch.arange(2 * 3).reshape(2, 3) * 1000]
    c = Coalescer(_lut_dispatch)
    gen = torch.Generator().manual_seed(7)
    posts = []
    for n, bank in [(3, banks[0]), (5, banks[1]), (2, banks[0]),
                    (4, banks[1])]:
        flat = torch.randint(0, 9, (n, 3), generator=gen)
        idx = torch.randint(0, bank.shape[0], (n,), generator=gen)
        posts.append((flat, idx, bank))
    alone = [c.post(*p) for p in posts]
    assert all(torch.equal(a, _lut_dispatch(*p, 1))
               for a, p in zip(alone, posts))
    seen = []

    def spy(flat, idx, bank, n):
        seen.append((flat.shape[0], bank.shape[0], n))
        return _lut_dispatch(flat, idx, bank, n)
    c = Coalescer(spy)
    with held(c, len(posts)):
        threads, got = _run_threads([
            (lambda p=p: _member(c, p)) for p in posts])
    _join(threads)
    assert seen == [(14, 6, 4)]   # each bank once
    assert all(torch.equal(a, b) for a, b in zip(alone, got))


def _member(c, post):
    """Post as a request inside a method does."""
    c.enter()
    try:
        return c.post(*post)
    finally:
        c.leave()


def test_a_set_waits_for_the_card_to_begin_the_last_merged_dispatch():
    """Given a fence, a set completed by several members goes out once the
    card has run the merged dispatch before the last; a post made while it
    waits rides along.  One caller makes no fence and never waits."""
    card = []   # one event a fence, set when the card has run its dispatch

    def fence():
        card.append(threading.Event())
        return lambda e=card[-1]: e.wait(TIMEOUT)
    seen = []

    def spy(flat, idx, bank, n):
        seen.append(n)
        return _lut_dispatch(flat, idx, bank, n)
    bank = torch.arange(2 * 3).reshape(2, 3)
    post = (torch.ones((2, 3), dtype=torch.int64),
            torch.zeros(2, dtype=torch.int64), bank)
    c = Coalescer(spy, fence)
    for _ in range(2):   # two merged dispatches, nothing to wait for
        with held(c, 2):
            threads, _ = _run_threads([lambda: _member(c, post)] * 2)
        _join(threads)
    assert seen == [2, 2] and len(card) == 2
    with held(c, 2):
        threads, out = _run_threads([lambda: _member(c, post)] * 2)
    _wait_for(lambda: c._gating, "the gate")
    late, late_out = _run_threads([lambda: _member(c, post)])
    _wait_for(lambda: len(c._pending) == 3, "the late post")
    assert seen == [2, 2] and not any(e.is_set() for e in card)
    card[0].set()
    _join(threads + late)
    assert seen == [2, 2, 3] and len(card) == 3
    want = _lut_dispatch(*post, 1)
    assert all(torch.equal(x, want) for x in out + late_out)
    assert c._inside == 0 and not c._pending and not c._gating

    made = len(card)
    alone = Coalescer(spy, fence)
    for _ in range(3):
        assert torch.equal(_member(alone, post), want)
    assert len(card) == made and seen[3:] == [1, 1, 1]


def test_many_connections_at_once_are_all_answered(keys, identity_pbs):
    """40 connections opened before any of them sends: each is accepted
    and answered (a server that took one at a time would leave those past
    its listen queue waiting for their connect)."""
    ck, srv = keys
    blob = service._ct_to_bytes(ck.encrypt("ab", 1).blocks)
    server = FheStringServer(srv).start()

    def ask(sock):
        with sock:
            service._send(sock, {"op": "len", "clear_args": []}, [blob])
            header, blobs = service._recv(sock)
        assert header["ok"], header
        return service._unpack_result(header, blobs, "cpu")
    try:
        socks = [socket.create_connection(server.address, timeout=10)
                 for _ in range(40)]
        threads, out = _run_threads([lambda s=s: ask(s) for s in socks])
        _join(threads)
    finally:
        server.stop()
    assert not any(isinstance(x, Exception) for x in out), out
    assert all(torch.equal(x.blocks.ct, out[0].blocks.ct) for x in out)
    assert srv.backend.sc.batches._inside == 0
