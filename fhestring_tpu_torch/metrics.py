"""Counters and spans of the served path.

The currency of the system is *bootstraps*: every homomorphic string op
lowers to a fixed number of batched PBS calls.  This module counts them at
the one chokepoint every LUT evaluation passes through
(``ShortintContext._pbs_padded``), and records what the host does around
them:

- ``GLOBAL``: always-on tallies, plain Python ints incremented where the
  work is issued, each under one lock (``count``), since several request
  threads of one server count at once: PBS dispatches and their logical
  and padded widths, the batches requests post to the shortint layer's
  coalescer (``pbs_posts``: one a ``_pbs_padded`` call; equal to
  ``pbs_calls`` where nothing merges) and the host time from each post to
  the start of the dispatch that carries it (``pbs_wait_ns``), the
  copies of plain data onto the server's device (``host_copies``, counted
  by ``torus.to_device``, which copies onto a CUDA device without waiting
  for it), the copies among them that may still wait on the card
  (``blocking_copies``: those staged in memory that is not page-locked;
  0 on the CPU, where nothing waits on a card), and the steps of the
  engine's scans (``scan_steps``, counted by ``FheBackend.scan`` and
  ``scan_out``: the length of the chain of dependent steps a request
  carries);
- a span recorder, off by default.  ``record_spans(True)`` turns it on and
  ``record_spans(False)`` off.  While on, each ``with span(name):`` block
  appends one ``Span`` to ``spans()``; while off, ``span`` checks one flag
  and returns a shared no-op context manager (nothing allocated, no clock
  read).

The spans sit at the layer boundaries: ``client.call``, ``client.encode``
and ``client.decode`` (``service.RemoteServerKey``); ``service.receive``,
``service.decode``, ``service.encode`` and ``service.send`` (the
``FheStringServer`` handler); ``server.<method>`` (one per public
``ServerKey`` call; on the card it ends with a ``sync`` span, a synchronise
of the device, so that it holds the method's device work);
``engine.scan`` with its ``steps`` (one per ``FheBackend.scan`` or
``scan_out``); ``pbs.dispatch`` with its logical ``width`` and the
``posts`` it merges (one per batch that reaches ``pbs_batch``);
``pbs.wait`` with the ``posts`` of the dispatch it waited for (one per
post whose thread waited for other requests' posts or for another thread's
dispatch of it, and one per wait of a completed set for the card to begin
the previous merged dispatch, from the start of the wait to its end);
``copy`` (each ``torus.to_device``).
A span's ``parent`` is the innermost span open on the same thread; its
``request`` is shared by every span of one request, on the client's thread
and the server's: the client sends its id in the request's header and the
server's handler joins it (``request``).  A top-level span outside any
request scope starts a request of its own.  Ids are unique within a
process.  Stamps are ``time.perf_counter_ns()``.

The port evaluates eagerly, engine scans included (``FheBackend.scan`` is a
Python loop), so every dispatch is one execution: there is no trace-time
multiplier, unlike the JAX package's ``scan_scope``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import NamedTuple


@dataclasses.dataclass
class Counters:
    """Monotonic global tallies."""

    pbs_calls: int = 0        # number of pbs_batch dispatches
    pbs_items: int = 0        # sum of logical (unpadded) batch sizes
    pbs_items_padded: int = 0  # sum of padded batch sizes actually executed
    host_copies: int = 0      # copies of plain data to the device
    blocking_copies: int = 0  # those of them that may wait on the card
    scan_steps: int = 0       # steps of the engine's scans (FheBackend)
    pbs_posts: int = 0        # batches posted to the coalescer
    pbs_wait_ns: int = 0      # sum over posts: post to its dispatch's start

    def snapshot(self) -> "Counters":
        return dataclasses.replace(self)

    def delta(self, since: "Counters") -> "Counters":
        return Counters(*(getattr(self, f.name) - getattr(since, f.name)
                          for f in dataclasses.fields(self)))


GLOBAL = Counters()
_counting = threading.Lock()


def count(**amounts: int) -> None:
    """Add each amount to the ``GLOBAL`` field of its name, all under one
    lock: a bare ``+=`` loses counts when threads switch between its read
    and its write."""
    with _counting:
        for name, amount in amounts.items():
            setattr(GLOBAL, name, getattr(GLOBAL, name) + int(amount))


def record_pbs(n_items: int, n_padded: int) -> None:
    """Called by ShortintContext on every batched-PBS dispatch."""
    count(pbs_calls=1, pbs_items=n_items, pbs_items_padded=n_padded)


class Span(NamedTuple):
    """One closed span."""

    id: int
    parent: int | None    # the innermost span open on its thread
    request: int
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


_on = False
_spans: list[Span] = []
_local = threading.local()     # .stack: open span ids; .request: an id
_ids = itertools.count(1)      # span and request ids alike


def record_spans(on: bool) -> None:
    """Turn the span recorder on or off."""
    global _on
    _on = bool(on)


def recording() -> bool:
    return _on


def spans() -> list[Span]:
    """The spans closed since the last ``reset``, in closing order."""
    return list(_spans)


class _Off:
    """What ``span`` and ``request`` return while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "owns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.owns = getattr(_local, "request", None) is None
        if self.owns:
            _local.request = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        _spans.append(Span(self.id, self.parent, _local.request, self.name,
                           self.t0, t1, self.attrs))
        if self.owns:
            _local.request = None
        return False


def span(name: str, width: int | None = None, steps: int | None = None,
         posts: int | None = None):
    """A context manager that records ``name`` while the recorder is on;
    ``width`` (a PBS batch's logical items), ``steps`` (a scan's) and
    ``posts`` (the requests' batches a dispatch merges) go into the span's
    attrs.  Entering it gives the open span, whose ``attrs`` may still be
    added to, or None while the recorder is off."""
    if not _on:
        return _OFF
    given = {"width": width, "steps": steps, "posts": posts}
    return _Open(name, {k: int(v) for k, v in given.items()
                        if v is not None})


class _Request:
    __slots__ = ("id", "outer")

    def __init__(self):
        self.id = next(_ids)

    def __enter__(self):
        self.outer = getattr(_local, "request", None)
        _local.request = self.id
        return self

    def __exit__(self, *exc):
        _local.request = self.outer
        return False

    def join(self, rid) -> None:
        """Take the id another thread gave this request (None: keep
        this one)."""
        if rid is not None:
            self.id = _local.request = int(rid)


def request():
    """A request's scope on this thread: the spans that close inside it
    carry its id, a fresh one until ``join`` gives it another.  Entering it
    gives the scope, with ``id`` and ``join``, or None while the recorder is
    off."""
    if not _on:
        return _OFF
    return _Request()


def span_totals(records=None) -> dict:
    """{name: {"count", "ms", "self_ms"}} over ``records`` (default: every
    span recorded): a span's self time is its own less its children's."""
    records = _spans if records is None else records
    child_ns: dict[int, int] = {}
    for s in records:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.t1_ns - s.t0_ns
    out: dict[str, dict] = {}
    for s in records:
        row = out.setdefault(s.name, {"count": 0, "ms": 0.0, "self_ms": 0.0})
        own = s.t1_ns - s.t0_ns
        row["count"] += 1
        row["ms"] += own / 1e6
        row["self_ms"] += (own - child_ns.get(s.id, 0)) / 1e6
    return out


def reset() -> None:
    """Zero the counters and drop the recorded spans."""
    with _counting:
        for f in dataclasses.fields(GLOBAL):
            setattr(GLOBAL, f.name, 0)
    _spans.clear()
