"""Bootstraps of concurrent requests merged into shared PBS batches.

A server with several requests in flight (``service.FheStringServer``
runs one thread a connection) would otherwise send each request's small
batches to the card one by one.  ``Coalescer`` sits at the one chokepoint
every LUT evaluation passes through (``ShortintContext._pbs_padded``): a
request *posts* its batch there, and the batches posted by concurrent
requests go out as one dispatch.

The rule, with no timer and no setting: a post goes out when every request
that is inside a ``ServerKey`` method (``enter`` .. ``leave``, which the
server's public-method wrapper calls for the outermost method of a thread)
has posted one.  The thread whose post completes that set dispatches the
merged batch on its own thread; the others wait until their slice of the
output is ready.  A request that leaves its method, normally or by an
exception, leaves the set, and where every remaining request has then
posted, one of them dispatches.  With one request in flight a post
completes the set at once and is dispatched on its own thread, unmerged.
A post from a thread outside any method (the engine called directly) is
dispatched at once where no request is inside a method, as before.

Posts taken into a dispatch are no longer pending, and their threads wait
on its output, so the set cannot complete again until they post anew: one
merged dispatch is in flight at a time.

Where the dispatches go to a card that runs them after the host has moved
on (a ``fence``: ``ShortintContext`` gives one on a CUDA device), a set
completed while several requests are inside methods goes out once the card
has begun the previous merged dispatch, so that one merged dispatch waits
behind the one the card runs and no more.  Without that gate the host
enqueues the requests' rounds as fast as their glue allows, far ahead of
the card: the requests then leave their methods long before their results
exist and wait outside the set for the card to drain, so few are inside
methods at once and each round merges few posts; and every request that
arrives meanwhile joins only when the card has run the whole backlog, with
the card idle while the newcomers reach their first post.  Gated, the
requests stay inside their methods at the card's pace, and a post made
while the completing thread waits for the card rides in the same dispatch.
With one request inside a method nothing is gated or fenced.

A merged dispatch concatenates the posts' ciphertexts, their LUT banks
(each distinct bank once) and their indices, each offset by the first row
of its bank in the merged bank; its output is cut back into the posts'
slices.  Every body and mode of the blind rotation is exact per item
whatever the batch's width, so each request gets the bits it would get
alone.  The dispatch function (``ShortintContext._dispatch``) owns the
chunking, the padding, the route and the counting of the merged batch.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from . import metrics


class _Post:
    """One request's batch, and then its slice of the output."""

    __slots__ = ("flat", "idx", "bank", "t0_ns", "taken", "done", "posts",
                 "out", "error")

    def __init__(self, flat: torch.Tensor, idx: torch.Tensor,
                 bank: torch.Tensor):
        self.flat, self.idx, self.bank = flat, idx, bank
        self.t0_ns = time.perf_counter_ns()
        self.taken = self.done = False
        self.posts = 0
        self.out: torch.Tensor | None = None
        self.error: BaseException | None = None

    def result(self) -> torch.Tensor:
        if self.error is not None:
            raise self.error
        return self.out


def merge(posts: list[_Post]) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(ciphertexts, indices, bank) of the posts as one batch: each
    distinct bank once, each post's indices offset by its bank's first
    row."""
    first: dict[int, int] = {}
    banks = []
    rows = 0
    for p in posts:
        if id(p.bank) not in first:
            first[id(p.bank)] = rows
            banks.append(p.bank)
            rows += p.bank.shape[0]
    idx = [p.idx + first[id(p.bank)] if first[id(p.bank)] else p.idx
           for p in posts]
    bank = banks[0] if len(banks) == 1 else torch.cat(banks)
    return torch.cat([p.flat for p in posts]), torch.cat(idx), bank


def card_fence(device: torch.device) -> Callable[[], None]:
    """A wait that returns once the card has run what the current stream of
    ``device`` holds now (its thread sleeps meanwhile)."""
    event = torch.cuda.Event(blocking=True)
    event.record(torch.cuda.current_stream(device))
    return event.synchronize


class Coalescer:
    """Merges the batches that concurrent requests post into one dispatch
    (module docstring).  ``dispatch(flat, idx, bank, posts)`` runs a batch
    of ``posts`` merged posts and returns its output; ``fence()``, where
    given, returns a wait for the card to have run what was enqueued before
    it."""

    def __init__(self, dispatch: Callable[..., torch.Tensor],
                 fence: Callable[[], Callable[[], None]] | None = None):
        self._dispatch = dispatch
        self._fence = fence
        self._cond = threading.Condition(threading.Lock())
        self._inside = 0                 # requests inside a method
        self._pending: list[_Post] = []  # posted, not yet taken
        self._gating = False             # a completed set waits for the card
        # waits for the card to have run the last two merged dispatches
        self._fences: list[Callable[[], None]] = []

    def enter(self) -> None:
        """A request entered a ``ServerKey`` method."""
        with self._cond:
            self._inside += 1

    def leave(self) -> None:
        """A request left its method; a waiting post may now go out."""
        with self._cond:
            self._inside -= 1
            if self._complete():
                self._cond.notify_all()

    def _complete(self) -> bool:
        return (not self._gating and bool(self._pending)
                and len(self._pending) >= self._inside)

    def post(self, flat: torch.Tensor, idx: torch.Tensor,
             bank: torch.Tensor) -> torch.Tensor:
        """Bootstrap ``flat`` through ``bank[idx]``, in one dispatch with
        the batches that concurrent requests post meanwhile."""
        mine = _Post(flat, idx, bank)
        with self._cond:
            self._pending.append(mine)
            if not self._complete():
                with metrics.span("pbs.wait") as wait:
                    while not (mine.done or (not mine.taken
                                             and self._complete())):
                        self._cond.wait()
                    if wait is not None:
                        wait.attrs["posts"] = (mine.posts if mine.done
                                               else len(self._pending))
            if mine.done:
                return mine.result()
            if self._inside > 1 and len(self._fences) == 2:
                self._gate(self._fences[0])
            taken, self._pending = self._pending, []
            for p in taken:
                p.taken = True
        self._run(taken)
        return mine.result()

    def _gate(self, begun: Callable[[], None]) -> None:
        """Wait, with the lock let go, until the card has run the merged
        dispatch before the last (``begun``), so that it has begun the
        last; posts made meanwhile join the set that goes out next."""
        self._gating = True
        self._cond.release()
        try:
            with metrics.span("pbs.wait") as wait:
                begun()
                if wait is not None:
                    wait.attrs["posts"] = len(self._pending)
        finally:
            self._cond.acquire()
            self._gating = False

    def _run(self, taken: list[_Post]) -> None:
        """Dispatch the taken posts as one batch, hand each its slice (or
        the dispatch's exception) and wake their threads."""
        start = time.perf_counter_ns()
        outs, error = [], None
        try:
            if len(taken) == 1:
                p = taken[0]
                outs = [self._dispatch(p.flat, p.idx, p.bank, 1)]
            else:
                out = self._dispatch(*merge(taken), len(taken))
                at = 0
                for p in taken:
                    n = p.flat.shape[0]
                    outs.append(out[at:at + n])
                    at += n
        except BaseException as e:  # re-raised by every post's thread
            error = e
        metrics.count(pbs_posts=len(taken),
                      pbs_wait_ns=sum(start - p.t0_ns for p in taken))
        fence = (self._fence() if self._fence is not None
                 and self._inside > 1 else None)
        with self._cond:
            if fence is not None:
                self._fences = self._fences[-1:] + [fence]
            for i, p in enumerate(taken):
                p.posts = len(taken)
                if error is None:
                    p.out = outs[i]
                else:
                    p.error = error
                p.done = True
            self._cond.notify_all()
