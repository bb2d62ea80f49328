"""The one traffic generator: requests from a mix's parameter file and a
seed.

A mix (``fhebench/traffic/<name>.json``) gives the entry the window drives
(``service``: a ``RemoteServerKey`` over loopback TCP; ``in_process``: the
``ServerKey``), the range of string and pattern lengths, the methods, the
share of requests whose pattern matches, the padding, the alphabet, how
many requests of each method a deck holds and how many decks a run makes.

A deck holds the same requests' sizes for every seed: for each method,
``per_method`` requests whose string lengths are spread evenly over the
range, whose pattern lengths are spread evenly over theirs in another
order (the i-th request takes the ``(5 i mod per_method)``-th), and of
which a ``match_share`` matches, spread over the lengths (the i-th where
``(i+1) * share`` passes a whole number).  The deck is dealt in
``per_method`` rounds of one request of each method, method m taking its
``(r + m) mod per_method``-th request in round r, so that every round
mixes short and long strings.  The order of the rounds, and inside each
round, is drawn once for the mix (``ORDER_SEED``), not from the run's
seed: the work of a TFHE method depends on the sizes of its inputs and
never on their values, so every seed asks for the same work in the same
order, and runs on different seeds differ only by the card's and the
host's own noise.  The seed draws the characters and where a matching
pattern lies.

A matching pattern lies where the method's file says
(``methods/<name>.py`` ``PATTERN``: a prefix, a suffix, the whole string,
or anywhere); a method with ``REPLACEMENT`` gets random characters of the
pattern's length to put in its place.

A mix may ask for ``clients``, the number of concurrent closed-loop
clients of the service (1 where it names none): each client sends its next
request when its last one has been answered.  Several clients need the
``service`` entry: an in-process mix is a batch job beside its key, and
the program's ``ServerKey`` makes no promise to be called from several
threads at once.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from . import methods

ORDER_SEED = 20261017  # draws the order of the rounds, the same every run


@dataclasses.dataclass(frozen=True)
class Request:
    method: str
    string: bytes
    pattern: bytes = b""
    to: bytes = b""


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(root: str, name: str) -> str:
    """The file of the mix ``name`` under the benchmark's folder."""
    return os.path.join(root, "traffic", f"{name}.json")


def clients(mix: dict) -> int:
    """The mix's concurrent clients; a ValueError where they are not a
    whole number from 1, or several of an ``in_process`` entry."""
    n = mix.get("clients", 1)
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise ValueError(f"clients must be a whole number from 1, not {n!r}")
    if n > 1 and mix["entry"] != "service":
        raise ValueError(
            f"{n} clients need the service entry, not {mix['entry']!r}: an "
            "in-process mix is one batch job calling the ServerKey, which "
            "makes no promise to be thread-safe")
    return n


def spread(lo: int, hi: int, count: int) -> list[int]:
    """``count`` whole numbers spread evenly from lo to hi."""
    if count == 1:
        return [lo]
    return [lo + round(i * (hi - lo) / (count - 1)) for i in range(count)]


def deck_sizes(mix: dict) -> list[list[tuple[str, int, int, bool]]]:
    """The rounds of one deck, each a list of (method, string length,
    pattern length, matches): the same for every seed."""
    per = mix["per_method"]
    lengths = spread(*mix["string_len"], per)
    patterns = spread(*mix["pattern_len"], per)
    share = mix["match_share"]
    rounds = []
    for r in range(per):
        rounds.append([])
        for m, method in enumerate(mix["methods"]):
            i = (r + m) % per
            rounds[-1].append((method, lengths[i], patterns[(5 * i) % per],
                               int((i + 1) * share) > int(i * share)))
    return rounds


def _text(rng: np.random.Generator, mix: dict, length: int) -> bytes:
    lo, hi = mix["alphabet"]
    return bytes(rng.integers(lo, hi + 1, size=length, dtype=np.int64)
                 .astype(np.uint8))


def make(mix: dict, seed: int, root: str | None = None) -> list[Request]:
    """Every request a run may send: ``decks`` decks, each dealt in rounds
    in the mix's own order, with characters drawn from the seed (``root``:
    the benchmark's folder, where the method files are)."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    order = np.random.default_rng(ORDER_SEED)
    rounds = deck_sizes(mix)
    out = []
    for _ in range(mix["decks"]):
        for r in order.permutation(len(rounds)):
            deal = rounds[r]
            out.extend(_request(rng, mix, root, *deal[i])
                       for i in order.permutation(len(deal)))
    return out


def _request(rng, mix: dict, root, method: str, length: int, plen: int,
             matches: bool) -> Request:
    kind = methods.load(method, root)
    where = kind.PATTERN
    s = _text(rng, mix, length)
    if where is None:
        return Request(method, s)
    if where == "whole":
        return Request(method, s, s if matches else _text(rng, mix, length))
    if not matches:
        pattern = _text(rng, mix, plen)
    elif where == "prefix":
        pattern = s[:plen]
    elif where == "suffix":
        pattern = s[length - plen:]
    else:
        at = int(rng.integers(0, length - plen + 1))
        pattern = s[at:at + plen]
    to = _text(rng, mix, plen) if kind.REPLACEMENT else b""
    return Request(method, s, pattern, to)
