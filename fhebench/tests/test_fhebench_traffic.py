"""The traffic generator: deterministic per seed, the same sizes for every
seed, and matching patterns where each method finds them."""

from __future__ import annotations

import collections
import os

import pytest

from fhebench import methods, reference, traffic

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = ("interactive", "bulk")


def mix(name: str) -> dict:
    return traffic.load(traffic.find(PKG, name))


def sizes(requests) -> collections.Counter:
    return collections.Counter((r.method, len(r.string), len(r.pattern))
                               for r in requests)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    m = mix(name)
    assert traffic.make(m, 2**31 + 7) == traffic.make(m, 2**31 + 7)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_text_same_sizes(name):
    m = mix(name)
    a, b = traffic.make(m, 1), traffic.make(m, 2**33 + 5)
    assert a != b
    assert sizes(a) == sizes(b)
    # the same sizes in the same order: the same work, request by request
    assert ([(r.method, len(r.string), len(r.pattern)) for r in a]
            == [(r.method, len(r.string), len(r.pattern)) for r in b])
    assert len(a) == m["decks"] * m["per_method"] * len(m["methods"])


@pytest.mark.parametrize("name", MIXES)
def test_every_deck_holds_the_same_sizes(name):
    m = mix(name)
    reqs = traffic.make(m, 99)
    per_deck = len(reqs) // m["decks"]
    decks = [sizes(reqs[i:i + per_deck])
             for i in range(0, len(reqs), per_deck)]
    assert all(d == decks[0] for d in decks)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_alphabet_and_matches(name):
    m = mix(name)
    lo, hi = m["alphabet"]
    matched = collections.Counter()
    total = collections.Counter()
    for r in traffic.make(m, 5):
        assert m["string_len"][0] <= len(r.string) <= m["string_len"][1]
        assert all(lo <= c <= hi for c in r.string + r.pattern + r.to)
        where = methods.load(r.method).PATTERN
        if where is None:
            continue
        total[r.method] += 1
        if where == "whole":
            matched[r.method] += r.pattern == r.string
            continue
        assert m["pattern_len"][0] <= len(r.pattern) <= m["pattern_len"][1]
        assert len(r.to) == (len(r.pattern)
                             if methods.load(r.method).REPLACEMENT else 0)
        found = {"prefix": reference.starts_with,
                 "suffix": reference.ends_with,
                 "anywhere": lambda s, p: reference.find(s, p) >= 0}[where]
        matched[r.method] += found(r.string, r.pattern)
    for method, n in total.items():
        # half match by construction; a random pattern may match too
        assert matched[method] >= n * m["match_share"], method


@pytest.mark.parametrize("name", MIXES)
def test_every_round_holds_each_method_once(name):
    m = mix(name)
    reqs = traffic.make(m, 31)
    width = len(m["methods"])
    for i in range(0, len(reqs), width):
        assert sorted(r.method for r in reqs[i:i + width]) == sorted(
            m["methods"])


def test_fewer_decks_deal_the_same_first_requests():
    m = mix("bulk")
    short = traffic.make(m, 2**32 + 3)
    long = traffic.make(dict(m, decks=m["decks"] + 2), 2**32 + 3)
    assert short == long[:len(short)]
