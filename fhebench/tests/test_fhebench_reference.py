"""The plain reference answers as Python's ``str`` does; a split's as
Rust's ``str::split`` and ``str::rsplit`` do, by Python's ``split`` and
``rfind``, after the reference binary's ``trim_vector``."""

from __future__ import annotations

import os
import random

import pytest

from fhebench import methods

METHODS = ("contains", "contains_clear", "find", "starts_with_clear",
           "ends_with_clear", "eq", "len", "to_upper", "to_lower",
           "replace_clear", "strip_prefix_clear", "split", "split_clear",
           "rsplit", "rsplit_clear")
SPLITS = ("split", "split_clear", "rsplit", "rsplit_clear")


def trimmed(pieces: list[str]) -> list[bytes]:
    """``trim_vector``: the leading and trailing empty pieces dropped."""
    while pieces and not pieces[0]:
        pieces = pieces[1:]
    while pieces and not pieces[-1]:
        pieces = pieces[:-1]
    return [x.encode() for x in pieces]


def rust_rsplit(s: str, p: str) -> list[str]:
    """Rust's ``s.rsplit(p)``: the rightmost match that ends before the
    last one begins, again and again."""
    out, end = [], len(s)
    while (i := s.rfind(p, 0, end)) >= 0:
        out.append(s[i + len(p):end])
        end = i
    out.append(s[:end])
    return out


def python_str(method: str, s: str, p: str, to: str):
    if method in ("contains", "contains_clear"):
        return int(p in s)
    if method == "find":
        i = s.find(p)
        return 255 if i < 0 else i
    if method == "starts_with_clear":
        return int(s.startswith(p))
    if method == "ends_with_clear":
        return int(s.endswith(p))
    if method == "eq":
        return int(s == p)
    if method == "len":
        return len(s)
    if method == "to_upper":
        return s.upper().encode()
    if method == "to_lower":
        return s.lower().encode()
    if method == "replace_clear":
        return s.replace(p, to).encode()
    if method in ("split", "split_clear"):
        return trimmed(s.split(p)), int(p in s)
    if method in ("rsplit", "rsplit_clear"):
        return trimmed(rust_rsplit(s, p)), int(p in s)
    if s.startswith(p):
        return (s[len(p):].encode(), 1)
    return (None, 0)


def cases(seed: int, count: int):
    rng = random.Random(seed)
    alphabet = "abAB z!~" + "".join(chr(c) for c in range(32, 127, 7))
    for _ in range(count):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
        if s and rng.random() < 0.5:
            i = rng.randint(0, len(s) - 1)
            p = s[i:i + rng.randint(0, 4)]
        else:
            p = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 4)))
        to = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 4)))
        yield s, p, to


@pytest.mark.parametrize("method", METHODS)
def test_reference_equals_python_str(method):
    for s, p, to in cases(METHODS.index(method), 400):
        if method in SPLITS and not p:
            continue  # a split's reference takes patterns of 1 byte or
            # more, as the traffic sends; Python refuses an empty one
        got = methods.load(method).answer(s.encode(), p.encode(),
                                          to.encode())
        assert got == python_str(method, s, p, to), (method, s, p, to)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError):
        methods.load("no_such_method")


def test_every_method_file_is_tested_here():
    names = {f[:-3] for f in os.listdir(methods.HERE)
             if f.endswith(".py") and f != "__init__.py"}
    assert names == set(METHODS)


@pytest.mark.parametrize("method", METHODS)
def test_method_file_declares_its_request(method):
    m = methods.load(method)
    assert m.PATTERN in (None, "anywhere", "prefix", "suffix", "whole")
    assert m.ENCRYPTED_PATTERN in (True, False)
    assert m.REPLACEMENT in (True, False)
    assert not (m.PATTERN is None and (m.ENCRYPTED_PATTERN or m.REPLACEMENT))
