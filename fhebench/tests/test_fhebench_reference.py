"""The plain reference answers as Python's ``str`` does."""

from __future__ import annotations

import os
import random

import pytest

from fhebench import methods

METHODS = ("contains", "contains_clear", "find", "starts_with_clear",
           "ends_with_clear", "eq", "len", "to_upper", "to_lower",
           "replace_clear", "strip_prefix_clear")


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
        got = methods.load(method).answer(s.encode(), p.encode(),
                                          to.encode())
        assert got == python_str(method, s, p, to), (method, s, p, to)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError):
        methods.load("split")


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
