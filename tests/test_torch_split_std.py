"""The split family against Rust's ``str`` semantics.

The reference crate claims Rust's ``str`` methods, and the port's engine
follows Rust: its forward scan finds the leftmost non-overlapping matches
and its reverse scan the rightmost ones, searched from the end (the crate's
own forward scan, and the JAX package's, differ where a pattern overlaps
itself: ``"aaaaa".split("aa")``).  Rust's semantics are written here in this
file's own loops over the characters (``_forward``, ``_backward``,
``RUST``), not taken from Python's ``str`` or from the benchmark's
reference.  Every result is compared after the reference binary's
``trim_vector`` (leading and trailing empty pieces dropped), as its driver
compares them; the ``pattern_found`` flag is compared as it is.

- The clear backend (``ClearBackend``, the spec the FHE backend is held
  to), exhaustively: every string over ``"ab "`` of 0-6 characters with
  every pattern of 1-3.  The split engine compares characters only with
  one another and with NUL, so its answers commute with any renaming of
  ``a``, ``b`` and `` ``; each case runs one pair of every class of
  renamings (7,115 of the 42,627 pairs), and ``test_renaming_commutes``
  holds that property on a seeded sample of all the variants.
  ``split_ascii_whitespace``, which treats the space apart, runs every
  string.
- The clear backend on seeded random printable strings of 4-16 chars.
- The FHE backend on the CPU at ``PARAM_TEST32_ZERO_NOISE``: two inputs
  with a self-overlapping pattern, one of them the shortest on which the
  crate's forward scan gives another answer than Rust.

Tolerance: zero.  Pieces and flags must be equal.
"""

import itertools

import numpy as np
import pytest
import torch

from fhestring_tpu_torch import PARAM_TEST32_ZERO_NOISE
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.engine.backend import ClearBackend
from fhestring_tpu_torch.engine.strings import StringEngine

torch.set_num_threads(1)

E = StringEngine(ClearBackend())
PAD = 1  # STRING_PADDING, reference main.rs:12
ALPHABET = "ab "


# ---- Rust's semantics, in plain loops ------------------------------------
def _at(s: str, p: str, i: int) -> bool:
    return all(s[i + j] == p[j] for j in range(len(p)))


def _forward(s: str, p: str) -> list[int]:
    """Starts of the leftmost non-overlapping matches (Rust's searcher)."""
    out, i = [], 0
    while i + len(p) <= len(s):
        if _at(s, p, i):
            out.append(i)
            i += len(p)
        else:
            i += 1
    return out


def _backward(s: str, p: str) -> list[int]:
    """Starts of the rightmost non-overlapping matches, found from the end
    (Rust's reverse searcher), last first."""
    out, end = [], len(s)
    while end - len(p) >= 0:
        if _at(s, p, end - len(p)):
            out.append(end - len(p))
            end -= len(p)
        else:
            end -= 1
    return out


def _split(s, p, n=None, inclusive=False):
    """Rust's split (n None), splitn(n) and split_inclusive."""
    if n == 0:
        return []
    starts = _forward(s, p)[:None if n is None else n - 1]
    out, prev = [], 0
    for i in starts:
        out.append(s[prev:i + len(p) if inclusive else i])
        prev = i + len(p)
    if not (inclusive and prev == len(s)):
        out.append(s[prev:])
    return out


def _rsplit(s, p, n=None):
    """Rust's rsplit (n None) and rsplitn(n): pieces from the end."""
    if n == 0:
        return []
    starts = _backward(s, p)[:None if n is None else n - 1]
    out, end = [], len(s)
    for i in starts:
        out.append(s[i + len(p):end])
        end = i
    out.append(s[:end])
    return out


def _drop_last_empty(v):
    return v[:-1] if v and v[-1] == "" else v


def _drop_first_empty(v):
    return v[1:] if v and v[0] == "" else v


def trim_vector(v):
    """The reference binary's trim_vector (utils.rs:59-74)."""
    v = list(v)
    while v and v[0] == "":
        v.pop(0)
    while v and v[-1] == "":
        v.pop()
    return v


# variant: (engine call, Rust's pieces); rsplit_once is the crate's: n = 2
# of rsplitn (split.rs:681-694), the pieces (after, before) where Rust's
# rsplit_once finds the pattern, the whole string where it does not
RUST = {
    "split": (lambda s, p: E._split(s, p, False, False, None),
              lambda s, p: _split(s, p)),
    "split_terminator": (lambda s, p: E._split(s, p, False, True, None),
                         lambda s, p: _drop_last_empty(_split(s, p))),
    "split_inclusive": (lambda s, p: E._split(s, p, True, False, None),
                        lambda s, p: _split(s, p, inclusive=True)),
    **{f"splitn{n}": (
        lambda s, p, n=n: E._split(s, p, False, False, np.uint8(n),
                                   skip_first_edge=True),
        lambda s, p, n=n: _split(s, p, n)) for n in range(4)},
    "rsplit": (lambda s, p: E._rsplit(s, p, False, False, None),
               lambda s, p: _rsplit(s, p)),
    "rsplit_terminator": (lambda s, p: E._rsplit(s, p, False, True, None),
                          lambda s, p: _drop_first_empty(_rsplit(s, p))),
    **{f"rsplitn{n}": (
        lambda s, p, n=n: E._rsplit(s, p, False, False, np.uint8(n)),
        lambda s, p, n=n: _rsplit(s, p, n)) for n in range(4)},
    "rsplit_once": (lambda s, p: E._rsplit(s, p, False, False, np.uint8(2)),
                    lambda s, p: _rsplit(s, p, 2)),
}


# ---- the engine's side ---------------------------------------------------
def enc(s: str, padding: int = PAD) -> np.ndarray:
    return np.frombuffer(s.encode() + b"\0" * padding, dtype=np.uint8).copy()


def dec_rows(grid) -> list[str]:
    out = []
    for row in grid:
        chars = bytearray()
        for v in row:
            if v == 0:
                break
            chars.append(int(v))
        out.append(chars.decode())
    return out


def engine(variant: str, s: str, p: str) -> tuple[list[str], int]:
    grid, found = RUST[variant][0](enc(s), enc(p, 0))
    return trim_vector(dec_rows(grid)), int(found)


def rust(variant: str, s: str, p: str) -> tuple[list[str], int]:
    return trim_vector(RUST[variant][1](s, p)), int(bool(_forward(s, p)))


def _words(length: int):
    return map("".join, itertools.product(ALPHABET, repeat=length))


STRINGS = [s for n in range(7) for s in _words(n)]


def _renamed(text: str) -> str:
    """``text`` with its characters renamed to a, b, space in the order
    they first appear."""
    names = {}
    for c in text:
        if c not in names:
            names[c] = ALPHABET[len(names)]
    return "".join(names[c] for c in text)


def classes(m: int) -> list[tuple[str, str]]:
    """One (string, pattern) pair of every class of renamings, patterns of
    m characters."""
    return [(s, p) for p in _words(m) for s in STRINGS
            if _renamed(p + s) == p + s]


# ---- the tests -----------------------------------------------------------
def test_the_classes_cover_every_pair():
    pairs = [(s, p) for m in (1, 2, 3) for p in _words(m) for s in STRINGS]
    reps = {m: classes(m) for m in (1, 2, 3)}
    assert len(pairs) == 42627
    assert sum(map(len, reps.values())) == 7115

    def key(s, p):
        return len(p), _renamed(p + s)
    assert {key(s, p) for m in reps for s, p in reps[m]} == {
        key(s, p) for s, p in pairs}


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("variant", list(RUST))
def test_clear_engine_is_rusts_on_every_short_string(variant, m):
    bad = [(s, p) for s, p in classes(m)
           if engine(variant, s, p) != rust(variant, s, p)]
    assert not bad, (len(bad), bad[:5])


def test_renaming_commutes():
    """The answers of a renamed pair are the renamed answers, for every
    variant and every renaming of a, b and space, on a seeded sample."""
    rng = np.random.default_rng(15)
    for _ in range(12):
        s = STRINGS[int(rng.integers(len(STRINGS)))]
        p = "".join(rng.choice(list(ALPHABET), int(rng.integers(1, 4))))
        for perm in itertools.permutations(ALPHABET):
            table = str.maketrans(ALPHABET, "".join(perm))
            for variant in RUST:
                pieces, found = engine(variant, s, p)
                assert engine(variant, s.translate(table),
                              p.translate(table)) == (
                    [x.translate(table) for x in pieces], found), \
                    (variant, s, p, perm)


def test_split_ascii_whitespace_on_every_short_string():
    for s in STRINGS:
        grid, found = E.split_ascii_whitespace(enc(s))
        words, word = [], ""
        for c in s + " ":
            if c == " ":
                if word:
                    words.append(word)
                word = ""
            else:
                word += c
        assert trim_vector(dec_rows(grid)) == words, s
        assert int(found) == int(" " in s), s


@pytest.mark.parametrize("variant", list(RUST))
def test_clear_engine_is_rusts_on_random_printable_strings(variant):
    rng = np.random.default_rng(2026)
    for _ in range(30):
        s = "".join(map(chr, rng.integers(32, 127, int(rng.integers(4, 17)))))
        m = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            at = int(rng.integers(0, len(s) - m + 1))
            p = s[at:at + m]
        else:
            p = "".join(map(chr, rng.integers(32, 127, m)))
        assert engine(variant, s, p) == rust(variant, s, p), (s, p)


@pytest.fixture(scope="module")
def keys():
    ck = ClientKey(PARAM_TEST32_ZERO_NOISE, seed=15, device="cpu")
    return ck, ck.get_server_key()


@pytest.mark.parametrize("s,p,clear", [
    ("aaa", "aa", False),
    # the shortest string on which the crate's forward scan differs from
    # Rust: it gives [], Rust ["", "", "a"] -> ["a"]
    ("aaaaa", "aa", True)])
def test_fhe_split_is_rusts_on_overlapping_patterns(keys, s, p, clear):
    ck, srv = keys
    es = ck.encrypt(s, 0)
    out = (srv.split_clear(es, p) if clear
           else srv.split(es, ck.encrypt_no_padding(p)))
    pieces, found = ck.decrypt_split(out)
    assert (trim_vector(pieces), found) == rust("split", s, p)
