"""The plain reference of the split family: Rust's ``str::split`` and
``str::rsplit``, the reference binary's ``trim_vector``, and the flag that
says whether the pattern was found.

Like ``reference.py``, loops over the bytes of ASCII strings, with no call
to a ``str`` or ``bytes`` method and nothing of the program
(``tests/test_fhebench_split.py`` holds it equal to Python's ``str.split``
forward and to a loop of ``rfind`` in reverse).  A split's answer is the
pieces after ``trim_vector``, each as bytes, with the flag 0 or 1: the
form the benchmark decrypts the program's ``FheSplit`` to.
"""

from __future__ import annotations


def _at(s: bytes, pat: bytes, i: int) -> bool:
    return all(s[i + j] == pat[j] for j in range(len(pat)))


def split(s: bytes, pat: bytes) -> list[bytes]:
    """Rust's ``s.split(pat)`` for a pattern of one byte or more: the
    pieces between the leftmost non-overlapping matches, searched from the
    start."""
    out, prev, i = [], 0, 0
    while i + len(pat) <= len(s):
        if _at(s, pat, i):
            out.append(s[prev:i])
            i += len(pat)
            prev = i
        else:
            i += 1
    out.append(s[prev:])
    return out


def rsplit(s: bytes, pat: bytes) -> list[bytes]:
    """Rust's ``s.rsplit(pat)`` for a pattern of one byte or more: the
    pieces between the rightmost non-overlapping matches, searched from
    the end, last piece first (not the forward split reversed where the
    pattern overlaps itself: ``b"aaa"`` at ``b"aa"`` gives ``[b"", b"a"]``
    here and ``[b"a", b""]`` reversed)."""
    out, end, j = [], len(s), len(s)
    while j - len(pat) >= 0:
        if _at(s, pat, j - len(pat)):
            out.append(s[j:end])
            j -= len(pat)
            end = j
        else:
            j -= 1
    out.append(s[:end])
    return out


def trim_vector(pieces: list[bytes]) -> list[bytes]:
    """The reference binary's ``trim_vector`` (fhestring src/utils.rs:59-74):
    the leading and the trailing empty pieces dropped, the inner ones
    kept."""
    lo, hi = 0, len(pieces)
    while lo < hi and len(pieces[lo]) == 0:
        lo += 1
    while hi > lo and len(pieces[hi - 1]) == 0:
        hi -= 1
    return [pieces[k] for k in range(lo, hi)]


def pattern_found(s: bytes, pat: bytes) -> int:
    """1 where ``pat`` occurs in ``s``, else 0."""
    return int(any(_at(s, pat, i) for i in range(len(s) - len(pat) + 1)))
