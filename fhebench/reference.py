"""The plain reference: what each string method answers, from the
plaintexts.

Written as loops over the bytes of ASCII strings, with no call to a ``str``
method that computes the answer, so that it stands apart from Python's own
``str`` (``tests/test_fhebench_reference.py`` holds the two equal) and from
the program, of which it imports nothing.  Each method's answer is its
file's ``answer`` (``methods/<name>.py``), built from the loops here, in
the form the benchmark decrypts the program's result to: a flag 0 or 1, a
length or an index (255 where there is none: the reference client's
convention), a string's bytes, or a string with its flag.
"""

from __future__ import annotations

NOT_FOUND = 255


def find(s: bytes, pat: bytes) -> int:
    for i in range(len(s) - len(pat) + 1):
        if all(s[i + j] == pat[j] for j in range(len(pat))):
            return i
    return -1


def found_at(s: bytes, pat: bytes) -> int:
    """The first index of ``pat`` in ``s``, or NOT_FOUND."""
    i = find(s, pat)
    return NOT_FOUND if i < 0 else i


def starts_with(s: bytes, pat: bytes) -> bool:
    return len(pat) <= len(s) and all(s[j] == pat[j] for j in range(len(pat)))


def ends_with(s: bytes, pat: bytes) -> bool:
    off = len(s) - len(pat)
    return off >= 0 and all(s[off + j] == pat[j] for j in range(len(pat)))


def map_case(s: bytes, lo: int, hi: int, shift: int) -> bytes:
    return bytes(c + shift if lo <= c <= hi else c for c in s)


def replace(s: bytes, frm: bytes, to: bytes) -> bytes:
    if not frm:  # an empty pattern matches between every pair of chars
        out = bytearray(to)
        for c in s:
            out += bytes([c]) + to
        return bytes(out)
    out, i = bytearray(), 0
    while i < len(s):
        if s[i:i + len(frm)] == frm:
            out += to
            i += len(frm)
        else:
            out.append(s[i])
            i += 1
    return bytes(out)

