"""Cross-cutting helpers, API parity with reference src/utils.rs:11-120.

The heavy helper — ``bubble_zeroes_right`` (utils.rs:28-46, O(n^2)
sequential cmux) — is replaced by the engine's batched
``StringEngine.compact_zeros_right`` (rank-and-route compaction); the
remaining helpers are the test/result normalizers the harness uses.
"""

from __future__ import annotations


def abs_difference(a: int, b: int) -> int:
    """utils.rs:11-17."""
    return a - b if a > b else b - a


def trim_vector(v: list[str]) -> list[str]:
    """Strip leading/trailing empty strings (utils.rs:59-74)."""
    v = list(v)
    while v and v[0] == "":
        v.pop(0)
    while v and v[-1] == "":
        v.pop()
    return v


def trim_str_vector(v: list[str], trim_zeroes: bool = False) -> list[str]:
    """utils.rs:76-92: like trim_vector, optionally stripping NULs first."""
    if trim_zeroes:
        v = [s.rstrip("\x00") for s in v]
    return trim_vector(v)


def adjust_end_of_pattern(string_len: int, pattern_len: int) -> int:
    """Exclusive scan end for reverse window matchers (utils.rs:106-112)."""
    return max(string_len - pattern_len, 1)
