"""String-engine parity tests against the Python str oracle (ClearBackend).

Mirrors the reference's in-crate test suite (src/main.rs:118-1154: positive/
negative cases, no-op cases, empty strings, not-found sentinels, padding
invariance, split normalization via trim_vector) and adds randomized
property tests. Runs in plain numpy, so the whole reference behavior surface
is exercised in seconds.

On the port: a twin of tests/test_engine_clear.py with the imports switched to
fhestring_tpu_torch and the keys on the CPU."""

import numpy as np
import pytest
import torch

from fhestring_tpu_torch.engine.backend import ClearBackend
from fhestring_tpu_torch.engine.strings import StringEngine

torch.set_num_threads(1)

E = StringEngine(ClearBackend())
PAD = 1  # STRING_PADDING, reference main.rs:12


def enc(s: str, padding: int = PAD) -> np.ndarray:
    return np.frombuffer(s.encode() + b"\0" * padding, dtype=np.uint8).copy()


def dec(arr: np.ndarray) -> str:
    out = bytearray()
    for v in arr:
        if v == 0:
            break
        out.append(int(v))
    return out.decode()


def dec_buffers(grid: np.ndarray) -> list[str]:
    return [dec(grid[j]) for j in range(grid.shape[0])]


def trim_vector(v: list[str]) -> list[str]:
    v = list(v)
    while v and v[0] == "":
        v.pop(0)
    while v and v[-1] == "":
        v.pop()
    return v


class TestPredicates:
    def test_contains(self):
        assert E.contains(enc("awesome zama is awesome", 3), enc("zama", 0)) == 1
        assert E.contains(enc("hello world", 1), enc("zama", 0)) == 0
        assert E.contains(enc("aaa", 1), enc("aaa", 0)) == 1
        assert E.contains(enc("", 1), enc("x", 0)) == 0
        assert E.contains(enc("abc", 1), enc("", 0)) == 1

    def test_starts_with(self):
        assert E.starts_with(enc("hello world"), enc("hello", 0)) == 1
        assert E.starts_with(enc("hello world"), enc("ello", 0)) == 0
        assert E.starts_with(enc("abc"), enc("", 0)) == 1
        assert E.starts_with(enc("ab"), enc("abcdef", 0)) == 0

    def test_ends_with(self):
        assert E.ends_with(enc("hello world"), enc("world", 0)) == 1
        assert E.ends_with(enc("hello world", 5), enc("world", 0)) == 1
        assert E.ends_with(enc("hello world"), enc("hello", 0)) == 0
        assert E.ends_with(enc("abc", 3), enc("", 0)) == 1

    def test_is_empty_len(self):
        assert E.is_empty(enc("")) == 1
        assert E.is_empty(enc("a")) == 0
        assert int(E.len(enc("hello world", 4))) == 11
        assert int(E.len(enc(""))) == 0

    def test_eq_ne_padding_invariance(self):
        # reference main.rs doc: eq uses differing paddings
        assert E.eq_strings(enc("hello test", 1), enc("hello test", 21)) == 1
        assert E.eq_strings(enc("hello test"), enc("hello tesa")) == 0
        assert E.eq_strings(enc("hello"), enc("hello world")) == 0
        assert E.ne_strings(enc("abc", 2), enc("abc", 7)) == 0
        assert E.ne_strings(enc("abc"), enc("abd")) == 1

    def test_eq_ignore_case(self):
        assert E.eq_ignore_case(enc("hello TEST"), enc("hello test", 21)) == 1
        assert E.eq_ignore_case(enc("Hello"), enc("hellO", 3)) == 1
        assert E.eq_ignore_case(enc("hella"), enc("hello")) == 0

    @pytest.mark.parametrize("a,b", [
        ("hello test", "hello test"), ("aaa", "aa"), ("aa", "aaa"),
        ("abc", "abd"), ("abd", "abc"), ("", "a"), ("a", ""),
        ("zz", "za"), ("Zz", "zZ")])
    def test_comparisons(self, a, b):
        for op, pyop in [("lt", a < b), ("le", a <= b), ("gt", a > b),
                         ("ge", a >= b)]:
            got = E.compare(enc(a, 2), enc(b, 1), op)
            assert got == (1 if pyop else 0), (a, b, op)


class TestSearch:
    def test_find(self):
        assert int(E.find(enc("hello test"), enc("test", 0))) == 6
        assert int(E.find(enc("hello test"), enc("zzz", 0))) == 255
        assert int(E.find(enc("hello abc abc"), enc("abc", 0))) == 6
        assert int(E.find(enc("hello"), enc("", 0))) == 0

    def test_rfind(self):
        assert int(E.rfind(enc("hello abc abc test"), enc("abc", 0))) == 10
        assert int(E.rfind(enc("hello"), enc("zzz", 0))) == 255
        assert int(E.rfind(enc("hello"), enc("", 0))) == 5

    def test_find_size_panic(self):
        with pytest.raises(ValueError):
            E.find(enc("a" * 260), enc("a", 0))
        with pytest.raises(ValueError):
            E.rfind(enc("a" * 260), enc("a", 0))


class TestRewrite:
    def test_case_mapping(self):
        assert dec(E.to_upper(enc("zama IS awesome"))) == "ZAMA IS AWESOME"
        assert dec(E.to_lower(enc("zama IS awesome"))) == "zama is awesome"

    def test_trim(self):
        assert dec(E.trim_end(enc("ZAMA\n\t \r\x0c"))) == "ZAMA"
        assert dec(E.trim_start(enc("\n\t ZAMA"))) == "ZAMA"
        assert dec(E.trim(enc("\nZAMA\n\t"))) == "ZAMA"
        assert dec(E.trim_end(enc("no trailing"))) == "no trailing"
        assert dec(E.trim(enc(" "))) == ""

    def test_concat(self):
        assert dec(E.concatenate(enc("Hello, "), enc("World!"))) == "Hello, World!"
        assert dec(E.concatenate(enc(""), enc("x"))) == "x"

    def test_repeat_clear(self):
        assert dec(E.repeat_clear(enc("abc"), 3)) == "abcabcabc"
        assert dec(E.repeat_clear(enc("abc"), 0)) == ""

    def test_repeat_encrypted(self):
        n = np.uint8(3)
        assert dec(E.repeat(enc("ab"), n)) == "ababab"
        assert dec(E.repeat(enc("ab"), np.uint8(0))) == ""

    def test_compact_matches_bubble(self):
        rng = np.random.default_rng(0)
        for _ in range(50):
            arr = rng.integers(0, 3, size=rng.integers(1, 20)).astype(np.uint8)
            arr[arr == 2] = 65
            got = E.compact_zeros_right(arr.copy())
            nz = arr[arr != 0]
            want = np.concatenate([nz, np.zeros(len(arr) - len(nz), np.uint8)])
            np.testing.assert_array_equal(got, want)


class TestReplace:
    def test_replace_longer_from(self):
        got = E.replace(enc("hello world world test"), enc("world", 0), enc("abc", 0))
        assert dec(got) == "hello abc abc test"

    def test_replace_equal_len(self):
        got = E.replace(enc("hello world"), enc("world", 0), enc("earth", 0))
        assert dec(got) == "hello earth"

    def test_replace_shorter_from(self):
        got = E.replace(enc("hello abc abc test"), enc("abc", 0), enc("world", 0))
        assert dec(got) == "hello world world test"

    def test_replace_not_found(self):
        got = E.replace(enc("hello"), enc("xyz", 0), enc("ab", 0))
        assert dec(got) == "hello"

    def test_replacen_longer(self):
        got = E.replace(enc("hello world world test"), enc("world", 0),
                        enc("abc", 0), n_enc=np.uint8(1))
        assert dec(got) == "hello abc world test"

    def test_replacen_shorter(self):
        got = E.replace(enc("hello abc abc test"), enc("abc", 0),
                        enc("world", 0), n_enc=np.uint8(1))
        assert dec(got) == "hello world abc test"

    def test_replacen_zero(self):
        got = E.replace(enc("aaa"), enc("a", 0), enc("b", 0), n_enc=np.uint8(0))
        assert dec(got) == "aaa"

    @pytest.mark.parametrize("s,f,t", [
        ("banana", "an", "x"), ("banana", "a", "xy"), ("abcabc", "abc", ""),
        ("hello", "l", "L"), ("xxx", "x", "yy")])
    def test_replace_vs_python(self, s, f, t):
        got = E.replace(enc(s), enc(f, 0), enc(t, 0))
        assert dec(got) == s.replace(f, t)

    @pytest.mark.parametrize("n", [0, 1, 2, 5])
    def test_replacen_vs_python(self, n):
        s, f, t = "one two two two", "two", "2"
        got = E.replace(enc(s), enc(f, 0), enc(t, 0), n_enc=np.uint8(n))
        assert dec(got) == s.replace(f, t, n)


class TestSplit:
    def test_split(self):
        buffers, found = E._split(enc(" Mary had a"), enc(" ", 0), False, False, None)
        assert trim_vector(dec_buffers(buffers)) == ["Mary", "had", "a"]
        assert found == 1

    def test_split_not_found(self):
        buffers, found = E._split(enc("abc"), enc("z", 0), False, False, None)
        assert trim_vector(dec_buffers(buffers)) == ["abc"]
        assert found == 0

    def test_split_inclusive(self):
        buffers, _ = E._split(enc("Mary had a little"), enc(" ", 0), True, False, None)
        assert trim_vector(dec_buffers(buffers)) == ["Mary ", "had ", "a ", "little"]

    def test_split_terminator(self):
        buffers, _ = E._split(enc("A.B."), enc(".", 0), False, True, None)
        # reference semantics: same buffer layout as split after trim
        assert trim_vector(dec_buffers(buffers)) == ["A", "B"]

    def test_splitn(self):
        buffers, found = E._split(enc(".A.B.C."), enc(".", 0), False, False,
                                  np.uint8(2), skip_first_edge=True)
        assert trim_vector(dec_buffers(buffers)) == ["A.B.C."]
        assert found == 1

    def test_rsplit(self):
        buffers, found = E._rsplit(enc(".A.B.C."), enc(".", 0), False, False, None)
        assert trim_vector(dec_buffers(buffers)) == ["C", "B", "A"]
        assert found == 1

    def test_rsplit_once(self):
        buffers, _ = E._rsplit(enc("A.B.C"), enc(".", 0), False, False, np.uint8(2))
        assert trim_vector(dec_buffers(buffers)) == ["C", "A.B"]

    def test_rsplitn(self):
        # Rust: ".A.B.C.".rsplitn(3, ".") == ["", "C", ".A.B"]
        buffers, _ = E._rsplit(enc(".A.B.C."), enc(".", 0), False, False, np.uint8(3))
        assert trim_vector(dec_buffers(buffers)) == ["C", ".A.B"]

    def test_split_ascii_whitespace(self):
        buffers, found = E.split_ascii_whitespace(enc(" Mary  had\ta "))
        assert trim_vector(dec_buffers(buffers)) == ["Mary", "had", "a"]
        assert found == 1

    @pytest.mark.parametrize("s,p", [
        ("a.b.c", "."), ("..a..", "."), ("xyx", "y"), ("abc", "abc"),
        ("ab", "ab"), ("hello world rust", " ")])
    def test_split_vs_python(self, s, p):
        buffers, found = E._split(enc(s), enc(p, 0), False, False, None)
        assert trim_vector(dec_buffers(buffers)) == trim_vector(s.split(p))
        assert found == (1 if p in s else 0)

    @pytest.mark.parametrize("s,p", [
        ("a.b.c", "."), ("..a..", "."), ("hello world", " ")])
    def test_rsplit_vs_python(self, s, p):
        buffers, _ = E._rsplit(enc(s), enc(p, 0), False, False, None)
        want = trim_vector([x for x in reversed(s.split(p))])
        assert trim_vector(dec_buffers(buffers)) == want


class TestStrip:
    def test_strip_prefix(self):
        out, flag = E.strip_prefix(enc("HELLO test test HELLO"), enc("HELLO", 0))
        assert dec(out) == " test test HELLO"
        assert flag == 1

    def test_strip_prefix_absent(self):
        out, flag = E.strip_prefix(enc("hello"), enc("xyz", 0))
        assert dec(out) == "hello"
        assert flag == 0

    def test_strip_suffix(self):
        out, flag = E.strip_suffix(enc("HELLO test test HELLO"), enc("HELLO", 0))
        assert dec(out) == "HELLO test test "
        assert flag == 1

    def test_strip_suffix_absent(self):
        out, flag = E.strip_suffix(enc("hello"), enc("xyz", 0))
        assert dec(out) == "hello"
        assert flag == 0

    def test_strip_suffix_pattern_inside(self):
        out, flag = E.strip_suffix(enc("ababa"), enc("ab", 0))
        assert dec(out) == "ababa"
        assert flag == 0


class TestRandomizedParity:
    """Randomized differential testing vs Python str, mirroring the
    oracle-differential harness role of reference utils.rs:122-718."""

    ALPHABET = "ab x."

    def rand_str(self, rng, max_len=10):
        n = int(rng.integers(0, max_len))
        return "".join(self.ALPHABET[i] for i in rng.integers(0, len(self.ALPHABET), n))

    def test_predicates_random(self):
        rng = np.random.default_rng(7)
        for _ in range(200):
            s = self.rand_str(rng)
            p = self.rand_str(rng, 4)
            pad = int(rng.integers(1, 4))
            assert E.contains(enc(s, pad), enc(p, 0)) == (1 if p in s else 0), (s, p)
            assert E.starts_with(enc(s, pad), enc(p, 0)) == (
                1 if s.startswith(p) and len(p) <= len(s) + pad else 0), (s, p)
            got_ew = E.ends_with(enc(s, pad), enc(p, 0))
            assert got_ew == (1 if s.endswith(p) else 0), (s, p, pad)

    def test_find_random(self):
        rng = np.random.default_rng(8)
        for _ in range(200):
            s = self.rand_str(rng)
            p = self.rand_str(rng, 3)
            pad = int(rng.integers(1, 3))
            if len(p) == 0:
                continue
            want = s.find(p)
            want = 255 if want < 0 else want
            assert int(E.find(enc(s, pad), enc(p, 0))) == want, (s, p)
            want_r = s.rfind(p)
            want_r = 255 if want_r < 0 else want_r
            assert int(E.rfind(enc(s, pad), enc(p, 0))) == want_r, (s, p)

    def test_trim_random(self):
        rng = np.random.default_rng(9)
        for _ in range(100):
            s = self.rand_str(rng)
            pad = int(rng.integers(1, 3))
            assert dec(E.trim(enc(s, pad))) == s.strip(), s
            assert dec(E.trim_start(enc(s, pad))) == s.lstrip(), s
            assert dec(E.trim_end(enc(s, pad))) == s.rstrip(), s

    def test_split_random(self):
        rng = np.random.default_rng(10)
        for _ in range(60):
            s = self.rand_str(rng, 8)
            p = rng.choice([".", " ", "x", "ab"])
            pad = int(rng.integers(1, 3))
            buffers, _ = E._split(enc(s, pad), enc(p, 0), False, False, None)
            assert trim_vector(dec_buffers(buffers)) == trim_vector(s.split(p)), (s, p)


class TestRandomizedDifferential:
    """Fuzz the whole method surface against Python str on random inputs
    (the reference's oracle-differential shape, SURVEY.md section 4)."""

    ALPHABET = "abcxy .Z"

    def _rand(self, rng, max_len=9):
        n = int(rng.integers(0, max_len))
        return "".join(self.ALPHABET[i] for i in rng.integers(
            0, len(self.ALPHABET), n))

    def test_fuzz_predicates_and_search(self):
        rng = np.random.default_rng(0)
        for _ in range(60):
            s = self._rand(rng)
            p = self._rand(rng, 4)
            pad = int(rng.integers(1, 4))
            es, ep = enc(s, pad), enc(p, 0)
            assert E.contains(es, ep) == (p in s), (s, p)
            assert E.starts_with(es, ep) == s.startswith(p), (s, p)
            assert E.ends_with(es, ep) == s.endswith(p), (s, p)
            want_find = s.find(p)
            assert E.find(es, ep) == (255 if want_find < 0 else want_find)
            assert E.len(es) == len(s)

    def test_fuzz_compare(self):
        rng = np.random.default_rng(1)
        for _ in range(40):
            a, b = self._rand(rng), self._rand(rng)
            ea = enc(a, int(rng.integers(1, 3)))
            eb = enc(b, int(rng.integers(1, 3)))
            assert E.eq_strings(ea, eb) == (a == b), (a, b)
            assert E.compare(ea, eb, "lt") == (a < b), (a, b)
            assert E.compare(ea, eb, "ge") == (a >= b), (a, b)

    def test_fuzz_rewrite(self):
        rng = np.random.default_rng(2)
        for _ in range(30):
            s = self._rand(rng)
            f = self._rand(rng, 3) or "a"
            t = self._rand(rng, 3)
            es = enc(s, int(rng.integers(1, 3)))
            got = dec(E.replace(es, enc(f, 0), enc(t, 0)))
            assert got == s.replace(f, t), (s, f, t)
            assert dec(E.trim(enc(s, 1))) == s.strip()
            assert dec(E.to_upper(es)) == s.upper()

    def test_fuzz_split(self):
        rng = np.random.default_rng(3)
        for _ in range(15):
            s = self._rand(rng, 7)
            p = self._rand(rng, 2) or "."
            grid, found = E._split(enc(s, 1), enc(p, 0), False, False, None)
            assert trim_vector(dec_buffers(grid)) == trim_vector(s.split(p)), \
                (s, p)
