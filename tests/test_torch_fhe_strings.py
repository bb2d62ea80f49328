"""End-to-end FHE string methods: encrypt -> server -> decrypt on small
params. This is the SURVEY.md section 7 "minimum end-to-end slice" (len +
is_empty + eq on 8-char strings) plus a few representative methods from each
family. The full 52-method surface is covered by the CLI harness
(python -m fhestring_tpu.cli) and, in plaintext semantics, by
test_engine_clear.py.

On the port: a twin of tests/test_fhe_strings.py with the imports switched to
fhestring_tpu_torch and the keys on the CPU."""

import pytest
import torch

from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.params import PARAM_TEST_STAT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=3, device="cpu")
    return ck, ck.get_server_key()


class TestMinimumSlice:
    def test_len(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("encrypt!", 1)
        assert ck.decrypt_char(srv.len(s)) == 8

    def test_is_empty(self, ctx):
        ck, srv = ctx
        assert ck.decrypt_char(srv.is_empty(ck.encrypt("", 2))) == 1
        assert ck.decrypt_char(srv.is_empty(ck.encrypt("x", 1))) == 0

    def test_eq_padding_invariant(self, ctx):
        ck, srv = ctx
        a = ck.encrypt("encrypt!", 1)
        b = ck.encrypt("encrypt!", 4)  # different padding must not matter
        c = ck.encrypt("encrypt?", 1)
        assert ck.decrypt_char(srv.eq(a, b)) == 1
        assert ck.decrypt_char(srv.eq(a, c)) == 0


class TestFamilies:
    def test_contains(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("zama is", 2)
        assert ck.decrypt_char(srv.contains(s, ck.encrypt_no_padding("ama"))) == 1
        assert ck.decrypt_char(srv.contains_clear(s, "xyz")) == 0

    def test_find(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("hello", 1)
        assert ck.decrypt_char(srv.find_clear(s, "llo")) == 2
        assert ck.decrypt_char(srv.find_clear(s, "zz")) == 255

    def test_to_upper(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("aB c!", 1)
        assert ck.decrypt(srv.to_upper(s)) == "AB C!"

    def test_trim(self, ctx):
        ck, srv = ctx
        s = ck.encrypt(" hi \t", 1)
        assert ck.decrypt(srv.trim(s)) == "hi"

    def test_replace(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("aXa", 1)
        assert ck.decrypt(srv.replace_clear(s, "X", "b")) == "aba"

    def test_split(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("a.b", 1)
        parts, found = ck.decrypt_split(srv.split_clear(s, "."))
        parts = [p for p in parts if p]
        assert parts == ["a", "b"]
        assert found == 1

    def test_strip_prefix(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("ab.c", 1)
        out, flag = ck.decrypt_strip(srv.strip_prefix_clear(s, "ab"))
        assert (out, flag) == (".c", 1)

    def test_comparisons(self, ctx):
        ck, srv = ctx
        a, b = ck.encrypt("abc", 1), ck.encrypt("abd", 2)
        assert ck.decrypt_char(srv.lt(a, b)) == 1
        assert ck.decrypt_char(srv.ge(a, b)) == 0
        assert ck.decrypt_char(srv.ne(a, b)) == 1


class TestNBCollision:
    """Regression: buffer length == NB (4) made shape-sniffing backends
    misread bit tensors as char tensors (e.g. 'a.b' + 1 pad)."""

    def test_repeat_clear_len4(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("a.b", 1)  # L = 4
        assert ck.decrypt(srv.repeat_clear(s, 1)) == "a.b"
        assert ck.decrypt(srv.repeat_clear(s, 2)) == "a.ba.b"

    def test_contains_trim_len4(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("a.b", 1)
        assert ck.decrypt_char(srv.contains_clear(s, ".b")) == 1
        assert ck.decrypt_char(srv.len(s)) == 3
        assert ck.decrypt(srv.trim(ck.encrypt(" ab", 1))) == "ab"

    def test_split_len4(self, ctx):
        ck, srv = ctx
        s = ck.encrypt("a.b", 1)
        parts, found = ck.decrypt_split(srv.split_clear(s, "."))
        assert [p for p in parts if p] == ["a", "b"]
        assert found == 1


class TestRealisticNoise:
    """String methods under statistically meaningful noise (PARAM_TEST_STAT:
    prod-relative LWE noise) — everything above ran at zero noise. Covers
    one method per PBS-shape family: predicate (eq), search grid (contains),
    case map (to_upper), compaction (trim)."""

    @pytest.fixture(scope="class")
    def nctx(self):
        ck = ClientKey(PARAM_TEST_STAT, seed=5, device="cpu")
        return ck, ck.get_server_key()

    def test_noisy_eq_contains(self, nctx):
        ck, srv = nctx
        a = ck.encrypt("noise!", 1)
        b = ck.encrypt("noise!", 3)
        assert ck.decrypt_char(srv.eq(a, b)) == 1
        assert ck.decrypt_char(srv.contains_clear(a, "ise")) == 1
        assert ck.decrypt_char(srv.contains_clear(a, "zzz")) == 0

    def test_noisy_to_upper_trim(self, nctx):
        ck, srv = nctx
        assert ck.decrypt(srv.to_upper(ck.encrypt("aB c", 1))) == "AB C"
        assert ck.decrypt(srv.trim(ck.encrypt(" hi ", 1))) == "hi"


class TestPublicKey:
    def test_public_key_encrypt_roundtrip_and_op(self, ctx):
        """Public-key (zero-encryption subset-sum) parity: the reference
        builds a tfhe PublicKey it never uses (client_key.rs:32); here it
        is a usable encryption path. Small zero_count for CI speed (the
        LHL-secure count is documented in numpy_ref.public_keygen)."""
        ck, srv = ctx
        pk = ck.get_public_key(zero_count=512)
        s = ck.encrypt_with_public_key(pk, "Pk!", padding=2)
        assert ck.decrypt(s) == "Pk!"
        assert ck.decrypt_char(srv.contains_clear(s, "k!")) == 1
