"""Radix (char-level) homomorphic ops vs plaintext oracle, real small-param
crypto end to end (encrypt -> server op -> decrypt), on the port: a twin
of tests/test_radix.py with the imports switched to fhestring_tpu_torch and
the keys on the CPU.  Tolerance: zero (decrypted values)."""

import numpy as np
import pytest
import torch

from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.crypto.keys import pack_server_keys
from fhestring_tpu_torch.radix import RadixContext
from fhestring_tpu_torch.shortint import ShortintContext

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=1, device="cpu")
    rc = RadixContext(ShortintContext(pack_server_keys(ck._server_raw,
                                                       "cpu")))
    return ck, rc


def enc_chars(ck, values):
    return ck._encrypt_bytes(bytes(values))


def dec(ck, blocks):
    return ck.decrypt_bits(blocks)


def dec_chars(ck, blocks):
    return ck.decrypt_blocks_to_bytes(blocks)


XS = [0, 1, 31, 32, 64, 65, 97, 122, 200, 255]
YS = [0, 31, 32, 99, 65, 65, 97, 121, 200, 254]


class TestComparisons:
    def test_eq_ne(self, ctx):
        ck, rc = ctx
        x, y = enc_chars(ck, XS), enc_chars(ck, YS)
        got_eq = dec(ck, rc.eq(x, y))
        got_ne = dec(ck, rc.ne(x, y))
        for i, (a, b) in enumerate(zip(XS, YS)):
            assert got_eq[i] == (1 if a == b else 0), (a, b)
            assert got_ne[i] == (1 if a != b else 0), (a, b)

    def test_ordering(self, ctx):
        ck, rc = ctx
        x, y = enc_chars(ck, XS), enc_chars(ck, YS)
        for name, fn, op in [
            ("lt", rc.lt, lambda a, b: a < b),
            ("le", rc.le, lambda a, b: a <= b),
            ("gt", rc.gt, lambda a, b: a > b),
            ("ge", rc.ge, lambda a, b: a >= b),
        ]:
            got = dec(ck, fn(x, y))
            for i, (a, b) in enumerate(zip(XS, YS)):
                assert got[i] == (1 if op(a, b) else 0), (name, a, b)

    def test_vs_trivial(self, ctx):
        ck, rc = ctx
        x = enc_chars(ck, XS)
        t = rc.trivial_chars(np.array(YS, np.uint64))
        got = dec(ck, rc.eq(x, t))
        for i, (a, b) in enumerate(zip(XS, YS)):
            assert got[i] == (1 if a == b else 0)


class TestBoolean:
    def test_and_or_not(self, ctx):
        ck, rc = ctx
        a = enc_chars(ck, [0, 0, 1, 1])
        b = enc_chars(ck, [0, 1, 0, 1])
        abit = rc.ne_zero(a)
        bbit = rc.ne_zero(b)
        assert list(dec(ck, rc.and_(abit, bbit))) == [0, 0, 0, 1]
        assert list(dec(ck, rc.or_(abit, bbit))) == [0, 1, 1, 1]
        assert list(dec(ck, rc.not_(abit))) == [1, 1, 0, 0]

    def test_any_all_axis(self, ctx):
        ck, rc = ctx
        rows = [
            [0, 0, 0, 0, 0, 0, 0],
            [0, 0, 1, 0, 0, 0, 0],
            [1, 1, 1, 1, 1, 1, 1],
            [1, 1, 1, 0, 1, 1, 1],
        ]
        flat = [v for r in rows for v in r]
        bits = rc.ne_zero(enc_chars(ck, flat))
        from fhestring_tpu_torch.shortint import Blocks
        resh = Blocks(bits.ct.reshape(4, 7, -1), bits.degree, bits.noise_var)
        assert list(dec(ck, rc.any_axis(resh, 1))) == [0, 1, 1, 1]
        assert list(dec(ck, rc.all_axis(resh, 1))) == [0, 0, 1, 0]


class TestSelection:
    def test_select(self, ctx):
        ck, rc = ctx
        cond = rc.ne_zero(enc_chars(ck, [1, 0, 1, 0]))
        x = enc_chars(ck, [10, 20, 30, 40])
        y = enc_chars(ck, [50, 60, 70, 80])
        assert list(dec_chars(ck, rc.select(cond, x, y))) == [10, 60, 30, 80]

    def test_mul_bit(self, ctx):
        ck, rc = ctx
        bit = rc.ne_zero(enc_chars(ck, [1, 0, 1]))
        x = enc_chars(ck, [200, 123, 7])
        assert list(dec_chars(ck, rc.mul_bit(x, bit))) == [200, 0, 7]


class TestPredicates:
    def test_ne_eq_zero(self, ctx):
        ck, rc = ctx
        x = enc_chars(ck, [0, 1, 4, 16, 64, 255])
        assert list(dec(ck, rc.ne_zero(x))) == [0, 1, 1, 1, 1, 1]
        assert list(dec(ck, rc.eq_zero(x))) == [1, 0, 0, 0, 0, 0]

    def test_is_whitespace(self, ctx):
        ck, rc = ctx
        vals = [0x08, 0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x0E, 0x20, 0x21, ord("a"), 0]
        x = enc_chars(ck, vals)
        want = [1 if chr(v).isspace() and v != 0 else 0 for v in vals]
        # python isspace for 0x0B/0x0C is True; rust char::is_whitespace too
        assert list(dec(ck, rc.is_whitespace(x))) == want

    def test_is_case(self, ctx):
        ck, rc = ctx
        vals = [ord("A"), ord("Z"), ord("a"), ord("z"), ord("@"), ord("["),
                ord("`"), ord("{"), ord("0"), 0x20]
        x = enc_chars(ck, vals)
        up = [1 if chr(v).isupper() else 0 for v in vals]
        low = [1 if chr(v).islower() else 0 for v in vals]
        assert list(dec(ck, rc.is_uppercase(x))) == up
        assert list(dec(ck, rc.is_lowercase(x))) == low

    def test_case_mapping(self, ctx):
        ck, rc = ctx
        vals = [ord(c) for c in "aZ@zA0{ `"]
        x = enc_chars(ck, vals)
        want_up = [ord(chr(v).upper()) for v in vals]
        want_low = [ord(chr(v).lower()) for v in vals]
        assert list(dec_chars(ck, rc.to_upper_char(x))) == want_up
        assert list(dec_chars(ck, rc.to_lower_char(x))) == want_low


class TestArithmetic:
    def test_add_sub(self, ctx):
        ck, rc = ctx
        xs = [0, 1, 100, 200, 255, 37]
        ys = [0, 255, 56, 100, 255, 200]
        x, y = enc_chars(ck, xs), enc_chars(ck, ys)
        assert list(dec_chars(ck, rc.add_chars(x, y))) == [(a + b) % 256 for a, b in zip(xs, ys)]
        assert list(dec_chars(ck, rc.sub_chars(x, y))) == [(a - b) % 256 for a, b in zip(xs, ys)]

    @pytest.mark.parametrize("n", [1, 4, 15, 16, 33])
    def test_sum_bits(self, ctx, n):
        ck, rc = ctx
        rng = np.random.default_rng(n)
        vals = rng.integers(0, 2, size=n).tolist()
        bits = rc.ne_zero(enc_chars(ck, vals))
        got = dec_chars(ck, rc.sum_bits(bits, 0))
        assert int(got) == sum(vals)
