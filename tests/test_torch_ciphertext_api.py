"""Structural ciphertext API parity (reference src/ciphertext/fhestring.rs)
and utils helpers (src/utils.rs).

On the port: a twin of tests/test_ciphertext_api.py with the imports switched to
fhestring_tpu_torch and the keys on the CPU."""

import torch

from fhestring_tpu_torch import Comparison, PARAM_TEST_ZERO_NOISE
from fhestring_tpu_torch.ciphertext import FheString
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.utils import (
    abs_difference,
    adjust_end_of_pattern,
    trim_str_vector,
    trim_vector,
)

torch.set_num_threads(1)


def test_utils_parity():
    assert abs_difference(3, 10) == 7 and abs_difference(10, 3) == 7
    assert trim_vector(["", "a", "", "b", ""]) == ["a", "", "b"]
    assert trim_str_vector(["a\x00", ""], trim_zeroes=True) == ["a"]
    assert adjust_end_of_pattern(10, 3) == 7
    assert adjust_end_of_pattern(2, 5) == 1


def test_comparison_enum():
    assert {c.value for c in Comparison} == {"lt", "le", "gt", "ge"}


def test_fhestring_structural_ops():
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=2, device="cpu")
    s = ck.encrypt("ab", 1)       # "ab\0"
    t = ck.encrypt_no_padding("cd")

    # indexing / chars / from_chars round trip
    assert len(s) == 3
    chars = s.chars()
    assert len(chars) == 3
    rebuilt = FheString.from_chars(chars)
    assert ck.decrypt(rebuilt) == "ab"

    # slice
    assert ck.decrypt(s[:2]) == "ab"

    # append / push are structural (no NUL compaction)
    su = s.append(t)
    assert len(su) == 5
    got = ck.decrypt_blocks_to_bytes(su.blocks)
    assert bytes(got) == b"ab\x00cd"

    pushed = t.push(ck.encrypt_char(ord("!")))
    assert ck.decrypt(pushed) == "cd!"

    assert not s.is_empty_buffer()
    assert ck.encrypt("", 0).is_empty_buffer()
