"""Butterfly compaction + grouped carry-save prefix scan (round 5).

compact_zeros_right is the engine's analog of the reference's
bubble_zeroes_right (reference src/utils.rs:28-46) and the PBS-dominant
primitive of repeat/replace/split/trim/concatenate. Round 5 replaced the
O(L^2) one-hot scatter grid with an oblivious butterfly router driven by a
grouped carry-save cumsum_bits; these tests pin down both primitives
directly (the method-level behavior is covered by test_engine_clear /
test_fhe_strings / the CLI harness).

On the port: a twin of tests/test_compaction.py with the imports switched to
fhestring_tpu_torch and the keys on the CPU."""

import numpy as np
import pytest
import torch

from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE
from fhestring_tpu_torch.ciphertext import FheChar
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.engine.backend import ClearBackend
from fhestring_tpu_torch.engine.strings import StringEngine
from fhestring_tpu_torch.shortint import Blocks

torch.set_num_threads(1)


def _ref_compact(row: np.ndarray) -> np.ndarray:
    nz = row[row != 0]
    return np.concatenate([nz, np.zeros(len(row) - len(nz), np.uint8)])


def test_clear_butterfly_fuzz():
    """250 random cases vs the stable-compaction spec, incl. batched."""
    eng = StringEngine(ClearBackend())
    rng = np.random.default_rng(0)
    for _ in range(200):
        L = int(rng.integers(1, 40))
        s = rng.integers(0, 5, size=L).astype(np.uint8)
        got = eng.compact_zeros_right(s)
        np.testing.assert_array_equal(got, _ref_compact(s))
    for _ in range(50):
        B, L = int(rng.integers(1, 5)), int(rng.integers(1, 30))
        s = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
        got = eng.compact_zeros_right(s)
        for i in range(B):
            np.testing.assert_array_equal(got[i], _ref_compact(s[i]))


def test_clear_cumsum_groups():
    """Group boundaries (g=15) of the carry-save scan, clear backend."""
    b = ClearBackend()
    rng = np.random.default_rng(1)
    for L in (1, 14, 15, 16, 31, 45):
        bits = rng.integers(0, 2, size=L).astype(np.uint8)
        np.testing.assert_array_equal(b.cumsum_bits(bits, 0), np.cumsum(bits))


@pytest.fixture(scope="module")
def ctx():
    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=3, device="cpu")
    return ck, ck.get_server_key()


def _enc_bits(ck, b, bits):
    """Encrypt a 0/1 vector as real ciphertext bits (via '0'/'1' chars)."""
    enc = ck.encrypt_no_padding("".join(chr(48 + int(x)) for x in bits))
    base = b.trivial_chars(np.full(len(bits), 48, np.uint8))
    return b.ne_zero(b.sub_chars(enc.blocks, base))


def test_fhe_cumsum_bits_grouped(ctx):
    """FHE carry-save scan crosses the g=15 group boundary correctly."""
    ck, srv = ctx
    b = srv.backend
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=18).astype(np.uint8)
    out = b.cumsum_bits(_enc_bits(ck, b, bits), 0)
    got = [ck.decrypt_char(FheChar(Blocks(out.ct[i], out.degree, out.noise_var)))
           for i in range(18)]
    assert got == np.cumsum(bits).tolist()


def test_fhe_butterfly_compaction(ctx):
    """FHE butterfly routing end-to-end through trim_start (NULs + routed
    displacement payload bits) and concatenate (multi-stage moves)."""
    ck, srv = ctx
    assert ck.decrypt(srv.trim_start(ck.encrypt("  a b", 2))) == "a b"
    out = srv.concatenate(ck.encrypt("ab", 1), ck.encrypt("cd", 3))
    assert ck.decrypt(out) == "abcd"
