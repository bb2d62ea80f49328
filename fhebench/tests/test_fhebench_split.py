"""The split family's part of the benchmark: the plain reference against
Python's ``str``, the method files' decoding of a ``FheSplit``, and whole
runs of a short split mix on the CPU, sound and with a planted fault."""

from __future__ import annotations

import json
import os
import random

import pytest
import torch

from fhebench import methods, run
from fhebench import split_reference as ref

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 99
SPLITS = ("split", "split_clear", "rsplit", "rsplit_clear")


def cases(seed: int, alphabet: str, count: int):
    rng = random.Random(seed)
    for _ in range(count):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 16)))
        m = rng.randint(1, 3)
        if len(s) >= m and rng.random() < 0.5:
            i = rng.randint(0, len(s) - m)
            p = s[i:i + m]
        else:
            p = "".join(rng.choice(alphabet) for _ in range(m))
        yield s.encode(), p.encode()


def rfind_rsplit(s: bytes, p: bytes) -> list[bytes]:
    """Rust's rsplit by Python's rfind: the rightmost match that ends
    before the last one begins, again and again."""
    out, end = [], len(s)
    while (i := s.rfind(p, 0, end)) >= 0:
        out.append(s[i + len(p):end])
        end = i
    out.append(s[:end])
    return out


PRINTABLE = "".join(chr(c) for c in range(32, 127))


@pytest.mark.parametrize("alphabet", ["ab ", PRINTABLE],
                         ids=["ab_space", "printable"])
def test_reference_is_pythons(alphabet):
    for s, p in cases(15, alphabet, 2000):
        assert ref.split(s, p) == s.split(p), (s, p)
        assert ref.rsplit(s, p) == rfind_rsplit(s, p), (s, p)
        assert ref.pattern_found(s, p) == int(p in s), (s, p)
        pieces = s.split(p)
        while pieces and not pieces[0]:
            pieces.pop(0)
        while pieces and not pieces[-1]:
            pieces.pop()
        assert ref.trim_vector(s.split(p)) == pieces, (s, p)


def test_reverse_is_not_the_forward_split_reversed():
    assert ref.rsplit(b"aaa", b"aa") == [b"", b"a"]
    assert ref.split(b"aaa", b"aa")[::-1] == [b"a", b""]
    assert ref.trim_vector(ref.split(b"aaaaa", b"aa")) == [b"a"]
    assert ref.trim_vector(ref.rsplit(b"aaaaa", b"aa")) == [b"a"]
    assert ref.trim_vector(ref.split(b"aabaa", b"aa")) == [b"b"]


@pytest.mark.parametrize("name", SPLITS)
def test_decode_of_a_hand_made_split(name):
    from fhestring_tpu_torch.ciphertext import FheChar, FheSplit
    from fhestring_tpu_torch.shortint import Blocks

    # rows as the program leaves them: each piece first, then NULs; the
    # plaintext bytes stand in for the ciphertexts
    rows = [b"", b"ab", b"", b"c", b"", b""]
    grid = torch.zeros((len(rows), 4), dtype=torch.int64)
    for j, row in enumerate(rows):
        grid[j, :len(row)] = torch.tensor(list(row))
    result = FheSplit(Blocks(grid, 3, 1.0),
                      FheChar(Blocks(torch.tensor(1), 3, 1.0)))

    def text(x):
        out = bytearray()
        for byte in x.blocks.ct.tolist():
            if byte == 0:
                break
            out.append(byte)
        return bytes(out)

    def char(x):
        return int(x.blocks.ct)

    kind = methods.load(name)
    assert kind.PATTERN == "anywhere" and not kind.REPLACEMENT
    assert kind.ENCRYPTED_PATTERN == (not name.endswith("_clear"))
    assert kind.decode(result, text, char) == ([b"ab", b"", b"c"], 1)
    forward = kind.answer(b"ab..c", b".", b"")
    assert forward == ([b"ab", b"", b"c"] if name.startswith("split")
                       else [b"c", b"", b"ab"], 1)
    assert kind.answer(b"ab", b"x", b"") == ([b"ab"], 0)


def split_cell(tiny_bench, methods_=None):
    bench, base, root = tiny_bench
    with open(os.path.join(HERE, "configs", "split_mix.json")) as f:
        mix = json.load(f)
    if methods_ is not None:
        mix["methods"] = methods_
    with open(os.path.join(root, "traffic", "tinysplit.json"), "w") as f:
        json.dump(mix, f)
    bench["workloads"].append({"name": "tiny64.split", "config": "tiny64",
                               "traffic": "tinysplit", "chips": 1,
                               "why": "test"})
    return bench, base, root


def test_a_sound_split_run_is_correct(tiny_bench):
    bench, base, root = split_cell(tiny_bench)
    out = run.run_cell(bench, "tiny64.split", SEED, 0.1, False,
                       device="cpu", base=base, root=root, min_requests=2)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["checks"]["wrong_answers"] == {"value": 0, "limit": 0}


def test_a_dropped_piece_makes_the_run_not_correct(tiny_bench, monkeypatch):
    """Each split's first row zeroed, so that its first piece decrypts
    empty: a request whose first piece is not empty comes out wrong."""
    from fhestring_tpu_torch.engine.strings import StringEngine

    real = StringEngine._clear_pattern_from_result

    def dropped(self, *args):
        rows = real(self, *args)
        rows.ct[0] = 0
        return rows
    monkeypatch.setattr(StringEngine, "_clear_pattern_from_result", dropped)
    bench, base, root = split_cell(tiny_bench, ["split_clear"])
    out = run.run_cell(bench, "tiny64.split", SEED, 0.1, False,
                       device="cpu", base=base, root=root, min_requests=2)
    assert out["attempted"] >= 2
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0
