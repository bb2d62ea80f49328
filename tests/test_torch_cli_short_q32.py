"""The method variants that tests/test_torch_cli_q32.py can only afford
with real bootstraps in its ``slow`` tier (the splits, Repeat, the clear and
counted replaces, Trim, Concatenate: thousands of bootstraps each on "hello
world"), here bit for bit against the JAX package in the default tier on
the shortest inputs that still reach the same engine code: the string "a"
(" a" for the variants that look for whitespace), pattern "a", n = 2, from
"a", to "b".  On these a variant costs 30 to 2,700 bootstraps.

As in that file, each variant goes through ``run_fhe_str_method`` of both
packages on the same evaluation keys and the same input ciphertexts, and
the output ciphertexts must be bit-identical, both must decrypt to what
Python's ``str`` gives, and ``metrics.GLOBAL`` must have counted the same
PBS calls, items and padded items.  Of each pair of split variants that
differ only in whether the pattern is encrypted, one runs here (the other
form of the pattern runs in a sibling pair); every other variant outside
``REAL`` runs.  Tolerance: zero.

The variants are listed from the dearest to the cheapest and dealt out in
turn to two files per family, so that no test file takes much longer than
the others when the suite gives each file to one worker: this file and
tests/test_torch_cli_short_q32b.py at the 32-bit CI set
PARAM_TEST32_ZERO_NOISE, tests/test_torch_cli_short_q64.py and _q64b.py at
the 64-bit one.
"""

import argparse

import pytest
import torch

import test_torch_cli_q32 as base
from fhestring_tpu_torch import cli

torch.set_num_threads(1)

SHORT = argparse.Namespace(string="a", pattern="a", n=2, frm="a", to="b")
SPACED = argparse.Namespace(string=" a", pattern="a", n=2, frm="a", to="b")
WHITESPACE = ("Trim", "TrimStart", "SplitAsciiWhitespace")
# by bootstraps on these inputs, most first
METHODS = ["Repeat", "RsplitOnceClear", "SplitN", "RsplitNClear", "Rsplit",
           "SplitTerminatorClear", "RsplitTerminator", "SplitInclusive",
           "SplitClear", "SplitAsciiWhitespace", "SplitInclusiveClear",
           "ReplaceClear", "RepeatClear", "Trim", "TrimStart",
           "ReplaceNClear", "ReplaceN", "StripPrefixClear",
           "StripSuffixClear", "Concatenate", "EndsWithClear"]
HALVES = (METHODS[0::2], METHODS[1::2])   # this file's and the b file's


def test_every_variant_outside_real_or_its_twin_runs_here():
    """With ``REAL`` of the long-string file, every variant runs with real
    bootstraps in the default tier, but for 7 splits whose twin (the same
    split with the pattern in the other form) does."""
    assert set(METHODS).isdisjoint(base.REAL)
    left = set(cli.METHODS) - set(base.REAL) - set(METHODS)
    assert len(left) == 7
    for name in left:
        twin = name[:-5] if name.endswith("Clear") else name + "Clear"
        assert twin in METHODS and "plit" in name


class Pairs:
    """One ``base.Pair`` per input set, made when first asked for."""

    def __init__(self, family):
        self.family, self.made = family, {}

    def of(self, method):
        args = SPACED if method in WHITESPACE else SHORT
        if args.string not in self.made:
            self.made[args.string] = base.Pair(self.family, args)
        return self.made[args.string]


@pytest.fixture(scope="module")
def pairs():
    return Pairs("q32")


@pytest.mark.parametrize("method", HALVES[0])
def test_short_variant_matches_jax_package(pairs, method):
    base.check_method(pairs.of(method), method)
