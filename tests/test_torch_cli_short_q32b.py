"""The other half of tests/test_torch_cli_short_q32.py: the variants that
file leaves out, bit for bit against the JAX package on one-character
inputs at the 32-bit CI set PARAM_TEST32_ZERO_NOISE (a file of its own so
that the two halves run in parallel workers).

Tolerance: zero.
"""

import pytest
import torch

import test_torch_cli_q32 as base
import test_torch_cli_short_q32 as short

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    return short.Pairs("q32")


@pytest.mark.parametrize("method", short.HALVES[1])
def test_short_variant_matches_jax_package(pairs, method):
    base.check_method(pairs.of(method), method)
