"""tests/test_torch_cli_short_q32b.py at the 64-bit CI set
PARAM_TEST_ZERO_NOISE: the second half of the variants the long-string
file leaves to its ``slow`` tier, bit for bit against the JAX package on
one-character inputs.

Tolerance: zero.
"""

import pytest
import torch

import test_torch_cli_q32 as base
import test_torch_cli_short_q32 as short

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    return short.Pairs("q64")


@pytest.mark.parametrize("method", short.HALVES[1])
def test_short_variant_matches_jax_package(pairs, method):
    base.check_method(pairs.of(method), method)
