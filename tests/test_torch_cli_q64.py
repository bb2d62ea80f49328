"""All 52 method variants of the ported CLI against the JAX package, at the
64-bit CI set PARAM_TEST_ZERO_NOISE: the checks, tiers and helpers of
tests/test_torch_cli_q32.py (a file of its own so that the two families
run in parallel workers).

PARAM_TEST_ZERO_NOISE has the noise budget of PARAM_PROD (34), and the
counts depend only on the string lengths and the budget: the 52 counts of
this run are the table chip_smoke.py holds the card's PARAM_PROD runs to.

Tolerance: zero.
"""

import pytest
import torch

import test_torch_cli_q32 as base
from fhestring_tpu_torch import cli, params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return base.Pair("q64")


@pytest.mark.parametrize("method", cli.METHODS)
def test_variant_counts_match_jax_package(pair, method):
    base.check_counts(pair, method)


@pytest.mark.parametrize("method", base.variant_cases())
def test_variant_matches_jax_package(pair, method):
    base.check_method(pair, method)


@pytest.mark.parametrize("method", cli.METHODS)
def test_chip_smoke_prod_counts_equal_jax_engine(pair, method):
    """chip_smoke.PROD_COUNTS, (PBS items, batches) per variant, is the JAX
    engine's count at the same noise budget."""
    smoke = base.load_chip_smoke()
    assert params.PARAM_TEST_ZERO_NOISE.noise_budget == smoke.PROD_NOISE_BUDGET
    assert list(smoke.PROD_COUNTS) == cli.METHODS
    calls, items, _ = (pair.counts.get(method)
                       or base.check_counts(pair, method))
    assert smoke.PROD_COUNTS[method] == (items, calls)


def test_cli_main_passes_its_methods(capsys):
    base.check_cli_main("test", capsys, base.MAIN_METHODS)


@pytest.mark.slow
def test_cli_main_passes_all_52(capsys):
    base.check_cli_main("test", capsys)
