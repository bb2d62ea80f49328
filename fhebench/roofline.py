"""The yardstick of the blind rotation: its least int32 instructions and
bytes, and the peaks of the card.

The work of one bootstrap is ``n`` item-steps (one external product of the
accumulator with one GGSW of the bootstrap key) times a count per
item-step that the configuration's file fixes (``work``), whatever route
or kernel computes it.  The count is the least int32 instructions of the
two-prime NTT form of the external product that the configuration is
served with: a modular butterfly 5 (a Shoup product, three, and two lazy
adds), a pointwise multiply-add 1, over both primes.  The bytes are the
bootstrap key's values, read once a batch.  The card's peaks are 64 int32
lanes an SM at 1.98 GHz and 3.35 TB/s of HBM3 (an H100 SXM at 700 W).

Tensor cores can beat that int32 peak, so a share near 100% calls for a
new peak, not for a refusal of the kernel.
"""

from __future__ import annotations

INT32_LANES = 64
CLOCK_HZ = 1.98e9
MEMORY_RATE = 3.35e12
BUTTERFLY_OPS, PRODUCT_OPS = 5, 1


def ntt_instructions(n: int, transforms: int, products: int) -> int:
    """int32 instructions of one item's external product by the two-prime
    NTT: ``transforms`` radix-2 transforms of length n and ``products``
    modular multiply-adds per coefficient, both counted over the two
    primes."""
    butterflies = transforms * (n // 2) * (n.bit_length() - 1)
    return BUTTERFLY_OPS * butterflies + PRODUCT_OPS * products * n


def item_step_instructions(work: dict) -> int:
    """The count per item-step the configuration fixes (its derivation,
    ``ntt_instructions(polynomial_size, transforms, products)``, stands
    beside it in the file and is held to it by the tests)."""
    return work["instructions_per_item_step"]


def int32_peak(sm_count: int) -> float:
    """int32 instructions a second of the card."""
    return INT32_LANES * sm_count * CLOCK_HZ


def least_seconds(widths, config: dict, sm_count: int) -> float:
    """The least time the card could take for the blind rotations of
    batches of these widths: each batch bound by its instructions or by
    reading the key once, whichever is longer."""
    work = config["work"]
    steps = config["params"]["lwe_dimension"]
    per_item = steps * item_step_instructions(work) / int32_peak(sm_count)
    key = steps * work["key_bytes_per_step"] / MEMORY_RATE
    return sum(max(w * per_item, key) for w in widths)
