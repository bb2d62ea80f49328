"""How many blocks one batch item's blind rotation is spread over.

The whole-rotation kernels (``blind_rotate32``, ``blind_rotate64``) have
four bodies: 1 block per item (an item's step runs on one SM), and a
thread-block cluster of 2, 4 or 8 blocks per item
(``csrc/rotate_cluster.cuh``: split by prime, by prime and output row, or by
prime, output row and half of the row's product planes, the parts exchanged
through distributed shared memory).  K4 (``ntt_ext``) shares the cluster
code and has the bodies of 1, 2 and 4.  A kernel's bodies are the one-block
body and the keys of its ``WaveCost.cluster`` (``bodies``).  The bodies give
the same bits.  A cluster shortens an item's step while it has blocks to
spare for it, so it pays while the batch leaves SMs idle; at a batch that
fills the card the bodies do the same work and the one-block body has no
exchange to pay for.

The pick is a model of waves: the blocks of one launch run their steps side
by side, so a body takes as many times its own one-wave time as the batch
needs waves of it, ``ceil(batch / clusters that run at once)``.  Each
wrapper gives the one-wave times it measured on an H100, relative to the
one-block body's (``WaveCost``).
"""

from __future__ import annotations

from typing import NamedTuple

# A cluster body is picked only where the model gives it 5% over the
# one-block body: on an H100 the model errs by up to 3% (PERF.md).
MARGIN = 0.95


class WaveCost(NamedTuple):
    """A kernel's time for one wave of each body, relative to the one-block
    body's first wave.  ``one_block``: the one-block body at a batch of up
    to 1, 2, ... times the SM count (a kernel that fits two blocks on an SM
    runs its second ``sms`` items in less than twice the time); beyond that
    table the batch is large and the pick is 1.  ``cluster``: {blocks per
    item: time of one wave}, one entry for each cluster body the kernel
    has."""
    one_block: tuple
    cluster: dict


def bodies(cost: WaveCost) -> tuple:
    """Blocks per item of each body of a kernel with these wave costs: the
    one-block body and its cluster bodies, in increasing order."""
    return (1, *sorted(cost.cluster))


def cluster_size(batch: int, sms: int, n: int, cost: WaveCost,
                 occupancy=None) -> int:
    """Blocks per item for a batch on a card of ``sms`` SMs at polynomial
    size n: the body whose waves take the least time by ``cost``; the
    one-block body unless a cluster wins by ``MARGIN``, and for any batch
    beyond ``cost.one_block``.

    occupancy(c, n): how many clusters of c blocks the card runs at once at
    this n.  A cluster's blocks are co-scheduled inside one GPC and the GPCs
    of a card differ in size, so the wrappers ask the card
    (``cudaOccupancyMaxActiveClusters``); the default, for a card that is
    not there, is ``sms // c``.  A body with no room is never picked.
    Every body takes every n the wrappers accept."""
    if batch < 0 or sms < 1 or n < 1:
        raise ValueError("batch, sms and n must be positive")
    waves = -(-batch // sms)
    if not 1 <= waves <= len(cost.one_block):
        return 1
    best, best_time = 1, MARGIN * cost.one_block[waves - 1]
    for c in bodies(cost)[1:]:
        room = occupancy(c, n) if occupancy is not None else sms // c
        if room < 1:
            continue
        time = -(-batch // room) * cost.cluster[c]
        if time < best_time:
            best, best_time = c, time
    return best


def check_cluster(cluster, cost: WaveCost) -> None:
    """Raise unless ``cluster`` is None (pick) or one of the bodies of a
    kernel with these wave costs."""
    if cluster is not None and (isinstance(cluster, bool)
                                or cluster not in bodies(cost)):
        raise ValueError(
            f"cluster must be one of {bodies(cost)}, not {cluster!r}")
