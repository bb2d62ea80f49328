"""The control of the correctness check, and the faults it must catch.

The control serves the cell with its bootstrap key at the nearest torus
precision below the configuration's: each key value rounded to a multiple
of 2**(64 - key_torus_bits) (``configs/<name>.json`` ``control``: 32 bits
for the 64-bit set, 16 for the 32-bit one), as a key stored at that
precision would be.  The program runs as it is.  Its results have to come
out not correct: that is what shows the comparison tight enough.

    python3 -m fhebench.control --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

runs the control on each seed in one process, on the card, and prints one
JSON line a seed with the numbers compared and ``correct``.  The
benchmark's own runs never run it.

The faults (``FAULTS``) break the timed path underneath a run, for the
tests: a blind rotation that returns its state unchanged, half of each
PBS batch left out, and one answer altered where a bootstrap produces it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def lower_precision_key(bsk, config: dict) -> None:
    """Round every bootstrap-key value to the control's torus precision."""
    drop = 64 - config["control"]["key_torus_bits"]
    bsk.copy_(((bsk + (1 << (drop - 1))) >> drop) << drop)


@contextlib.contextmanager
def unchanged_state():
    """Each blind rotation returns its accumulator as it got it."""
    from fhestring_tpu_torch.crypto import pbs

    real = pbs.blind_rotate
    pbs.blind_rotate = lambda acc, *args, **kw: acc
    try:
        yield
    finally:
        pbs.blind_rotate = real


@contextlib.contextmanager
def half_batch():
    """Each PBS batch bootstraps its first half; the second half of its
    items is left out (its outputs stay zero)."""
    from fhestring_tpu_torch import shortint

    real = shortint.ShortintContext._pbs_padded

    def half(self, flat, idx, bank):
        out = real(self, flat, idx, bank)
        out[flat.shape[0] // 2:] = 0
        return out
    shortint.ShortintContext._pbs_padded = half
    try:
        yield
    finally:
        shortint.ShortintContext._pbs_padded = real


@contextlib.contextmanager
def altered_answer():
    """The first output of each PBS batch moved by one slot."""
    from fhestring_tpu_torch import shortint

    real = shortint.pbs_batch

    def altered(flat, idx, bank, keys, **route):
        out = real(flat, idx, bank, keys, **route)
        out[0, -1] += keys.params.delta
        return out
    shortint.pbs_batch = altered
    try:
        yield
    finally:
        shortint.pbs_batch = real


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import time

    import torch

    from . import run

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    for seed in args.seeds:
        out = run.run_cell(bench, args.workload, seed, args.seconds, False,
                           key_hook=lower_precision_key,
                           t_start=time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "key_torus_bits",
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
