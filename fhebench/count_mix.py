"""What a traffic mix asks of the PBS layer, counted on the CPU: PBS and
batches a request, and the widths of the batches, with every bootstrap
replaced by the identity (the engine never branches on ciphertext values,
so its batches are a real run's; the outputs do not decrypt).

    python3 -m fhebench.count_mix --config prod64 --traffic interactive \\
        [--seed 0] [--decks 1]

The configuration fixes the noise budget, which sets how often the engine
refreshes, so the counts are a configuration's under a mix.  Nothing runs
on the card and no key is made.
"""

from __future__ import annotations

import argparse
import collections
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
EDGES = (1, 8, 16, 33, 67, 133, 265, 529, 1057, 2113, 4097, 8193)


def count(config: dict, mix: dict, seed: int, decks: int) -> dict:
    import torch

    from fhestring_tpu_torch import metrics, shortint
    from fhestring_tpu_torch.ciphertext import FheString
    from fhestring_tpu_torch.crypto import pbs
    from fhestring_tpu_torch.crypto.keys import DeviceServerKeys
    from fhestring_tpu_torch.params import CryptoParams
    from fhestring_tpu_torch.server import ServerKey
    from fhestring_tpu_torch.shortint import Blocks

    from . import methods, traffic

    params = CryptoParams(**config["params"])
    empty = torch.zeros(0, dtype=torch.int16)
    keys = DeviceServerKeys(params, torch.zeros((1, 8), dtype=torch.int8),
                            bsk_ntt32=empty, bsk_ntt64=empty)
    key = ServerKey(keys, params)
    width = params.big_lwe_dimension + 1
    pad = b"\0" * mix["padding"]

    def fhe(length: int) -> FheString:
        return FheString(Blocks(torch.zeros((length, 4, width),
                                            dtype=torch.int64), 3, 1.0))

    widths = []  # logical widths: the CPU pads a batch, the card does not
    real = shortint.pbs_batch, pbs.pbs_batch, metrics.record_pbs
    shortint.pbs_batch = pbs.pbs_batch = (
        lambda flat, idx, bank, keys, **route: flat)
    metrics.record_pbs = (lambda n, padded:
                          widths.append(int(n)) or real[2](n, padded))
    mix = dict(mix, decks=decks)
    rows = collections.defaultdict(list)
    try:
        for r in traffic.make(mix, seed):
            kind = methods.load(r.method)
            args = methods.arguments(kind, r, [fhe(len(x)) for x in
                                               methods.encrypted(kind, r, pad)])
            before = metrics.GLOBAL.snapshot()
            getattr(key, r.method)(*args)
            d = metrics.GLOBAL.delta(before)
            rows[r.method].append((d.pbs_items, d.pbs_calls))
    finally:
        shortint.pbs_batch, pbs.pbs_batch, metrics.record_pbs = real
    requests = sum(len(v) for v in rows.values())
    hist = collections.Counter()
    for w in widths:
        hist[next(e for e in EDGES[1:] if w < e)] += 1
    per_item = collections.Counter()
    for w in widths:
        per_item["<66" if w < 66 else ">=66"] += w
    return {
        "requests": requests,
        "pbs_per_request": sum(a for v in rows.values() for a, _ in v)
        / requests,
        "batches_per_request": len(widths) / requests,
        "by_method": {m: {"pbs": sum(a for a, _ in v) / len(v),
                          "batches": sum(b for _, b in v) / len(v)}
                      for m, v in rows.items()},
        "batch_widths": {f"{lo}-{hi - 1}": hist[hi]
                         for lo, hi in zip(EDGES, EDGES[1:]) if hist[hi]},
        "batches_under_66": sum(w < 66 for w in widths) / len(widths),
        "items_in_batches_under_66": per_item["<66"] / sum(widths),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decks", type=int, default=1)
    args = ap.parse_args(argv)
    from . import traffic

    with open(os.path.join(HERE, "configs", f"{args.config}.json")) as f:
        config = json.load(f)
    mix = traffic.load(traffic.find(HERE, args.traffic))
    print(json.dumps(count(config, mix, args.seed, args.decks), indent=1))


if __name__ == "__main__":
    main()
