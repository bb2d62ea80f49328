"""The step-wise route's kernels by batch on the card: K3 (``ext_product``)
in every body, K4 (``ntt_ext``) in its three bodies and K5
(``rotate_diff_decompose``) at N = 2048, one step each.

For each batch B: K3's device time in each body (groups, chunk, split) that
fits, fastest first, beside the body ``pick_body`` takes; K4's device time
in each body (1 block an item, clusters of 2 and 4) beside the body
``pick_cluster`` takes; K5's device time; a step of the K3 route (K5 then
K3); and K3's and K5's eager wall time a launch (what the host needs to
start one).
Device times are of 20 launches captured into a CUDA graph.  Every K3 body
is held bit-identical to the picked one, every K4 body to K3.  The last
line gives the B at which K3 and K4 cross.  Usage:

    python3 -m fhestring_tpu_torch.tools.stepwise_sweep [B ...]
"""

from __future__ import annotations

import sys

import torch

from ..crypto import keys
from ..crypto.kernels import cuda_build
from ..crypto.kernels import ext_product as ep
from ..crypto.kernels import ntt_ext as ne
from ..crypto.kernels import rotate_decompose as rd
from . import card, graph_ms, wall_ms

N = 2048
BATCHES = (1, 5, 8, 15, 16, 31, 33, 48, 66, 99, 132, 256, 512, 2048)
CHUNKS = (128, 256, 512, 1024, 2048)


def bodies(batch: int):
    """The bodies worth timing at that batch: every groups whose blocks are
    not mostly padding, every chunk, every split (few splits at large
    batches, where the grid is full without them)."""
    for groups in ep.GROUPS:
        if groups > 1 and batch <= ep.ITEMS * groups // 2:
            continue
        for chunk in CHUNKS:
            if ep.shared_memory(groups, chunk) > ep.SHARED_MEMORY:
                continue
            split = 1
            while split <= 2 * N // chunk:
                if batch < 256 or split <= 2:
                    yield groups, chunk, split
                split *= 2


def main() -> None:
    print(card())
    dev = torch.device("cuda")
    sms = cuda_build.sm_count(0)
    gen = torch.Generator().manual_seed(0)
    bsk = torch.randint(-2**63, 2**63 - 1, (1, 2, 2, N), dtype=torch.int64,
                        generator=gen)
    limbs = keys.pack_bsk_limbs(bsk, dev)[0]
    khat = keys.pack_bsk_hats(bsk, dev, keys.KEY_PLANES64)[0]
    crossing = None
    for b in [int(a) for a in sys.argv[1:]] or BATCHES:
        acc = torch.randint(-2**63, 2**63 - 1, (b, 2, N), dtype=torch.int64,
                            generator=gen).to(dev)
        amt = torch.randint(0, 2 * N, (b,), dtype=torch.int32,
                            generator=gen).to(dev)
        dl = rd.rotate_diff_decompose(acc, amt)
        out = torch.zeros_like(acc)
        want = ep.ext_product(dl, limbs)
        launches, repeat = (20, 5) if b < 256 else (4, 2)

        def k3(body=None):
            return ep.ext_product(dl, limbs, out=out, accumulate=True,
                                  body=body)

        times = []
        for body in bodies(b):
            if not torch.equal(ep.ext_product(dl, limbs, body=body), want):
                raise SystemExit(f"K3 body {body} differs at B={b}")
            times.append((graph_ms(lambda: k3(body), launches, repeat), body))
        times.sort()
        pick = ep.pick_body(b, N, sms)
        pick_ms = graph_ms(k3, launches, repeat)
        k4_body = {}
        for c in ne.CLUSTERS:
            if not torch.equal(ne.ntt_ext(dl, khat, cluster=c), want):
                raise SystemExit(f"K4 body <{c}> differs from K3 at B={b}")
            k4_body[c] = graph_ms(lambda: ne.ntt_ext(
                dl, khat, out=out, accumulate=True, cluster=c), launches,
                repeat)
        k4_pick = ne.pick_cluster(b, N, 0)
        k4_ms = k4_body[k4_pick]
        k5_ms = graph_ms(lambda: rd.rotate_diff_decompose(acc, amt, out=dl),
                         launches, repeat)

        def two_kernels():
            rd.rotate_diff_decompose(acc, amt, out=dl)
            ep.ext_product(dl, limbs, out=out, accumulate=True)

        step_ms = graph_ms(two_kernels, launches, repeat)
        if crossing is None and k4_ms < pick_ms:
            crossing = b
        print(f"B={b}: K3 picked {pick} {pick_ms * 1e3:.2f} us "
              f"(eager wall {wall_ms(k3) * 1e3:.1f} us a launch); K4 picked "
              f"<{k4_pick}> {k4_ms * 1e3:.2f} us, by body "
              + " ".join(f"<{c}>:{ms * 1e3:.1f}" for c, ms in k4_body.items())
              + f"; a step of the K3 route (K5 then K3) {step_ms * 1e3:.2f} us"
              + f"; K5 {k5_ms * 1e3:.2f} us (eager wall "
              f"{wall_ms(lambda: rd.rotate_diff_decompose(acc, amt, out=dl)) * 1e3:.1f}"
              f" us); K3 bodies, us: "
              + " ".join(f"{body}:{ms * 1e3:.1f}" for ms, body in times[:6])
              + f" ... slowest {times[-1][1]}:{times[-1][0] * 1e3:.1f}")
    print("K4 first faster than K3 at B=" + str(crossing))


if __name__ == "__main__":
    main()
