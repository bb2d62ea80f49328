"""Times of every body of the whole-rotation kernels by batch size.

For K1 (``blind_rotate32``) and K2 (``blind_rotate64``, production and
exact mode) at N=2048 and n=742 steps on a key of random residues (a
kernel's time does not depend on the key's values): the build's ptxas
report, how many clusters of each body the card runs at once, every body
held bit-exact against the plain version at a few steps, and then ms per
body at each batch size.  Usage:

    python3 -m fhestring_tpu_torch.tools.rotation_sweep [B ...]
"""

from __future__ import annotations

import sys

import torch

from ..crypto.kernels import blind_rotate32 as br
from ..crypto.kernels import blind_rotate64 as br64
from ..crypto.kernels import cuda_build
from . import card, cuda_ms, random_khat

N, STEPS = 2048, 742
BATCHES = (1, 2, 3, 5, 8, 14, 15, 16, 17, 30, 31, 33, 66, 67, 90, 91, 132,
           133, 150, 151, 198, 199, 264, 2048)
# batches that also time K2's exact mode
EXACT_AT = (2, 3, 8, 14, 16, 33, 132, 2048)
PROD = dict(rounded=True, approx=True)


def ptxas_report() -> None:
    for name, log in cuda_build.LOGS.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and "registers" in line:
                body = ("<8>" if "Li8E" in entry else
                        "<4>" if "Li4E" in entry else
                        "<2>" if "Li2E" in entry else "<1>")
                print(f"ptxas {name} {body} {entry[-28:]}: "
                      f"{line.split(':', 1)[1].strip()}")
            elif "spill" in line and "0 bytes spill stores, 0 bytes spill "\
                    "loads" not in line:
                print(f"ptxas {name} SPILLS: {line.strip()}")


def check_bit_exact(dev) -> None:
    gen = torch.Generator().manual_seed(0)
    for n, steps, b in ((2048, 4, 8), (256, 5, 5), (64, 6, 3)):
        amt = torch.randint(0, 2 * n, (b, steps), dtype=torch.int32,
                            generator=gen)
        amt[0, :3] = torch.tensor([0, n, 2 * n - 1], dtype=torch.int32)
        amt = amt.to(dev)
        acc = torch.randint(-2**31, 2**31, (b, 2, n), dtype=torch.int32,
                            generator=gen).to(dev)
        kh = random_khat(gen, steps, 6, 8, n).to(dev)
        want = br.blind_rotate32_plain(acc, amt, kh)
        for c in br.CLUSTERS:
            assert torch.equal(br.blind_rotate32(acc, amt, kh, cluster=c),
                               want), ("K1", n, c)
        acc = torch.randint(-2**63, 2**63 - 1, (b, 2, n), dtype=torch.int64,
                            generator=gen).to(dev)
        kh = random_khat(gen, steps, 2, 16, n).to(dev)
        for mode in (PROD, {}, dict(rounded=True), dict(approx=True)):
            want = br64.blind_rotate64_plain(acc, amt, kh, **mode)
            for c in br64.CLUSTERS:
                assert torch.equal(
                    br64.blind_rotate64(acc, amt, kh, cluster=c, **mode),
                    want), ("K2", n, c, mode)
    print("every body of K1 and of K2's four modes bit-exact against the "
          "plain version at N=2048, 256 and 64")


def main() -> None:
    batches = tuple(map(int, sys.argv[1:])) or BATCHES
    print(card())
    cuda_build.build("blind_rotate32", "blind_rotate64")
    ptxas_report()
    dev = torch.device("cuda")
    for c in br.CLUSTERS[1:]:
        print(f"clusters of {c} that run at once at N={N}: K1 "
              f"{br.max_active_clusters(0, c, N)}, K2 production "
              f"{br64.max_active_clusters(0, c, N, True, True)}, K2 exact "
              f"{br64.max_active_clusters(0, c, N, False, False)}")
    check_bit_exact(dev)
    gen = torch.Generator().manual_seed(1)
    kh32 = random_khat(gen, STEPS, 6, 8, N).to(dev)
    kh64 = random_khat(gen, STEPS, 2, 16, N).to(dev)
    print(f"ms per body, N={N}, n={STEPS}; picks: K1 / K2 production")
    for b in batches:
        acc32 = torch.randint(-2**31, 2**31, (b, 2, N), dtype=torch.int32,
                              generator=gen).to(dev)
        acc64 = torch.randint(-2**63, 2**63 - 1, (b, 2, N),
                              dtype=torch.int64, generator=gen).to(dev)
        amt = torch.randint(0, 2 * N, (b, STEPS), dtype=torch.int32,
                            generator=gen).to(dev)
        repeat = 1 if b > 300 else 2
        row = [f"B={b}"]
        for c in br.CLUSTERS:
            row.append(f"K1<{c}> " + format(cuda_ms(
                lambda: br.blind_rotate32(acc32, amt, kh32, cluster=c),
                repeat), ".2f"))
        for c in br64.CLUSTERS:
            row.append(f"K2p<{c}> " + format(cuda_ms(
                lambda: br64.blind_rotate64(acc64, amt, kh64, cluster=c,
                                            **PROD), repeat), ".2f"))
        if b in EXACT_AT:
            for c in br64.CLUSTERS:
                row.append(f"K2x<{c}> " + format(cuda_ms(
                    lambda: br64.blind_rotate64(acc64, amt, kh64, cluster=c),
                    repeat), ".2f"))
        row.append(f"picks <{br.pick_cluster(b, N, 0)}> / "
                   f"<{br64.pick_cluster(b, N, 0, **PROD)}>")
        print(" ".join(row), flush=True)


if __name__ == "__main__":
    main()
