"""Where a request's time goes on the card: a ``torch.profiler`` trace of
six requests ("hello world" x "ello") through the default server of the
turbo set and of PARAM_PROD, and through a PARAM_PROD server packed with
``with_ntt2=False`` (the step-wise route: K5 and K3 replayed from a CUDA
graph per PBS batch).

For each request: wall time, the share of it the card was busy (the sum of
its kernels' device time; the served path uses one stream), and the device
time by kernel, largest first.  Usage:

    python3 -m fhestring_tpu_torch.tools.profile_requests
"""

from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import PARAM_PROD, PARAM_TURBO, metrics
from ..client import ClientKey
from ..crypto.kernels import blind_rotate32 as br
from ..crypto.kernels import blind_rotate64 as br64
from ..crypto.kernels import ext_product as ep
from ..crypto.kernels import rotate_decompose as rd
from . import card

S, PAT = "hello world", "ello"


def device_us(event) -> float:
    """Device time of a kernel's row of ``key_averages()``; 0 for the rows
    of host operators, which repeat their kernels' time."""
    if event.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main() -> None:
    print(card())
    for params, with_ntt2, kernel in ((PARAM_TURBO, True, br.blind_rotate32),
                                      (PARAM_PROD, True, br64.blind_rotate64),
                                      (PARAM_PROD, False, None)):
        client = ClientKey(params, seed=0, device=torch.device("cuda"))
        server = client.get_server_key(with_ntt2=with_ntt2)
        label = params.name + ("" if with_ntt2 else " with_ntt2=False")
        s, p, pp = (client.encrypt(S, 1), client.encrypt_no_padding(PAT),
                    client.encrypt(PAT, 1))
        calls = {"Contains": lambda: server.contains(s, p),
                 "ContainsClear": lambda: server.contains_clear(s, PAT),
                 "ToUpper": lambda: server.to_upper(s),
                 "Len": lambda: server.len(s),
                 "Eq": lambda: server.eq(s, pp),
                 "Find": lambda: server.find(s, p)}
        calls["Len"]()  # builds the kernels, warms the allocator
        if kernel is None:  # capture every batch's step graph first
            for call in calls.values():
                call()
        torch.cuda.synchronize()
        for method, call in calls.items():
            metrics.reset()
            if kernel is None:
                rd.rotate_diff_decompose.launches = ep.ext_product.launches = 0
            else:
                kernel.bodies = dict.fromkeys(kernel.bodies, 0)
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            plain_wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            rows = sorted(((device_us(e) / 1e3, e.key, e.count)
                           for e in prof.key_averages()
                           if device_us(e) > 0), reverse=True)
            busy = sum(r[0] for r in rows)
            if kernel is None:
                ran = (f"launches K5 {rd.rotate_diff_decompose.launches // 2}"
                       f", K3 {ep.ext_product.launches // 2}")
            else:
                ran = f"bodies { {c: k // 2 for c, k in kernel.bodies.items()} }"
            print(f"{label} {method}: wall {plain_wall:.1f} ms "
                  f"({wall:.1f} ms under the profiler), device busy "
                  f"{busy:.1f} ms ({100 * busy / wall:.1f}% of the profiled "
                  f"wall), PBS {metrics.GLOBAL.pbs_items // 2} in "
                  f"{metrics.GLOBAL.pbs_calls // 2} batches, {ran}")
            for ms, key, count in rows[:5]:
                print(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{count:<6d}"
                      f" {key[:80]}")
        del client, server, s, p, pp, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
