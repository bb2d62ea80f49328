#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fhestring_tpu_torch) on one GPU.

Drives the port's served path on the card at two full-width parameter
sets, each phase printing one line:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build of both blind-rotation kernels from csrc/ (one nvcc each, in
   parallel), with the time and what ptxas reports.

The turbo set PARAM_MESSAGE_2_CARRY_2_KS_PBS_32 (n=742, N=2048, k=1,
gadget 2^8 x 3; kernel blind_rotate32):

3. turbo keygen (native C++) and key packing onto the card;
4. kernel against its plain PyTorch version at B=8 on the turbo key,
   bit-exact, both timed;
5. pbs_batch of B=256 messages through a known LUT: every output decrypts
   to table[m];
6. requests "hello world" x "ello" through contains, contains_clear,
   to_upper, len, eq and find: ClientKey -> ServerKey -> decrypt equals
   Python's str, PBS counts equal benchmarks/methods_turbo_r5c.jsonl, and
   the kernel's launches (reset just before this phase) equal the PBS
   batches;
7. throughput: PBS/s of pbs_batch at B=2048, and kernel against plain
   version at the largest B whose plain run is predicted to take at most
   PLAIN_SECONDS.

The 64-bit set PARAM_PROD (n=742, N=2048, k=1, gadget 2^23 x 1, ks 2^3 x
5; kernel blind_rotate64, which the served path runs rounded + approx):

8. keygen (native C++) and key packing onto the card;
9. kernel against its plain version at B=8 on the prod key, bit-exact in
   the production mode (rounded + approx) and in the exact mode, timed;
10. pbs_batch of B=256 in the production mode: every output decrypts to
    table[m];
11. the same six requests: outputs equal Python's str, PBS (items,
    batches) equal PROD_COUNTS, and blind_rotate64's launches (reset just
    before this phase) equal the PBS batches;
12. throughput as in phase 7, in the production mode.

Then one JSON line describing both kernels, and last the line
``{"ok": true, "device": {...}}``.  Any failed phase raises and exits
non-zero.  Usage (from the repository root):

    python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
S, PAT = "hello world", "ello"
PLAIN_SECONDS = 60.0  # allowance for a plain version's throughput run
# (PBS items, PBS batches) of each request at PARAM_PROD.  They depend only
# on the string lengths and the set's noise budget (PROD_NOISE_BUDGET), so
# tests/test_torch_slice.py holds this table equal to the JAX engine's
# counts at PARAM_TEST_ZERO_NOISE, which has the same budget.
PROD_NOISE_BUDGET = 34.0
PROD_COUNTS = {"Contains": (194, 5), "ContainsClear": (194, 5),
               "ToUpper": (36, 3), "Len": (38, 5), "Eq": (131, 25),
               "Find": (239, 13)}
TABLE = [(7 * x + 3) % 16 for x in range(16)]


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, repeat: int = 1):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(repeat):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat, out


def max_abs_err(got, want) -> int:
    """Largest |difference| of two int tensors (0 when bit-identical)."""
    return int((got.long() - want.long()).abs().max())


def make_keys(P, dev, phase):
    """Native keygen and packing onto the card; prints the phase line."""
    import torch

    from fhestring_tpu_torch.client import ClientKey

    t0 = time.perf_counter()
    client = ClientKey(P, seed=0, device=dev)
    t_keygen = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = client.get_server_key()
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    dkeys = server.backend.sc.keys
    bsk = dkeys.bsk_ntt32 if P.torus_bits == 32 else dkeys.bsk_ntt64
    mib = (bsk.numel() * 2 + dkeys.ksk_limbs.numel()) / 2**20
    print(f"phase {phase} keys: {P.name} n={P.lwe_dimension} "
          f"N={P.polynomial_size} keygen {t_keygen:.2f} s, packing on the "
          f"card {t_pack:.2f} s, {mib:.0f} MiB on the card (bsk "
          f"{tuple(bsk.shape)}, ksk {tuple(dkeys.ksk_limbs.shape)})")
    return client, server, dkeys


def encrypt_msgs(client, count, seed):
    import numpy as np

    from fhestring_tpu_torch import torus
    from fhestring_tpu_torch.numpy_ref import core as ref

    msgs = np.random.default_rng(seed).integers(0, 16, size=count)
    cts = np.stack([ref.shortint_encrypt(client.secret, int(m), client._rng)
                    for m in msgs])
    return msgs, torus.from_numpy(cts, client.device)


def pbs_known_lut(client, dkeys, phase, **mode):
    """pbs_batch of 256 messages through TABLE; all must decrypt right."""
    import torch

    from fhestring_tpu_torch import torus
    from fhestring_tpu_torch.crypto import keys, pbs
    from fhestring_tpu_torch.numpy_ref import core as ref

    bank = keys.pack_luts([TABLE], dkeys.params, client.device)
    msgs, cts = encrypt_msgs(client, 256, 5)
    zeros = torch.zeros(len(msgs), dtype=torch.int64, device=client.device)
    ms, out = cuda_ms(lambda: pbs.pbs_batch(cts, zeros, bank, dkeys, **mode))
    out = torus.to_numpy(out)
    bad = sum(ref.shortint_decrypt(client.secret, out[i]) != TABLE[m]
              for i, m in enumerate(msgs))
    if bad:
        fail(f"pbs_batch: {bad} of {len(msgs)} outputs decrypt wrong")
    print(f"phase {phase} pbs_batch: B={len(msgs)} {dict(mode) or 'exact'} "
          f"all decrypt to table[m]; {ms:.1f} ms "
          f"({len(msgs) / ms * 1e3:.0f} PBS/s)")
    return bank


def requests(client, server, counter, table_counts, phase):
    """The six requests through the served path; returns the kernel's
    launches counted over them (the counter is set to 0 just before)."""
    import torch

    from fhestring_tpu_torch import metrics

    calls = {
        "Contains": (lambda s, p, pp: server.contains(s, p), int(PAT in S)),
        "ContainsClear": (lambda s, p, pp: server.contains_clear(s, PAT),
                          int(PAT in S)),
        "ToUpper": (lambda s, p, pp: server.to_upper(s), S.upper()),
        "Len": (lambda s, p, pp: server.len(s), len(S)),
        "Eq": (lambda s, p, pp: server.eq(s, pp), int(S == PAT)),
        "Find": (lambda s, p, pp: server.find(s, p), S.find(PAT) % 256),
    }
    inputs = (client.encrypt(S, 1), client.encrypt_no_padding(PAT),
              client.encrypt(PAT, 1))
    torch.cuda.synchronize()
    counter.launches = 0
    rows = []
    for method, (call, expected) in calls.items():
        metrics.reset()
        t0 = time.perf_counter()
        out = call(*inputs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = (client.decrypt(out) if isinstance(expected, str)
               else client.decrypt_char(out))
        counts = (metrics.GLOBAL.pbs_items, metrics.GLOBAL.pbs_calls)
        if got != expected:
            fail(f"{method}: got {got!r}, Python str gives {expected!r}")
        if counts != table_counts[method]:
            fail(f"{method}: PBS (items, batches) {counts}, table "
                 f"{table_counts[method]}")
        rows.append((method, got, counts, dt))
    launches = counter.launches
    batches = sum(r[2][1] for r in rows)
    if launches != batches or launches == 0:
        fail(f"kernel launches {launches}, PBS batches {batches}")
    print(f"phase {phase} requests: " + "; ".join(
        f"{m}={g!r} pbs={c[0]} batches={c[1]} {dt * 1e3:.0f} ms"
        for m, g, c, dt in rows) + f"; kernel launches {launches}")
    return launches


def throughput(client, dkeys, bank, kernel, plain, make_acc, khat, phase,
               **mode):
    """PBS/s of pbs_batch at B=2048 with a decrypt spot check, and the
    kernel against its plain version at the largest B whose plain run is
    predicted (from 8 steps) to fit PLAIN_SECONDS."""
    import torch

    from fhestring_tpu_torch import torus
    from fhestring_tpu_torch.crypto import pbs
    from fhestring_tpu_torch.numpy_ref import core as ref

    dev = client.device
    msgs, cts = encrypt_msgs(client, 2048, 7)
    zeros = torch.zeros(len(msgs), dtype=torch.int64, device=dev)
    pbs.pbs_batch(cts, zeros, bank, dkeys, **mode)  # warm-up
    ms, out = cuda_ms(lambda: pbs.pbs_batch(cts, zeros, bank, dkeys, **mode),
                      repeat=2)
    out = torus.to_numpy(out)
    if any(ref.shortint_decrypt(client.secret, out[i]) != TABLE[msgs[i]]
           for i in range(0, len(msgs), 64)):
        fail("pbs_batch at B=2048 decrypts wrong")
    gen = torch.Generator().manual_seed(phase)
    N, n = dkeys.params.polynomial_size, dkeys.params.lwe_dimension
    plain_b = None
    for b in (64, 256, 1024, 2048):
        a = make_acc(gen, b).to(dev)
        s = torch.randint(0, 2 * N, (b, n), dtype=torch.int32,
                          generator=gen).to(dev)
        t8, _ = cuda_ms(lambda: plain(a, s[:, :8].contiguous(),
                                      khat[:8].contiguous(), **mode))
        if t8 / 8 * n / 1e3 > PLAIN_SECONDS and plain_b is not None:
            break
        plain_b, pa, ps = b, a, s
    t_plain, want = cuda_ms(lambda: plain(pa, ps, khat, **mode))
    t_kern, got = cuda_ms(lambda: kernel(pa, ps, khat, **mode))
    if not torch.equal(got, want):
        fail(f"kernel differs from plain version at B={plain_b}")
    plain_rate, kern_rate = plain_b / t_plain * 1e3, plain_b / t_kern * 1e3
    print(f"phase {phase} throughput: pbs_batch B={len(msgs)} {ms:.1f} ms = "
          f"{len(msgs) / ms * 1e3:.1f} PBS/s; blind rotation at B={plain_b}: "
          f"kernel {t_kern:.1f} ms = {kern_rate:.1f}/s, plain "
          f"{t_plain:.1f} ms = {plain_rate:.1f}/s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "fhestring_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from fhestring_tpu_torch import PARAM_PROD, PARAM_TURBO
    from fhestring_tpu_torch.crypto.kernels import blind_rotate32 as br
    from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br64
    from fhestring_tpu_torch.crypto.kernels import cuda_build

    dev = torch.device("cuda")

    # 1. device ---------------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"phase 1 device: {name} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi.splitlines()[0])

    # 2. kernel builds, in parallel -------------------------------------------
    t0 = time.perf_counter()
    paths = cuda_build.build("blind_rotate32", "blind_rotate64")
    t_build = time.perf_counter() - t0
    br.build()
    br64.build()
    ptxas = {k: " | ".join(ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln)
             for k, log in cuda_build.LOGS.items()}
    print(f"phase 2 build: {', '.join(map(os.path.basename, paths))} in "
          f"{t_build:.2f} s; " + "; ".join(f"{k}: {v}"
                                           for k, v in ptxas.items()))

    # -- turbo: PARAM_MESSAGE_2_CARRY_2_KS_PBS_32, kernel blind_rotate32 ------
    P = PARAM_TURBO
    client, server, dkeys = make_keys(P, dev, 3)

    # 4. kernel against plain version
    gen = torch.Generator().manual_seed(4)
    B4, N, n = 8, P.polynomial_size, P.lwe_dimension
    acc = torch.randint(-2**31, 2**31, (B4, 2, N), dtype=torch.int32,
                        generator=gen).to(dev)
    amt = torch.randint(0, 2 * N, (B4, n), dtype=torch.int32,
                        generator=gen).to(dev)
    khat = dkeys.bsk_ntt32
    br.blind_rotate32(acc, amt, khat)  # warm-up
    ms32, got = cuda_ms(lambda: br.blind_rotate32(acc, amt, khat), repeat=3)
    plain_ms32, want = cuda_ms(lambda: br.blind_rotate32_plain(acc, amt, khat))
    err32 = max_abs_err(got.long() & 0xFFFFFFFF, want.long() & 0xFFFFFFFF)
    if err32:
        fail(f"kernel differs from plain version: max |diff| {err32}")
    print(f"phase 4 kernel vs plain: B={B4} n={n} N={N} bit-exact; kernel "
          f"{ms32:.3f} ms, plain {plain_ms32:.1f} ms "
          f"({plain_ms32 / ms32:.1f}x)")

    bank = pbs_known_lut(client, dkeys, 5)
    with open(os.path.join(ROOT, "benchmarks", "methods_turbo_r5c.jsonl")) as f:
        turbo_counts = {r["method"]: (r["pbs"], r["pbs_batches"])
                        for r in map(json.loads, f)}
    launches32 = requests(client, server, br.blind_rotate32, turbo_counts, 6)
    throughput(client, dkeys, bank, br.blind_rotate32,
               br.blind_rotate32_plain,
               lambda g, b: torch.randint(-2**31, 2**31, (b, 2, N),
                                          dtype=torch.int32, generator=g),
               khat, 7)
    del client, server, dkeys, khat, bank
    torch.cuda.empty_cache()

    # -- PARAM_PROD: the 64-bit set, kernel blind_rotate64 --------------------
    P = PARAM_PROD
    prod = dict(rounded=True, approx=True)  # the served path's mode on the card
    client, server, dkeys = make_keys(P, dev, 8)

    # 9. kernel against plain version, production and exact modes
    gen = torch.Generator().manual_seed(9)
    N, n = P.polynomial_size, P.lwe_dimension
    acc = torch.randint(-2**63, 2**63 - 1, (B4, 2, N), dtype=torch.int64,
                        generator=gen).to(dev)
    amt = torch.randint(0, 2 * N, (B4, n), dtype=torch.int32,
                        generator=gen).to(dev)
    khat = dkeys.bsk_ntt64
    line = []
    for label, mode in (("production", prod), ("exact", {})):
        br64.blind_rotate64(acc, amt, khat, **mode)  # warm-up
        ms, got = cuda_ms(lambda: br64.blind_rotate64(acc, amt, khat, **mode),
                          repeat=3)
        plain_ms, want = cuda_ms(
            lambda: br64.blind_rotate64_plain(acc, amt, khat, **mode))
        err = max_abs_err(got, want)
        if err:
            fail(f"blind_rotate64 ({label}) differs from plain version: "
                 f"max |diff| {err}")
        line.append(f"{label} kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
                    f"({plain_ms / ms:.1f}x)")
        if label == "production":
            ms64, plain_ms64, err64 = ms, plain_ms, err
    print(f"phase 9 kernel vs plain: B={B4} n={n} N={N} bit-exact in both "
          f"modes; " + "; ".join(line))

    bank = pbs_known_lut(client, dkeys, 10, **prod)
    launches64 = requests(client, server, br64.blind_rotate64, PROD_COUNTS,
                          11)
    throughput(client, dkeys, bank, br64.blind_rotate64,
               br64.blind_rotate64_plain,
               lambda g, b: torch.randint(-2**63, 2**63 - 1, (b, 2, N),
                                          dtype=torch.int64, generator=g),
               khat, 12, **prod)

    print(json.dumps({"kernels": [
        {"name": "blind_rotate32", "route": "cuda",
         "source": "fhestring_tpu_torch/csrc/blind_rotate32.cu",
         "replaces": "fhestring_tpu/crypto/kernels/blind_rotate_fused32.py:399",
         "launches": launches32, "max_abs_err": err32,
         "ms": round(ms32, 4), "plain_ms": round(plain_ms32, 4)},
        {"name": "blind_rotate64", "route": "cuda",
         "source": "fhestring_tpu_torch/csrc/blind_rotate64.cu",
         "replaces": "fhestring_tpu/crypto/kernels/blind_rotate_fused.py:348",
         "launches": launches64, "max_abs_err": err64,
         "ms": round(ms64, 4), "plain_ms": round(plain_ms64, 4)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
