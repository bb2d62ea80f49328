#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fhestring_tpu_torch) on one GPU.

Drives the port's served path on the card at two full-width parameter
sets, then the ported CLI, then keys saved and loaded and served over TCP,
each phase printing one line:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build of all five kernels from csrc/ (one nvcc each, in parallel),
   with the time and what ptxas reports.

The turbo set PARAM_MESSAGE_2_CARRY_2_KS_PBS_32 (n=742, N=2048, k=1,
gadget 2^8 x 3; kernel blind_rotate32):

3. turbo keygen (native C++) and key packing onto the card;
4. every body of the kernel (1 block per item, and clusters of 2, 4 and 8
   blocks per item) against one run of its plain PyTorch version at B=8 on
   the turbo key, bit-exact, each timed; then a sweep over the batches of
   ROTATION_SWEEP_B, either side of each switch of the wrapper's pick:
   every body timed and bit-identical to the others, to the plain version
   up to B=33, and the picked body no slower than the one-block body;
5. pbs_batch of B=256 messages through a known LUT: every output decrypts
   to table[m];
6. requests "hello world" x "ello" through contains, contains_clear,
   to_upper, len, eq and find: ClientKey -> ServerKey -> decrypt equals
   Python's str, PBS counts equal TURBO_COUNTS (for these six the rows of
   benchmarks/methods_turbo_r5c.jsonl), and the kernel's launches (reset just before this phase) equal the PBS
   batches; each request's wall time and how many batches ran each body;
7. throughput: PBS/s of pbs_batch at B=2048, and kernel against plain
   version at the largest B whose plain run is predicted to take at most
   PLAIN_SECONDS.

The 64-bit set PARAM_PROD (n=742, N=2048, k=1, gadget 2^23 x 1, ks 2^3 x
5; kernel blind_rotate64, which the served path runs rounded + approx):

8. keygen (native C++) and key packing onto the card;
9. as phase 4 on the prod key: every body bit-exact at B=8 in the
   production mode (rounded + approx) and in the exact mode, timed, and
   the sweep in the production mode;
10. pbs_batch of B=256 in the production mode: every output decrypts to
    table[m];
11. the same six requests: outputs equal Python's str, PBS (items,
    batches) equal PROD_COUNTS, and blind_rotate64's launches (reset just
    before this phase) equal the PBS batches; wall times and bodies as in
    phase 6;
12. throughput as in phase 7, in the production mode.

The step-wise 64-bit route at PARAM_PROD (one launch of rotate_decompose,
K5, and one of ext_product, K3, or ntt_ext, K4, per LWE step; exact), on
the phase-8 keys and on a server packed with ``with_ntt2=False``:

13. K5, K3 and K4 each against its plain version at B=8 over 4 steps of
    the prod key (step 0 with the amounts 0, N and 2N - 1), bit-exact, K3
    also adding into the accumulator (acc + ext); K4 in each of its bodies
    (1 block an item, clusters of 2 and 4), fresh and accumulating; each
    kernel's device time (20 launches captured into a CUDA graph), K4's
    per body, a step of the K3 route (K5 then K3), and for K5 and K3 the
    eager wall time a launch; then on step 0 at each B of SWEEP_B: K3 in
    the picked body and in every body of K3_SWEEP_BODIES, fresh and
    accumulating, and K4 in its three bodies, against the plain version;
14. a bootstrap of B=256 whose blind rotation is the step loop with K3
    and with K4 (``pbs._blind_rotate_stepwise``): every output decrypts to
    table[m] and both equal pbs_batch with K2 in its exact mode, bit for
    bit; K4's launches are counted over its run; then the step loop's
    graph with each product kernel: two different batches of one B
    through one cached graph, and a second B, each with the bits of the
    eager loop and of K2's exact mode, a replay counting n launches of K5
    and of the product kernel;
15. the six requests through the ``with_ntt2=False`` server (the K3
    route): outputs equal Python's str, PBS counts
    equal PROD_COUNTS, K5 and K3 launch n times per PBS batch and K2 never;
    each request's wall time and the share of it the card spent in the
    replayed step graphs.

The ported CLI (``fhestring_tpu_torch.cli``), which makes its own keys:

17. ``--params turbo --device cuda --metrics`` with the arguments of
    benchmarks/methods.py: all 52 method variants pass against Python's
    str and each row's (PBS, batches) equals TURBO_COUNTS, its PBS also
    the row of benchmarks/methods_turbo_r5c.jsonl;
18. the same at ``--params prod`` against the 52 rows of PROD_COUNTS.

Keys saved and loaded, the TCP service, and the 32-bit limb route (turbo
and PARAM_PROD keys made again from seed 0):

19. persistence at turbo, at PARAM_PROD and at PARAM_PROD packed
    ``with_ntt2=False``: the packed server key saved
    (``serialize.save_packed_server_key``), loaded onto the card into a
    fresh ServerKey with bit-identical keys, Contains through it
    bit-identical to the server it was saved from, and
    ``get_server_key(cache_path=)`` twice, a miss that packs and saves and
    a hit that must not pack; the file's MiB and the seconds of each step;
20. the six requests through a ``FheStringServer`` over the PARAM_PROD
    server loaded in phase 19, from a ``RemoteServerKey`` on 127.0.0.1:
    outputs, PROD_COUNTS and K2's launches as in phase 11 (the server runs
    in this process), each request's wall time beside phase 11's;
21. a turbo server packed ``with_ntt2=False`` (digits in torch ops and one
    K3 per gadget level): K3 at that route's shapes against its plain
    version, then the six requests, TURBO_COUNTS, 3n launches of K3 per
    PBS batch and none of K1 or K5, with their share of time in the step
    graphs.

``parallel.py`` over ``torch.distributed`` ranks on the card, and the
noise margin (PARAM_PROD keys made again from seed 0):

22. K3 on a one-column shard of the key in every body of K3_SWEEP_BODIES,
    bit-identical to that column of the full product, timed against the
    whole key; then over 2 gloo ranks sharing the card (NCCL refuses two
    ranks on one card) and over 1 NCCL rank: the batch-sharded PBS at
    B=SHARD_B at turbo and PARAM_PROD (rounded + approx), the key-sharded
    PBS at B=KEYSHARD_B (exact: K5 + K3 on each rank's column shard of
    the key), the polynomial-sharded forward, inverse and ext_group NTT at
    N=2048, each bit-identical to one process (the step-wise route for
    the key-sharded one) and to the numpy plan, with each rank's launches,
    the ranks loading the keys this process saved with serialize; the MiB
    of key a rank holds; a key-sharded step split into K5 + K3, the
    all_gather and the add, each measured; then the dry run's four stages
    (``fhestring_tpu_torch.dryrun``) at PARAM_PROD on S x PAT over 2 gloo
    ranks (rank 0 packs the keys and saves them with serialize, the other
    loads them): Contains with PROD_COUNTS, all decrypted to Python's
    answers;
23. NOISE_SAMPLES PARAM_PROD bootstraps in the served mode and their 4x +
    y packs bootstrapped again: zero decode failures, sigma and margin.

Phases 19-23 print the card's name and power limit on their lines.

Then one JSON line describing the five kernels, each with its time beside
its bound: the least time the card could take, the larger of its bytes over
the memory rate and its integer instructions over the int32 rate (no single
PyTorch call computes any of them, so ``library_ms`` is null); K3's, K4's
and K5's ``ms`` are device times.  Last the line
``{"ok": true, "device": {...}}``.  Any failed phase raises and exits
non-zero.  Usage (from the repository root):

    python3 chip_smoke.py
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
S, PAT = "hello world", "ello"
PLAIN_SECONDS = 60.0  # allowance for a plain version's throughput run
# (PBS items, PBS batches) of each of the CLI's 52 method variants on S and
# PAT (n = 2, from "o", to "0") at PARAM_PROD.  They depend only on the
# string lengths and the set's noise budget (PROD_NOISE_BUDGET), so
# tests/test_torch_cli_q64.py holds this table equal to the JAX engine's
# counts at PARAM_TEST_ZERO_NOISE, which has the same budget.
PROD_NOISE_BUDGET = 34.0
PROD_COUNTS = {
    "Contains": (194, 5), "ContainsClear": (194, 5), "EndsWith": (365, 15),
    "EndsWithClear": (365, 15), "EqIgnoreCase": (330, 37), "Find": (239, 13),
    "FindClear": (239, 13), "IsEmpty": (41, 5), "Len": (38, 5),
    "Repeat": (24887, 75), "RepeatClear": (1796, 37), "Replace": (810, 23),
    "ReplaceClear": (810, 23), "ReplaceN": (936, 29),
    "ReplaceNClear": (936, 29), "Rfind": (239, 13), "RfindClear": (239, 13),
    "Rsplit": (14954, 223), "RsplitClear": (14954, 223),
    "RsplitOnce": (29441, 400), "RsplitOnceClear": (29441, 400),
    "RsplitN": (29441, 400), "RsplitNClear": (29441, 400),
    "RsplitTerminator": (18061, 240), "RsplitTerminatorClear": (18061, 240),
    "Split": (14954, 223), "SplitClear": (14954, 223),
    "SplitAsciiWhitespace": (8897, 136), "SplitInclusive": (10690, 218),
    "SplitInclusiveClear": (10690, 218), "SplitTerminator": (18061, 240),
    "SplitTerminatorClear": (18061, 240), "SplitN": (29441, 400),
    "SplitNClear": (29441, 400), "StartsWith": (25, 4),
    "StartsWithClear": (25, 4), "StripPrefix": (647, 24),
    "StripPrefixClear": (647, 24), "StripSuffix": (423, 26),
    "StripSuffixClear": (423, 26), "ToLower": (36, 3), "ToUpper": (36, 3),
    "Trim": (966, 43), "TrimEnd": (180, 12), "TrimStart": (786, 31),
    "Concatenate": (1355, 37), "Lt": (189, 49), "Le": (189, 49),
    "Gt": (189, 49), "Ge": (189, 49), "Eq": (131, 25), "Ne": (131, 25),
}
# The same at the turbo set's budget (192, as PARAM_TEST32_ZERO_NOISE; held
# equal to the JAX engine by tests/test_torch_cli_q32.py): 279,080 PBS, the
# items of benchmarks/methods_turbo_r5c.jsonl row by row, in 5,408 batches
# (that table lists 5,444: the JAX engine as it stands makes up to 2 fewer
# in 28 rows).
TURBO_COUNTS = {
    "Contains": (194, 5), "ContainsClear": (194, 5), "EndsWith": (365, 15),
    "EndsWithClear": (365, 15), "EqIgnoreCase": (182, 31), "Find": (239, 13),
    "FindClear": (239, 13), "IsEmpty": (41, 5), "Len": (38, 5),
    "Repeat": (20087, 65), "RepeatClear": (1316, 29), "Replace": (615, 17),
    "ReplaceClear": (615, 17), "ReplaceN": (741, 23),
    "ReplaceNClear": (741, 23), "Rfind": (239, 13), "RfindClear": (239, 13),
    "Rsplit": (12224, 217), "RsplitClear": (12224, 217),
    "RsplitOnce": (20016, 384), "RsplitOnceClear": (20016, 384),
    "RsplitN": (20016, 384), "RsplitNClear": (20016, 384),
    "RsplitTerminator": (13771, 231), "RsplitTerminatorClear": (13771, 231),
    "Split": (12224, 217), "SplitClear": (12224, 217),
    "SplitAsciiWhitespace": (6737, 130), "SplitInclusive": (8155, 212),
    "SplitInclusiveClear": (8155, 212), "SplitTerminator": (13771, 231),
    "SplitTerminatorClear": (13771, 231), "SplitN": (20016, 384),
    "SplitNClear": (20016, 384), "StartsWith": (25, 4),
    "StartsWithClear": (25, 4), "StripPrefix": (467, 18),
    "StripPrefixClear": (467, 18), "StripSuffix": (423, 26),
    "StripSuffixClear": (423, 26), "ToLower": (36, 3), "ToUpper": (36, 3),
    "Trim": (786, 37), "TrimEnd": (180, 12), "TrimStart": (606, 25),
    "Concatenate": (1015, 29), "Lt": (189, 49), "Le": (189, 49),
    "Gt": (189, 49), "Ge": (189, 49), "Eq": (131, 25), "Ne": (131, 25),
}
TABLE = [(7 * x + 3) % 16 for x in range(16)]
# Batches of phase 13's sweep: at N=2048 ext_product's pick_body takes 1, 1,
# 2, 1 and 1 groups of 8 items per block (two groups only where that pads
# the batch no further), and the last group of 33 and of 99 items is partly
# filled.
SWEEP_B = (1, 8, 32, 33, 99)
# K3 bodies (groups, chunk, split) of that sweep, beside the picked one:
# every groups; the smallest and the largest chunk; no split, a split in
# two and a split all the way.
K3_SWEEP_BODIES = ((1, 1024, 4), (1, 128, 32), (1, 2048, 1), (2, 512, 8),
                   (2, 1024, 2), (2, 2048, 1), (2, 256, 16))
GRAPH_LAUNCHES = 20  # launches captured to time a kernel on the device
SHARD_B = 256  # the batch-sharded PBS of phase 22
KEYSHARD_B = 8  # the key-sharded PBS of phase 22 and K3's column shard
NOISE_SAMPLES = 16384  # PARAM_PROD bootstraps of phase 23
RANKS_TIMEOUT = 600.0  # seconds a spawn of ranks may take (phase 22)
# Batches of the whole-rotation kernels' sweep (phases 4 and 9): either side
# of each switch of the pick at N=2048 on an H100 (132 SMs; 66 clusters of
# 2, 30 of 4 and 15 of 8 run at once), and 5, the usual batch of Eq.
ROTATION_SWEEP_B = (1, 5, 15, 16, 30, 31, 33, 66, 67, 90, 91, 132, 133, 150,
                    151, 198, 199)
PLAIN_SWEEP_B = (1, 5, 33)  # of those, the batches the plain version runs
PICK_SPREAD = 1.006  # run-to-run spread of a kernel time (PERF.md)
# What bounds a kernel on an H100: int32 instructions a second (64 lanes an
# SM at 1.98 GHz; a multiply-add is one) and bytes a second of HBM3.
INT32_LANES, CLOCK_HZ, MEMORY_RATE = 64, 1.98e9, 3.35e12
# The least int32 instructions of a modular butterfly (a Shoup product,
# three, and two lazy adds: what the SASS has), of a multiply-add of the
# pointwise products, and of one coefficient's rotate, difference and digits
BUTTERFLY_OPS, PRODUCT_OPS, DIGIT_OPS = 5, 1, 20


CARD = ""  # nvidia-smi's name and power limit of the card, set by main()


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


def bound(instructions, nbytes):
    """(bound_ms, bound_by): the least time the card could take for that
    many int32 instructions and bytes."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_ms = instructions / (sms * INT32_LANES * CLOCK_HZ) * 1e3
    bytes_ms = nbytes / MEMORY_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ntt_instructions(n, transforms, products):
    """int32 instructions of one item's external product by the two-prime
    NTT: `transforms` radix-2 transforms of length n and `products` modular
    multiply-adds per coefficient, both counted over the two primes."""
    butterflies = transforms * (n // 2) * (n.bit_length() - 1)
    return BUTTERFLY_OPS * butterflies + PRODUCT_OPS * products * n


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def rotation_bodies(kernel, plain, acc, amt, khat, phase, label, **mode):
    """Every body of a whole-rotation kernel against one run of the plain
    version, bit-exact, each timed (mean of 3 launches after a warm-up).
    Returns (ms of the picked body, plain ms, max |diff|)."""
    import torch

    plain_ms, want = cuda_ms(lambda: plain(acc, amt, khat, **mode))
    times, worst = {}, 0
    for c in (None, *kernel.bodies):
        before = dict(kernel.bodies)
        kernel(acc, amt, khat, cluster=c, **mode)  # warm-up
        ms, got = cuda_ms(lambda: kernel(acc, amt, khat, cluster=c, **mode),
                          repeat=3)
        ran = [b for b in kernel.bodies if kernel.bodies[b] != before[b]]
        if len(ran) != 1 or (c is not None and ran != [c]):
            fail(f"{kernel.__name__}(cluster={c}) ran the bodies {ran}")
        err = max_abs_err(got, want)
        worst = max(worst, err)
        if err or not torch.equal(got, want):
            fail(f"{kernel.__name__}<{ran[0]}> ({label}) differs from the "
                 f"plain version: max |diff| {err}")
        times[ran[0] if c is None else c] = ms
        if c is None:
            picked, picked_ms = ran[0], ms
    B, n = amt.shape
    print(f"phase {phase} kernel vs plain ({label}): B={B} n={n} "
          f"N={acc.shape[2]} every body bit-exact; " + ", ".join(
              f"<{c}> {ms:.3f} ms" for c, ms in times.items())
          + f"; picked <{picked}> {picked_ms:.3f} ms; plain {plain_ms:.1f} ms "
          f"({plain_ms / picked_ms:.1f}x)")
    return picked_ms, plain_ms, worst


def rotation_sweep(kernel, plain, make_acc, khat, phase, label, **mode):
    """Every body at each B of ROTATION_SWEEP_B (the faster of two
    launches): all bodies bit-identical, equal to the plain version at the
    B of PLAIN_SWEEP_B, and the picked body no slower than the one-block
    body.  Prints ms per body per B."""
    import torch

    dev = khat.device
    n, N = khat.shape[0], khat.shape[-1]
    gen = torch.Generator().manual_seed(phase)
    rows = []
    for b in ROTATION_SWEEP_B:
        acc = make_acc(gen, b).to(dev)
        amt = torch.randint(0, 2 * N, (b, n), dtype=torch.int32,
                            generator=gen).to(dev)
        before = dict(kernel.bodies)
        want = kernel(acc, amt, khat, **mode)
        picked, = [c for c in kernel.bodies if kernel.bodies[c] != before[c]]
        if b in PLAIN_SWEEP_B and not torch.equal(
                want, plain(acc, amt, khat, **mode)):
            fail(f"{kernel.__name__}<{picked}> ({label}) differs from the "
                 f"plain version at B={b}")
        times = {}
        for c in kernel.bodies:
            runs = [cuda_ms(lambda: kernel(acc, amt, khat, cluster=c, **mode))
                    for _ in range(2)]
            if not all(torch.equal(got, want) for _, got in runs):
                fail(f"{kernel.__name__}<{c}> ({label}) differs from "
                     f"<{picked}> at B={b}")
            times[c] = min(ms for ms, _ in runs)
        if times[picked] > PICK_SPREAD * times[1]:
            fail(f"{kernel.__name__} ({label}) at B={b}: the picked <{picked}> "
                 f"took {times[picked]:.3f} ms, <1> {times[1]:.3f} ms")
        rows.append(f"B={b} " + " ".join(f"<{c}> {ms:.2f}"
                                         for c, ms in times.items())
                    + f" picked <{picked}>")
    print(f"phase {phase} sweep ({label}): ms per body, all bodies "
          f"bit-identical, plain version at B={PLAIN_SWEEP_B}; "
          + "; ".join(rows))


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
    held = {"bsk": dkeys.bsk_ntt32 if P.torus_bits == 32 else dkeys.bsk_ntt64,
            "bsk_limbs": dkeys.bsk_limbs, "ksk": dkeys.ksk_limbs}
    held = {k: t for k, t in held.items() if t is not None}
    mib = sum(t.numel() * t.element_size() for t in held.values()) / 2**20
    print(f"phase {phase} keys: {P.name} n={P.lwe_dimension} "
          f"N={P.polynomial_size} keygen {t_keygen:.2f} s, packing on the "
          f"card {t_pack:.2f} s, {mib:.0f} MiB on the card (" + ", ".join(
              f"{k} {tuple(t.shape)}" for k, t in held.items()) + ")")
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


def requests(client, server, counters, table_counts, phase, spans=None):
    """The six requests through the served path.  counters: (kernel,
    launches per PBS batch) of each kernel the path must run that many
    times (0: never).  spans: a list that the run fills with (start, end)
    CUDA events around device work of interest; each request then prints
    the share of its wall time between them, after a first untimed pass
    over the six.  Returns each kernel's
    launches counted over the requests (every count is set to 0 just
    before)."""
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
    if spans is not None:  # a first pass captures the batches' step graphs
        for call, _ in calls.values():
            call(*inputs)
    torch.cuda.synchronize()
    if spans is not None:
        spans.clear()
    for kernel, _ in counters:
        kernel.launches = 0
        if hasattr(kernel, "bodies"):
            kernel.bodies = dict.fromkeys(kernel.bodies, 0)
    rows = []
    for method, (call, expected) in calls.items():
        metrics.reset()
        t0 = time.perf_counter()
        out = call(*inputs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        inside = None
        if spans is not None:
            inside = sum(a.elapsed_time(b) for a, b in spans) / 1e3
            spans.clear()
        got = (client.decrypt(out) if isinstance(expected, str)
               else client.decrypt_char(out))
        counts = (metrics.GLOBAL.pbs_items, metrics.GLOBAL.pbs_calls)
        if got != expected:
            fail(f"{method}: got {got!r}, Python str gives {expected!r}")
        if counts != table_counts[method]:
            fail(f"{method}: PBS (items, batches) {counts}, table "
                 f"{table_counts[method]}")
        rows.append((method, got, counts, dt, inside))
    requests.wall[phase] = {r[0]: r[3] for r in rows}
    launches = [kernel.launches for kernel, _ in counters]
    batches = sum(r[2][1] for r in rows)
    for (kernel, per_batch), count in zip(counters, launches):
        if count != per_batch * batches:
            fail(f"{kernel.__name__} launches {count}, expected {per_batch} "
                 f"per PBS batch x {batches} batches")
    print(f"phase {phase} requests: " + "; ".join(
        f"{m}={g!r} pbs={c[0]} batches={c[1]} {dt * 1e3:.0f} ms"
        + ("" if inside is None else
           f" ({100 * inside / dt:.1f}% in the step graphs)")
        for m, g, c, dt, inside in rows) + "; launches " + ", ".join(
            f"{kernel.__name__} {count}"
            + ("".join(f" <{c}> x{k}" for c, k in kernel.bodies.items())
               if hasattr(kernel, "bodies") else "")
            for (kernel, _), count in zip(counters, launches))
          + f"; the six together {sum(r[3] for r in rows) * 1e3:.0f} ms"
          + ("" if spans is None else
             f", {100 * sum(r[4] for r in rows) / sum(r[3] for r in rows):.1f}"
             f"% of it in the step graphs") + f"; {CARD}")
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


def stepwise_kernels(dkeys, phase, steps=4, batch=8):
    """K5, K3 and K4 against their plain versions over `steps` steps of
    the prod key at B=batch, the accumulator advancing by K3's product
    (added by K3 itself, and held against acc + ext); step 0 takes the
    amounts 0, N and 2N - 1.  K4 in each of its bodies, fresh and adding
    into the accumulator.  Returns {name: (max |diff|, kernel ms, plain
    ms)}, the times of step 0: the kernel's device time (``tools.graph_ms``: GRAPH_LAUNCHES launches
    captured into a CUDA graph; timing launches are not counted), the plain
    version's one run after a warm-up."""
    import torch

    from fhestring_tpu_torch import torus
    from fhestring_tpu_torch.crypto.kernels import ext_product as ep
    from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne
    from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd
    from fhestring_tpu_torch.tools import graph_ms, wall_ms

    dev = dkeys.bsk_limbs.device
    N = dkeys.params.polynomial_size
    gen = torch.Generator().manual_seed(phase)
    acc = torch.randint(-2**63, 2**63 - 1, (batch, 2, N), dtype=torch.int64,
                        generator=gen).to(dev)
    amt = torch.randint(0, 2 * N, (steps, batch), dtype=torch.int32,
                        generator=gen)
    amt[0, :3] = torch.tensor([0, N, 2 * N - 1], dtype=torch.int32)
    amt = amt.to(dev)
    result, wall, k4_ms = {}, {}, {}
    for j in range(steps):
        a, limbs, khat = amt[j], dkeys.bsk_limbs[j], dkeys.bsk_ntt64[j]
        dl = rd.rotate_diff_decompose(acc, a)
        dl_out, ext_out = torch.empty_like(dl), torch.empty_like(acc)
        # name: (returning form, plain version, form the step loop times)
        trio = {
            "rotate_decompose": (
                lambda: rd.rotate_diff_decompose(acc, a),
                lambda: rd.rotate_diff_decompose_plain(acc, a),
                lambda: rd.rotate_diff_decompose(acc, a, out=dl_out)),
            "ext_product": (
                lambda: ep.ext_product(dl, limbs),
                lambda: ep.ext_product_plain(dl, limbs),
                lambda: ep.ext_product(dl, limbs, out=ext_out,
                                       accumulate=True)),
            "ntt_ext": (
                lambda: ne.ntt_ext(dl, khat),
                lambda: ne.ntt_ext_plain(dl, khat),
                lambda: ne.ntt_ext(dl, khat, out=ext_out, accumulate=True)),
        }
        outs = {}
        for name, (kernel, plain, looped) in trio.items():
            if j == 0:
                plain()  # warm-up
                ms = graph_ms(looped, GRAPH_LAUNCHES)
                if name != "ntt_ext":
                    wall[name] = wall_ms(looped)
                plain_ms, want = cuda_ms(plain)
            else:
                ms = plain_ms = None
                want = plain()
            got = kernel()
            err = max_abs_err(got, want)
            if err or not torch.equal(got, want):
                fail(f"{name} differs from its plain version at step {j}: "
                     f"max |diff| {err}")
            prev = result.get(name, (0, ms, plain_ms))
            result[name] = (max(prev[0], err), prev[1], prev[2])
            outs[name] = got
        if not torch.equal(outs["ext_product"], outs["ntt_ext"]):
            fail(f"ext_product and ntt_ext differ at step {j}")
        for c in ne.CLUSTERS:   # every body of K4, fresh and accumulating
            fresh = ne.ntt_ext(dl, khat, cluster=c)
            added = ne.ntt_ext(dl, khat, out=acc.clone(), accumulate=True,
                               cluster=c)
            if not (torch.equal(fresh, outs["ext_product"])
                    and torch.equal(added, torus.add(acc, fresh))):
                fail(f"ntt_ext<{c}> differs from its plain version or from "
                     f"ext_product at step {j}")
            if j == 0:
                k4_ms[c] = graph_ms(lambda: ne.ntt_ext(
                    dl, khat, out=ext_out, accumulate=True, cluster=c),
                    GRAPH_LAUNCHES)
        want = torus.add(acc, outs["ext_product"])
        acc = ep.ext_product(dl, limbs, out=acc, accumulate=True)
        if not torch.equal(acc, want):
            fail(f"ext_product(accumulate=True) differs from acc + ext at "
                 f"step {j}")
    # one step of the K3 route on the device, at step 0
    a, limbs = amt[0], dkeys.bsk_limbs[0]

    def two_kernels():
        rd.rotate_diff_decompose(acc, a, out=dl_out)
        ep.ext_product(dl_out, limbs, out=acc, accumulate=True)

    step_ms = graph_ms(two_kernels, GRAPH_LAUNCHES)
    print(f"phase {phase} step-wise kernels vs plain: B={batch} N={N}, "
          f"{steps} steps of the prod key, bit-exact, K3 = K4 in every body "
          f"of K4, K3 accumulating = acc + ext; "
          f"device time of a launch (a graph of "
          f"{GRAPH_LAUNCHES}): " + "; ".join(
              f"{name} kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
              f"({plain_ms / ms:.1f}x)"
              for name, (_, ms, plain_ms) in result.items())
          + "; ntt_ext by body " + ", ".join(
              f"<{c}> {ms:.4f} ms" for c, ms in k4_ms.items())
          + f" (picked <{ne.pick_cluster(batch, N, dev.index or 0)}>)"
          + f"; a step of the K3 route (K5 then K3) {step_ms:.4f} ms"
          + "; eager wall time of a launch: " + ", ".join(
              f"{name} {ms:.4f} ms" for name, ms in wall.items()))
    picked = ne.pick_cluster(batch, N, dev.index or 0)
    if k4_ms[picked] > 1.006 * min(k4_ms.values()):
        fail(f"ntt_ext picks body <{picked}> at B={batch}, "
             f"{k4_ms[picked]:.4f} ms, slower than {k4_ms}")
    return result


def stepwise_batches(dkeys, phase):
    """K5, K3 and K4 against their plain versions on step 0 of the prod key
    at each B of SWEEP_B: K3 in the body ``pick_body`` takes and in every
    body of K3_SWEEP_BODIES, returning a fresh tensor and adding into an
    accumulator; K4 in each of its bodies, fresh and accumulating; all
    equal to the plain version."""
    import torch

    from fhestring_tpu_torch.crypto.kernels import ext_product as ep
    from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne
    from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd

    dev = dkeys.bsk_limbs.device
    N = dkeys.params.polynomial_size
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    limbs, khat = dkeys.bsk_limbs[0], dkeys.bsk_ntt64[0]
    gen = torch.Generator().manual_seed(phase)
    picked = []
    for b in SWEEP_B:
        acc = torch.randint(-2**63, 2**63 - 1, (b, 2, N), dtype=torch.int64,
                            generator=gen).to(dev)
        a = torch.randint(0, 2 * N, (b,), dtype=torch.int32,
                          generator=gen).to(dev)
        a[:3] = torch.tensor([0, N, 2 * N - 1], dtype=torch.int32)[:b]
        dl = rd.rotate_diff_decompose(acc, a)
        if not torch.equal(dl, rd.rotate_diff_decompose_plain(acc, a)):
            fail(f"rotate_decompose differs from its plain version at B={b}")
        want = ep.ext_product_plain(dl, limbs)
        got = {"ext_product": ep.ext_product(dl, limbs),
               "ntt_ext": ne.ntt_ext(dl, khat),
               "ntt_ext plain": ne.ntt_ext_plain(dl, khat)}
        for body in K3_SWEEP_BODIES:
            got[f"ext_product{body}"] = ep.ext_product(dl, limbs, body=body)
            got[f"ext_product{body} accumulating"] = ep.ext_product(
                dl, limbs, out=acc.clone(), accumulate=True, body=body) - acc
        for c in ne.CLUSTERS:
            got[f"ntt_ext<{c}>"] = ne.ntt_ext(dl, khat, cluster=c)
            got[f"ntt_ext<{c}> accumulating"] = ne.ntt_ext(
                dl, khat, out=acc.clone(), accumulate=True, cluster=c) - acc
        for name, out in got.items():
            if not torch.equal(out, want):
                fail(f"{name} differs from ext_product's plain version at "
                     f"B={b}: max |diff| {max_abs_err(out, want)}")
        picked.append(f"B={b}: K3{ep.pick_body(b, N, sms)} "
                      f"K4<{ne.pick_cluster(b, N, dev.index or 0)}>")
    print(f"phase {phase} step-wise kernels vs plain by batch: N={N}, step 0 "
          f"of the prod key, K5, K3 and K4 bit-exact; picked (groups, chunk, "
          f"split) and blocks per item " + ", ".join(picked) + f"; and K3 "
          f"in each of {len(K3_SWEEP_BODIES)} more bodies and K4 in its 3 "
          f"bodies, fresh and accumulating, bit-exact at every B")


def step_products():
    """The step loop's product kernels by label, each with the field of the
    key it reads: K3 against bsk_limbs, K4 against bsk_ntt64."""
    from fhestring_tpu_torch.crypto.kernels import ext_product as ep
    from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne

    return {"K3": (ep.ext_product, "bsk_limbs"),
            "K4": (ne.ntt_ext, "bsk_ntt64")}


def stepwise_pbs_batch(cts, idx, bank, dkeys, label):
    """pbs_batch with the step loop of that product kernel as its blind
    rotation (the body is folded into the accumulator, so the loop takes
    the mask amounts alone)."""
    import torch

    from fhestring_tpu_torch.crypto import pbs

    p = dkeys.params
    lwe_2n = pbs.modswitch(pbs.keyswitch(cts, dkeys), p)
    acc = pbs.initial_acc(lwe_2n, idx, bank, p)
    amounts = lwe_2n[:, :p.lwe_dimension].to(torch.int32)
    product, field = step_products()[label]
    return pbs.sample_extract(pbs._blind_rotate_stepwise(
        acc, amounts, getattr(dkeys, field), product), p)


def stepwise_pbs(client, dkeys, bank, phase):
    """A bootstrap of 256 messages through TABLE by the step loop with K3
    and with K4, and pbs_batch by K2's exact mode: all decrypt right and
    the three are bit-identical.  Returns ntt_ext's launches over the K4
    route's run (set to 0 just before)."""
    import torch

    from fhestring_tpu_torch import torus
    from fhestring_tpu_torch.crypto import pbs
    from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne
    from fhestring_tpu_torch.numpy_ref import core as ref

    msgs, cts = encrypt_msgs(client, 256, 14)
    zeros = torch.zeros(len(msgs), dtype=torch.int64, device=client.device)
    outs, line = {}, []
    for label in ("K2 exact", "K3", "K4"):
        torch.cuda.synchronize()
        ne.ntt_ext.launches = 0
        if label == "K2 exact":
            ms, out = cuda_ms(lambda: pbs.pbs_batch(cts, zeros, bank, dkeys))
        else:
            ms, out = cuda_ms(lambda: stepwise_pbs_batch(cts, zeros, bank,
                                                         dkeys, label))
        if label == "K4":
            k4_launches = ne.ntt_ext.launches
        outs[label] = out
        out = torus.to_numpy(out)
        bad = sum(ref.shortint_decrypt(client.secret, out[i]) != TABLE[m]
                  for i, m in enumerate(msgs))
        if bad:
            fail(f"pbs_batch ({label}): {bad} of {len(msgs)} outputs "
                 f"decrypt wrong")
        line.append(f"{label} {ms:.1f} ms ({len(msgs) / ms * 1e3:.0f} PBS/s)")
    for label in ("K3", "K4"):
        if not torch.equal(outs[label], outs["K2 exact"]):
            fail(f"pbs_batch through the {label} route differs from K2's "
                 f"exact mode")
    if k4_launches != dkeys.params.lwe_dimension:
        fail(f"ntt_ext launches {k4_launches} in one pbs_batch")
    print(f"phase {phase} step-wise pbs_batch: B={len(msgs)} all decrypt to "
          f"table[m]; K3 and K4 routes bit-identical to K2 exact; "
          + "; ".join(line) + f"; ntt_ext launches {k4_launches}")
    return k4_launches


def stepwise_graph(dkeys, phase, batches=(15, 5)):
    """The step loop's CUDA graph with K3 and with K4: at the first B of
    `batches` two different inputs through one cached graph, then one at the
    second B; every result has the bits of the eager loop and of K2's exact
    mode, each B captures once, and a replay counts n launches of K5 and of
    the product kernel.  A capture or a replay that raises fails the
    run."""
    import torch

    from fhestring_tpu_torch.crypto import pbs
    from fhestring_tpu_torch.crypto.kernels import blind_rotate64 as br64
    from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd

    dev = dkeys.bsk_limbs.device
    N, n = dkeys.params.polynomial_size, dkeys.params.lwe_dimension
    gen = torch.Generator().manual_seed(phase)
    line = []
    for label, (product, field) in step_products().items():
        key = getattr(dkeys, field)
        times = []
        for b, turns in zip(batches, (2, 1)):
            held = len(pbs._STEP_GRAPHS)
            for turn in range(turns):
                acc = torch.randint(-2**63, 2**63 - 1, (b, 2, N),
                                    dtype=torch.int64, generator=gen).to(dev)
                amt = torch.randint(0, 2 * N, (b, n), dtype=torch.int32,
                                    generator=gen).to(dev)
                before = rd.rotate_diff_decompose.launches, product.launches
                t0 = time.perf_counter()
                got = pbs._blind_rotate_stepwise(acc, amt, key, product)
                torch.cuda.synchronize()
                times.append(f"B={b} {(time.perf_counter() - t0) * 1e3:.1f} ms"
                             + (" (with the capture)" if turn == 0 else ""))
                counted = (rd.rotate_diff_decompose.launches - before[0],
                           product.launches - before[1])
                if counted != (n, n):
                    fail(f"{label} route: a replay counted {counted} launches "
                         f"of (K5, the product kernel), not {(n, n)}")
                if turn:
                    ms = cuda_ms(lambda: pbs._blind_rotate_stepwise(
                        acc, amt, key, product), 3)[0]
                    times[-1] = f"B={b} {ms:.2f} ms"
                t0 = time.perf_counter()
                eager = pbs._run_steps(acc.clone(), amt.t().contiguous(),
                                       key, product)
                torch.cuda.synchronize()
                if turn:
                    times.append(f"eager {(time.perf_counter() - t0) * 1e3:.1f}"
                                 f" ms")
                exact = br64.blind_rotate64(acc, amt, dkeys.bsk_ntt64)
                if not (torch.equal(got, eager) and torch.equal(got, exact)):
                    fail(f"{label} route, B={b}, input {turn}: the replayed "
                         f"graph differs from the eager loop or from K2's "
                         f"exact mode")
            if len(pbs._STEP_GRAPHS) != held + 1:
                fail(f"{label} route: B={b} captured "
                     f"{len(pbs._STEP_GRAPHS) - held} graphs, not 1")
        line.append(f"{label} route " + ", ".join(times))
    print(f"phase {phase} step-loop graph: {n} steps replayed from one graph "
          f"per (product kernel, B), bit-identical to the eager loop and to "
          f"K2 exact; " + "; ".join(line))


requests.wall = {}  # phase -> {method: seconds} of its last run


CLI_ROW = re.compile(r"(\w+) (\d+\.\d+)s \[(\d+) PBS in (\d+) batches\]$")


def cli_on_the_card(params_name, table, phase):
    """The ported CLI (``fhestring_tpu_torch.cli.main``) on the card, with
    the arguments of benchmarks/methods.py: every variant's line must say
    ``Test Passed`` and carry the table's (PBS, batches); the closing line
    must count them all.  At the turbo set the PBS items must also be the
    rows of benchmarks/methods_turbo_r5c.jsonl (the card has no JAX engine
    to ask; that table's batch counts are up to 2 above the engine's in 28
    rows, see TURBO_COUNTS)."""
    import io

    from fhestring_tpu_torch import cli

    argv = ["--string", S, "--pattern", PAT, "--n", "2", "--from", "o",
            "--to", "0", "--params", params_name, "--device", "cuda",
            "--metrics"]
    methods = list(cli.METHODS)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    rows = [ln for ln in lines if ln.startswith("Test ")]
    if rc != 0 or lines[-1] != f"{len(methods)}/{len(methods)} methods passed":
        fail(f"the CLI at --params {params_name} returned {rc}: "
             + " | ".join(ln for ln in rows if not ln.startswith(
                 "Test Passed")) + " | " + lines[-1])
    if len(rows) != len(methods):
        fail(f"the CLI printed {len(rows)} method lines for {len(methods)}")
    with open(os.path.join(ROOT, "benchmarks", "methods_turbo_r5c.jsonl")) as f:
        r5c = {r["method"]: r["pbs"] for r in map(json.loads, f)}
    total, slowest = [0, 0], ("", 0.0)
    for method, row in zip(methods, rows):
        m = CLI_ROW.search(row)
        if not (row.startswith("Test Passed: OK, Result: ") and m
                and m.group(1) == method):
            fail(f"the CLI's line for {method}: {row!r}")
        counts = (int(m.group(3)), int(m.group(4)))
        if counts != table[method]:
            fail(f"the CLI's {method}: (PBS, batches) {counts}, table "
                 f"{table[method]}")
        if params_name == "turbo" and counts[0] != r5c[method]:
            fail(f"the CLI's {method}: {counts[0]} PBS, methods_turbo_r5c "
                 f"lists {r5c[method]}")
        total = [total[0] + counts[0], total[1] + counts[1]]
        if float(m.group(2)) > slowest[1]:
            slowest = (method, float(m.group(2)))
    print(f"phase {phase} CLI on the card: --params {params_name} --device "
          f"cuda --metrics, {len(methods)}/{len(methods)} methods passed, "
          f"every row's (PBS, batches) equal to the table: {total[0]} PBS in "
          f"{total[1]} batches; {seconds:.1f} s with keygen and packing, the "
          f"slowest {slowest[0]} {slowest[1]:.1f} s")


@contextlib.contextmanager
def timed_replays(spans):
    """The share of a request the card spends in the replayed step graphs:
    CUDA events around every replay, appended to ``spans``."""
    import torch

    from fhestring_tpu_torch.crypto import pbs

    replay = pbs._replay_steps

    def timed_replay(entry):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        replay(entry)
        end.record()
        spans.append((start, end))

    pbs._replay_steps = timed_replay
    try:
        yield
    finally:
        pbs._replay_steps = replay


def same_device_keys(got, want, what):
    """Every key tensor of two DeviceServerKeys present in both or in
    neither, on the card and bit-identical."""
    import torch

    for field in ("bsk_limbs", "ksk_limbs", "bsk_ntt32", "bsk_ntt64"):
        a, b = getattr(got, field), getattr(want, field)
        if (a is None) != (b is None) or (a is not None and not (
                a.is_cuda and torch.equal(a, b))):
            fail(f"{what}: {field} differs from the saved server's")


def persistence(client, label, with_ntt2, workdir, phase):
    """Pack the client's server key on the card, save it, load it into a
    fresh ServerKey on the card, serve one request (Contains) with the bits
    of the server it was saved from, then get_server_key(cache_path=) twice:
    a miss that packs and saves, and a hit that must not pack.  Returns the
    loaded server."""
    import torch

    from fhestring_tpu_torch import client as client_mod
    from fhestring_tpu_torch import serialize

    t0 = time.perf_counter()
    server = client.get_server_key(with_ntt2)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    path = os.path.join(workdir, f"{label}.npz")
    t0 = time.perf_counter()
    serialize.save_packed_server_key(path, server)
    t_save = time.perf_counter() - t0
    mib = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    loaded = serialize.load_packed_server_key(path, device=client.device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same_device_keys(loaded.backend.sc.keys, server.backend.sc.keys,
                     f"{label} loaded")
    s, pat = client.encrypt(S, 1), client.encrypt_no_padding(PAT)
    got, want = loaded.contains(s, pat), server.contains(s, pat)
    if not torch.equal(got.blocks.ct, want.blocks.ct):
        fail(f"{label}: Contains through the loaded key differs from the "
             f"server it was saved from")
    if client.decrypt_char(got) != int(PAT in S):
        fail(f"{label}: Contains through the loaded key decrypts wrong")
    del server
    cache = os.path.join(workdir, f"{label}-cache.npz")
    t0 = time.perf_counter()
    miss = client.get_server_key(with_ntt2, cache)
    torch.cuda.synchronize()
    t_miss = time.perf_counter() - t0
    packs, pack = [], client_mod.pack_server_keys
    client_mod.pack_server_keys = lambda *a, **k: packs.append(1) or pack(
        *a, **k)
    try:
        t0 = time.perf_counter()
        hit = client.get_server_key(with_ntt2, cache)
        torch.cuda.synchronize()
        t_hit = time.perf_counter() - t0
    finally:
        client_mod.pack_server_keys = pack
    if packs or not os.path.exists(cache):
        fail(f"{label}: get_server_key(cache_path=) packed on a hit")
    same_device_keys(hit.backend.sc.keys, miss.backend.sc.keys,
                     f"{label} cache hit")
    del miss, hit
    print(f"phase {phase} persistence ({label}): file {mib:.1f} MiB; pack "
          f"{t_pack:.2f} s, save {t_save:.2f} s, load onto the card "
          f"{t_load:.2f} s, keys bit-identical, Contains bit-identical to "
          f"the saving server; get_server_key(cache_path=) miss {t_miss:.2f} "
          f"s, hit {t_hit:.2f} s ({t_miss / t_hit:.1f}x); {CARD}")
    return loaded


def served_over_tcp(client, server, counters, phase):
    """The six requests through a FheStringServer over ``server`` on
    127.0.0.1, from a RemoteServerKey; results, PBS counts and launches as
    in the in-process phases (the server runs in this process, so its
    metrics are the ones read), wall time per request beside phase 11's."""
    from fhestring_tpu_torch.service import FheStringServer, RemoteServerKey

    tcp = FheStringServer(server).start()
    try:
        remote = RemoteServerKey(tcp.address, device=client.device,
                                 timeout=300)
        launches = requests(client, remote, counters, PROD_COUNTS, phase)
    finally:
        tcp.stop()
    wall, local = requests.wall[phase], requests.wall[11]
    print(f"phase {phase} service: FheStringServer on {tcp.address[0]}:"
          f"{tcp.address[1]}, six requests over TCP against in process "
          f"(phase 11): " + "; ".join(
              f"{m} {wall[m] * 1e3:.0f} vs {local[m] * 1e3:.0f} ms"
              for m in wall)
          + f"; the six {sum(wall.values()) * 1e3:.0f} vs "
          f"{sum(local.values()) * 1e3:.0f} ms; {CARD}")
    return launches


def limb_route32_kernels(dkeys, phase, batch=8):
    """The 32-bit limb route's K3 launches at its shapes: a step's digits
    of the three gadget levels (limbs 1 and 2 zero) against each level's
    rows of the turbo bsk_limbs, on the card against the plain version,
    fresh and accumulating."""
    import torch

    from fhestring_tpu_torch.crypto import pbs
    from fhestring_tpu_torch.crypto.kernels import ext_product as ep

    dev = dkeys.bsk_limbs.device
    p = dkeys.params
    N, kp1 = p.polynomial_size, p.glwe_dimension + 1
    gen = torch.Generator().manual_seed(phase)
    acc = (torch.randint(-2**63, 2**63 - 1, (batch, kp1, N), dtype=torch.int64,
                         generator=gen) & ~0xFFFFFFFF).to(dev)
    a = torch.randint(0, 2 * N, (batch,), dtype=torch.int32,
                      generator=gen).to(dev)
    dl = pbs._digit_buffer(acc.shape, p.pbs_level, dev)
    pbs._digits_levels(acc, a, dl)
    worst = 0
    for lev in range(p.pbs_level):
        key = dkeys.bsk_limbs[0, lev * kp1:(lev + 1) * kp1]
        want = ep.ext_product_plain(dl[lev], key)
        got = ep.ext_product(dl[lev], key)
        summed = ep.ext_product(dl[lev], key, out=acc.clone(),
                                accumulate=True)
        worst = max(worst, max_abs_err(got, want))
        if not (torch.equal(got, want) and torch.equal(summed, acc + want)):
            fail(f"ext_product on the 32-bit route, level {lev}, differs "
                 f"from its plain version")
    print(f"phase {phase} K3 on the 32-bit route: B={batch} N={N}, the "
          f"{p.pbs_level} gadget levels' digits against each level's key "
          f"rows, fresh and accumulating, bit-exact (max |diff| {worst})")


def column_shard_bodies(dkeys, phase, batch=KEYSHARD_B):
    """K3 on a one-column shard of the prod key's step 0 (the key-sharded
    blind rotation's ``bsk_limbs[:, :, cols]``) in the picked body and
    every body of K3_SWEEP_BODIES, fresh and accumulating: those columns
    of the full product, bit for bit.  Returns the device times (a graph
    of GRAPH_LAUNCHES launches, added into an accumulator as the rotation
    does) of K3 on the shard and on the whole key, and of K5 + K3 on the
    shard (the kernels of one key-sharded step), in ms."""
    import torch

    from fhestring_tpu_torch.crypto.kernels import cuda_build
    from fhestring_tpu_torch.crypto.kernels import ext_product as ep
    from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd
    from fhestring_tpu_torch.tools import graph_ms

    dev = dkeys.bsk_limbs.device
    sms = cuda_build.sm_count(dev.index or 0)
    N = dkeys.params.polynomial_size
    gen = torch.Generator().manual_seed(phase)
    acc = torch.randint(-2**63, 2**63 - 1, (batch, 2, N), dtype=torch.int64,
                        generator=gen).to(dev)
    a = torch.randint(0, 2 * N, (batch,), dtype=torch.int32,
                      generator=gen).to(dev)
    dl = rd.rotate_diff_decompose(acc, a)
    limbs = dkeys.bsk_limbs[0]
    full = ep.ext_product_plain(dl, limbs)
    bodies = [None, *K3_SWEEP_BODIES]
    for col in range(2):
        shard = limbs[:, col:col + 1].contiguous()
        want = full[:, col:col + 1]
        start = acc[:, col:col + 1].contiguous()
        for body in bodies:
            got = ep.ext_product(dl, shard, body=body)
            added = ep.ext_product(dl, shard, out=start.clone(),
                                   accumulate=True, body=body)
            if not (torch.equal(got, want)
                    and torch.equal(added, start + want)):
                fail(f"ext_product on column {col} of the key, body {body}, "
                     f"differs from that column of the full product")
    shard = limbs[:, :1].contiguous()
    out1, out2 = torch.zeros_like(acc[:, :1]), torch.zeros_like(acc)
    shard_ms = graph_ms(lambda: ep.ext_product(dl, shard, out=out1,
                                               accumulate=True),
                        GRAPH_LAUNCHES)
    full_ms = graph_ms(lambda: ep.ext_product(dl, limbs, out=out2,
                                              accumulate=True),
                       GRAPH_LAUNCHES)
    dl_out = torch.empty_like(dl)

    def step():
        rd.rotate_diff_decompose(acc, a, out=dl_out)
        ep.ext_product(dl_out, shard, out=out1, accumulate=True)

    step_ms = graph_ms(step, GRAPH_LAUNCHES)
    print(f"phase {phase} K3 on a column shard: B={batch} N={N}, each of "
          f"the 2 columns in the picked body "
          f"{ep.pick_body(batch, N, sms, 1)} and the {len(K3_SWEEP_BODIES)} "
          f"of K3_SWEEP_BODIES, fresh and accumulating, bit-identical to "
          f"that column of the full product; device time of a launch (a "
          f"graph of {GRAPH_LAUNCHES}): one column {shard_ms:.4f} ms, both "
          f"{full_ms:.4f} ms; K5 + K3 on one column {step_ms:.4f} ms")
    return shard_ms, full_ms, step_ms


def sharded_on_the_card(client, turbo, dkeys, tkeys, phase):
    """parallel.py on the card.  (a) the batch-sharded PBS at B=SHARD_B in
    the served modes (PARAM_PROD rounded + approx, turbo exact), (b) the
    key-sharded PBS at B=KEYSHARD_B (exact), (d) the polynomial-sharded
    forward, inverse and ext_group at N=2048 mod 40961, over 2 gloo ranks
    sharing the card and over 1 NCCL rank: each rank's outputs
    bit-identical to this process's pbs_batch in the same mode (K5 + K3
    for (b)) and to the numpy plan, each rank's launches one K2 (K1) for
    its rows, and n each of K5 and K3 for (b), whose step is also split
    into its measured parts.  This process saves its packed keys with
    serialize, and every rank loads them.  (c) the dry run's four stages
    at PARAM_PROD on S x PAT over 2 gloo ranks (rank 0 makes the keys from
    seed 0, packs and saves them, the other loads them), decrypted to
    Python's answers, Contains with PROD_COUNTS."""
    import shutil

    import numpy as np
    import torch

    from fhestring_tpu_torch import PARAM_PROD, PARAM_TURBO, dryrun, parallel
    from fhestring_tpu_torch import serialize, torus
    from fhestring_tpu_torch.crypto import keys, ntt_plan, pbs
    from fhestring_tpu_torch.server import ServerKey

    dev = client.device
    n, N = PARAM_PROD.lwe_dimension, PARAM_PROD.polynomial_size
    shard_ms, full_ms, kernels_ms = column_shard_bodies(dkeys, phase)
    _, cts = encrypt_msgs(client, SHARD_B, phase)
    _, tcts = encrypt_msgs(turbo, SHARD_B, phase + 1)
    _, kcts = encrypt_msgs(client, KEYSHARD_B, phase + 2)
    idx = torch.zeros(SHARD_B, dtype=torch.int64, device=dev)
    bank = keys.pack_luts([TABLE], PARAM_PROD, dev)
    tbank = keys.pack_luts([TABLE], PARAM_TURBO, dev)
    prod = dict(rounded=True, approx=True)
    # the same key without its NTT-domain key: pbs_batch's K5 + K3 route
    limb_keys = keys.DeviceServerKeys(PARAM_PROD, dkeys.ksk_limbs,
                                      bsk_limbs=dkeys.bsk_limbs)
    single = {}
    runs = {"turbo": lambda: pbs.pbs_batch(tcts, idx, tbank, tkeys),
            "prod": lambda: pbs.pbs_batch(cts, idx, bank, dkeys, **prod),
            "keysharded": lambda: pbs.pbs_batch(
                kcts, idx[:KEYSHARD_B], bank, limb_keys)}
    for name, run in runs.items():
        run()  # warm-up (captures the step graph of the K3 route)
        single[name] = cuda_ms(run)
    rng = np.random.default_rng(phase)
    prime = 40961
    plan = ntt_plan.make_neg_plan(prime, N)
    x = rng.integers(-127, 128, size=(8, N)).astype(np.int32)
    ahat = rng.integers(-(prime // 2), prime // 2 + 1, size=(8, N)).astype(
        np.int32)
    digits = rng.integers(-127, 128, size=(4, 2, N)).astype(np.int32)
    khat = np.stack([ntt_plan.neg_fwd(k, plan) for k in rng.integers(
        -127, 128, size=(4, N))])
    khat = np.broadcast_to(khat[:, None], (4, 2, N)).astype(np.int32)
    acc = sum(ntt_plan._center(ntt_plan.neg_fwd(digits[i], plan) * khat[i],
                               prime) for i in range(4))
    poly_want = {"fwd": ntt_plan.neg_fwd(x, plan),
                 "inv": ntt_plan.neg_inv(ahat, plan),
                 "ext": ntt_plan.neg_inv(ntt_plan._center(acc, prime), plan)}

    workdir = os.path.join(ROOT, "fhestring_tpu_torch", "build", "smoke22")
    os.makedirs(workdir, exist_ok=True)
    paths = {name: os.path.join(workdir, f"{name}.npz")
             for name in ("prod", "turbo")}

    def pbs_call(fn, ct, source, **mode):
        return (fn, (paths[source], torus.to_numpy(ct),
                     np.zeros(len(ct), np.int64), [TABLE]), mode)

    def poly_call(fn, *arrays):
        return (dryrun.poly_sharded, (fn,) + arrays,
                dict(n_poly=N, prime=prime))

    calls = {"turbo": pbs_call(dryrun.batch_sharded, tcts, "turbo"),
             "prod": pbs_call(dryrun.batch_sharded, cts, "prod", **prod),
             "fwd": poly_call(parallel.ntt_fwd_poly_sharded, x),
             "inv": poly_call(parallel.ntt_inv_poly_sharded, ahat),
             "ext": poly_call(parallel.ext_group_poly_sharded, digits, khat),
             "keysharded": pbs_call(dryrun.key_sharded, kcts, "prod")}
    launches = {"turbo": {"blind_rotate32": 1},
                "prod": {"blind_rotate64": 1},
                "keysharded": {"rotate_decompose": n, "ext_product": n}}
    try:
        for name, (P, keys_) in (("prod", (PARAM_PROD, dkeys)),
                                 ("turbo", (PARAM_TURBO, tkeys))):
            serialize.save_packed_server_key(paths[name], ServerKey(keys_, P))
        for world, backend in ((2, "gloo"), (1, "nccl")):
            t0 = time.perf_counter()
            recs = parallel.run_ranks(world, dryrun.in_turn,
                                      list(calls.values()), backend=backend,
                                      device="cuda", timeout=RANKS_TIMEOUT)
            wall = time.perf_counter() - t0
            for rank, rec in enumerate(recs):
                got = dict(zip(calls, rec))
                for name in ("turbo", "prod", "keysharded"):
                    want = torus.to_numpy(single[name][1])
                    if not np.array_equal(got[name]["out"], want):
                        fail(f"{name} sharded over {world} {backend} ranks "
                             f"differs from one process (rank {rank})")
                    every = dict.fromkeys(got[name]["launches"], 0)
                    every.update(launches[name])
                    if got[name]["launches"] != every:
                        fail(f"{name} on rank {rank}: launches "
                             f"{got[name]['launches']}, expected {every}")
                for name, want in poly_want.items():
                    if not np.array_equal(got[name]["out"], want):
                        fail(f"ntt {name} sharded over {world} {backend} "
                             f"ranks differs from the numpy plan")
            got = dict(zip(calls, recs[0]))
            held = got["keysharded"]["bytes"]
            whole = got["keysharded"]["unsharded_bytes"]
            step_ms = got["keysharded"]["seconds"] * 1e3 / n
            parts = {k: v * 1e3 / n
                     for k, v in got["keysharded"]["step_parts"].items()}
            print(f"phase {phase} sharded ({world} {backend} rank"
                  f"{'s' if world > 1 else ''} on the card, {wall:.1f} s "
                  f"with start-up, staged through the host by the port: "
                  f"none): every rank bit-identical to one process; (a) "
                  f"B={SHARD_B} turbo {got['turbo']['seconds'] * 1e3:.1f} ms "
                  f"(one process {single['turbo'][0]:.1f} ms), PARAM_PROD "
                  f"rounded + approx {got['prod']['seconds'] * 1e3:.1f} ms "
                  f"({single['prod'][0]:.1f} ms), one K1 / K2 launch a rank; "
                  f"(b) key-sharded B={KEYSHARD_B} exact "
                  f"{got['keysharded']['seconds'] * 1e3:.1f} ms (one process "
                  f"K5 + K3 graph {single['keysharded'][0]:.1f} ms), {n} K5 "
                  f"and {n} K3 launches a rank; a rank holds KSK "
                  f"{held['ksk'] / 2**20:.1f} of {whole['ksk'] / 2**20:.1f} "
                  f"MiB and BSK limbs {held['bsk'] / 2**20:.1f} of "
                  f"{whole['bsk'] / 2**20:.1f} MiB; a step {step_ms:.4f} ms;"
                  f" a step synchronised after each part, rank 0: "
                  f"{sum(parts.values()):.4f} ms = K5 + K3 "
                  f"{parts['kernels']:.4f} ms + all_gather "
                  f"{parts['all_gather']:.4f} ms + add {parts['add']:.4f} ms"
                  f" (K5 + K3 on a column alone: {kernels_ms:.4f} ms device "
                  f"time); (d) N={N} mod {prime}: fwd "
                  f"{got['fwd']['seconds'] * 1e3:.1f} ms, inv "
                  f"{got['inv']['seconds'] * 1e3:.1f} ms, ext_group (4 rows) "
                  f"{got['ext']['seconds'] * 1e3:.1f} ms, equal to the numpy "
                  f"plan; {CARD}")
        t0 = time.perf_counter()
        recs = parallel.run_ranks(
            2, dryrun.dryrun_multichip, PARAM_PROD, S, PAT,
            os.path.join(workdir, "dryrun.npz"), False, backend="gloo",
            device="cuda", timeout=RANKS_TIMEOUT)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir)
    stages = recs[0]
    if stages["contains"]["pbs"] != PROD_COUNTS["Contains"]:
        fail(f"lane-sharded Contains counts {stages['contains']['pbs']}, "
             f"table {PROD_COUNTS['Contains']}")
    for rank in recs:
        for stage, rec in rank.items():
            if rec and rec["pbs"] != stages[stage]["pbs"]:
                fail(f"dry run {stage}: the ranks counted differently")
    print(f"phase {phase} dry run (2 gloo ranks, PARAM_PROD, {wall:.1f} s "
          f"with start-up): lane-sharded Contains({S!r}, {PAT!r}) = "
          f"{stages['contains']['result']} in "
          f"{stages['contains']['seconds']:.2f} s, pbs "
          f"{stages['contains']['pbs']}; query-sharded split + trim of "
          f"{stages['split_trim']['queries']} on \" \" in "
          f"{stages['split_trim']['seconds']:.2f} s, pbs "
          f"{stages['split_trim']['pbs']} a rank; key-sharded PBS B=16 "
          f"bit-identical to pbs_batch in "
          f"{stages['keysharded']['seconds']:.2f} s; lane-sharded "
          f"split gives {stages['lane_split']['words']} in "
          f"{stages['lane_split']['seconds']:.2f} s, pbs "
          f"{stages['lane_split']['pbs']} (Split's row of PROD_COUNTS "
          f"{PROD_COUNTS['Split']}); all decrypt to Python's answers; "
          f"{CARD}")
    return shard_ms, full_ms


def noise_on_the_card(client, dkeys, phase):
    """NOISE_SAMPLES PARAM_PROD bootstraps in the served mode (K2 rounded
    + approx) through the identity-on-message LUT, and the worst designed
    pack (4x + y of two outputs) bootstrapped again: zero decode failures;
    the fresh outputs' noise sigma and half a slot over it (above 7.04, a
    2^-40 two-sided tail), and the pack's.  The counterpart on the card of
    benchmarks/calibration_prod_r5.log."""
    import numpy as np
    import torch

    from fhestring_tpu_torch import torus
    from fhestring_tpu_torch.crypto import keys, pbs
    from fhestring_tpu_torch.numpy_ref import core as ref

    p, dev = client.params, client.device
    table = list(range(4)) * 4
    bank = keys.pack_luts([table], p, dev)
    sk = client.secret.big_lwe_sk.astype(np.uint64)

    def errors(cts, expected):
        phase_ = cts[:, -1] - (cts[:, :-1] * sk).sum(axis=1, dtype=np.uint64)
        err = (phase_ - expected.astype(np.uint64) * np.uint64(p.delta))
        err = err.view(np.int64).astype(np.float64) / 2.0 ** 64
        return err

    def decode(cts):
        phase_ = cts[:, -1] - (cts[:, :-1] * sk).sum(axis=1, dtype=np.uint64)
        return (((phase_ + np.uint64(p.delta // 2)) // np.uint64(p.delta))
                % np.uint64(p.full_space)).astype(np.int64)

    rng = np.random.default_rng(17)
    B = 2048
    failures, fresh, packs = 0, [], []
    t0 = time.perf_counter()
    device_s = 0.0
    for _ in range(NOISE_SAMPLES // B):
        msgs = rng.integers(0, 4, size=B)
        cts = np.stack([ref.shortint_encrypt(client.secret, int(m),
                                             client._rng) for m in msgs])
        idx = torch.zeros(B, dtype=torch.int64, device=dev)
        ms, out = cuda_ms(lambda: pbs.pbs_batch(
            torus.from_numpy(cts, dev), idx, bank, dkeys, rounded=True,
            approx=True))
        device_s += ms / 1e3
        host = torus.to_numpy(out)
        exp = np.array([table[m] for m in msgs])
        failures += int((decode(host) != exp).sum())
        fresh.append(errors(host, exp))
        half = B // 2
        packed = np.uint64(4) * host[:half] + host[half:]
        pexp = (4 * exp[:half] + exp[half:]) % 16
        packs.append(errors(packed, pexp))
        ms, out2 = cuda_ms(lambda: pbs.pbs_batch(
            torus.from_numpy(packed, dev), idx[:half], bank, dkeys,
            rounded=True, approx=True))
        device_s += ms / 1e3
        exp2 = np.array([table[v] for v in pexp])
        failures += int((decode(torus.to_numpy(out2)) != exp2).sum())
    sigma = float(np.std(np.concatenate(fresh)))
    sigma_pack = float(np.std(np.concatenate(packs)))
    half_slot = 1.0 / (2 * p.full_space)
    if failures:
        fail(f"{failures} decode failures in {NOISE_SAMPLES} bootstraps and "
             f"{NOISE_SAMPLES // 2} packs")
    if not sigma > 0 or half_slot / sigma <= 7.04:
        fail(f"noise sigma {sigma} against half a slot {half_slot}")
    print(f"phase {phase} noise: {NOISE_SAMPLES} PARAM_PROD bootstraps "
          f"(rounded + approx, B={B}) and {NOISE_SAMPLES // 2} of their 4x + "
          f"y packs bootstrapped again: 0 decode failures; sigma fresh "
          f"{sigma:.6e} (2^{np.log2(sigma):.3f}), half a slot / sigma "
          f"{half_slot / sigma:.1f}; sigma of the pack {sigma_pack:.6e}, "
          f"half a slot / sigma {half_slot / sigma_pack:.1f} (pack / fresh "
          f"{(sigma_pack / sigma) ** 2:.2f} units); "
          f"{time.perf_counter() - t0:.1f} s, {device_s:.2f} s of it in "
          f"pbs_batch; {CARD}")


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
    from fhestring_tpu_torch.crypto.kernels import ext_product as ep
    from fhestring_tpu_torch.crypto.kernels import ntt_ext as ne
    from fhestring_tpu_torch.crypto.kernels import rotate_decompose as rd

    dev = torch.device("cuda")

    # 1. device ---------------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"phase 1 device: {name} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    global CARD
    CARD = smi.splitlines()[0]
    print(CARD)

    # 2. kernel builds, in parallel -------------------------------------------
    t0 = time.perf_counter()
    paths = cuda_build.build(*cuda_build.sources())
    t_build = time.perf_counter() - t0
    for module in (br, br64, rd, ep, ne):
        module.build()
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
    ms32, plain_ms32, err32 = rotation_bodies(
        br.blind_rotate32, br.blind_rotate32_plain, acc, amt, khat, 4,
        "turbo")

    def acc32(g, b):
        return torch.randint(-2**31, 2**31, (b, 2, N), dtype=torch.int32,
                             generator=g)

    rotation_sweep(br.blind_rotate32, br.blind_rotate32_plain, acc32, khat, 4,
                   "turbo")
    bound32 = bound(B4 * n * ntt_instructions(N, 28, 2 * 48),
                    tensor_bytes(acc, acc, amt, khat))

    bank = pbs_known_lut(client, dkeys, 5)
    launches32, = requests(client, server, [(br.blind_rotate32, 1)],
                           TURBO_COUNTS, 6)
    throughput(client, dkeys, bank, br.blind_rotate32,
               br.blind_rotate32_plain, acc32, khat, 7)
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
    ms64, plain_ms64, err64 = rotation_bodies(
        br64.blind_rotate64, br64.blind_rotate64_plain, acc, amt, khat, 9,
        "production", **prod)
    rotation_bodies(br64.blind_rotate64, br64.blind_rotate64_plain, acc, amt,
                    khat, 9, "exact")

    def acc64(g, b):
        return torch.randint(-2**63, 2**63 - 1, (b, 2, N), dtype=torch.int64,
                             generator=g)

    rotation_sweep(br64.blind_rotate64, br64.blind_rotate64_plain, acc64,
                   khat, 9, "production", **prod)
    # production mode: 32 transforms, 15 (la, lb) pairs x 4 (r, col) products
    bound64 = bound(B4 * n * ntt_instructions(N, 32, 2 * 60),
                    tensor_bytes(acc, acc, amt, khat))

    bank = pbs_known_lut(client, dkeys, 10, **prod)
    launches64, = requests(client, server, [(br64.blind_rotate64, 1)],
                           PROD_COUNTS, 11)
    throughput(client, dkeys, bank, br64.blind_rotate64,
               br64.blind_rotate64_plain, acc64, khat, 12, **prod)

    # -- PARAM_PROD, the step-wise route: K5, then K3 or K4, per step ------
    step = stepwise_kernels(dkeys, 13)
    stepwise_batches(dkeys, 13)
    k4_launches = stepwise_pbs(client, dkeys, bank, 14)
    stepwise_graph(dkeys, 14)
    server_nk = client.get_server_key(with_ntt2=False)
    if server_nk.backend.sc.keys.bsk_ntt64 is not None:
        fail("get_server_key(with_ntt2=False) packed the NTT key")
    from fhestring_tpu_torch.crypto import pbs
    spans = []
    with timed_replays(spans):
        k5_launches, k3_launches, _ = requests(
            client, server_nk, [(rd.rotate_diff_decompose, n),
                                (ep.ext_product, n), (br64.blind_rotate64, 0)],
            PROD_COUNTS, 15, spans)
    del client, server, server_nk, dkeys, khat, bank
    pbs._STEP_GRAPHS.clear()
    torch.cuda.empty_cache()

    # -- the ported CLI, all 52 method variants, on the card ------------------
    cli_on_the_card("turbo", TURBO_COUNTS, 17)
    cli_on_the_card("prod", PROD_COUNTS, 18)

    # -- persistence, the service and the 32-bit limb route, on the card --
    import shutil

    from fhestring_tpu_torch.client import ClientKey

    workdir = os.path.join(ROOT, "fhestring_tpu_torch", "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        turbo = ClientKey(PARAM_TURBO, seed=0, device=dev)
        persistence(turbo, "turbo", True, workdir, 19)
        client = ClientKey(PARAM_PROD, seed=0, device=dev)
        server = persistence(client, "prod", True, workdir, 19)
        persistence(client, "prod-no-ntt", False, workdir, 19)
    finally:
        shutil.rmtree(workdir)
    served_over_tcp(client, server, [(br64.blind_rotate64, 1)], 20)

    server_nk32 = turbo.get_server_key(with_ntt2=False)
    limb_route32_kernels(server_nk32.backend.sc.keys, 21)
    n32 = PARAM_TURBO.lwe_dimension * PARAM_TURBO.pbs_level
    with timed_replays(spans):
        requests(turbo, server_nk32, [(ep.ext_product, n32),
                                      (rd.rotate_diff_decompose, 0),
                                      (br.blind_rotate32, 0)], TURBO_COUNTS,
                 21, spans)
    del server_nk32
    pbs._STEP_GRAPHS.clear()
    torch.cuda.empty_cache()

    # -- parallel.py: sharded over ranks on the card; the noise margin ----
    tserver = turbo.get_server_key()
    sharded_on_the_card(client, turbo, server.backend.sc.keys,
                        tserver.backend.sc.keys, 22)
    del tserver
    noise_on_the_card(client, server.backend.sc.keys, 23)
    del turbo, client, server
    pbs._STEP_GRAPHS.clear()
    torch.cuda.empty_cache()

    # One step at the batch of phase 13: K3 and K4 compute the same function
    # (the exact mode's 44 transforms, 21 (la, lb) pairs x 4 (r, col)
    # products), so K3's bound is K4's operations over its own bytes.
    Bs = 8
    digits, ext = 3 * Bs * 2 * N, Bs * 2 * N * 8
    product_ops = Bs * ntt_instructions(N, 44, 2 * 84)
    step_bound = {
        "rotate_decompose": bound(Bs * 2 * N * DIGIT_OPS,
                                  ext + 4 * Bs + digits),
        "ext_product": bound(product_ops, digits + 2 * 2 * 8 * N + ext),
        "ntt_ext": bound(product_ops, digits + 2 * 2 * 2 * 16 * N * 2 + ext)}

    def row(name, replaces, launches, err, ms, plain_ms, bound_):
        return {"name": name, "route": "cuda",
                "source": f"fhestring_tpu_torch/csrc/{name}.cu",
                "replaces": f"fhestring_tpu/crypto/kernels/{replaces}",
                "launches": launches, "max_abs_err": err,
                "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                "bound_ms": round(bound_[0], 6), "bound_by": bound_[1],
                "library_ms": None}

    def stepwise_row(name, line, launches):
        return row(name, f"{name}.py:{line}", launches, *step[name],
                   step_bound[name])

    print(json.dumps({"kernels": [
        row("blind_rotate32", "blind_rotate_fused32.py:399", launches32,
            err32, ms32, plain_ms32, bound32),
        row("blind_rotate64", "blind_rotate_fused.py:348", launches64, err64,
            ms64, plain_ms64, bound64),
        stepwise_row("rotate_decompose", 106, k5_launches),
        stepwise_row("ext_product", 186, k3_launches),
        stepwise_row("ntt_ext", 408, k4_launches)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
