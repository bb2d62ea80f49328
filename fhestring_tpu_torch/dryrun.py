"""The multi-process dry run of the port, and the rank functions that drive
``parallel.py``.

The twin of the JAX package's ``__graft_entry__.dryrun_multichip``, over
``torch.distributed`` ranks in place of a device mesh.  Its four stages, on
every rank of the group (SPMD):

1. a lane-sharded ``contains``: the string replicated, every bootstrap's
   batch sharded over the ranks (``parallel.lane_sharded``);
2. a query-sharded split + trim: one query a rank, no collective but the
   gather of the results;
3. a key-sharded PBS (``parallel.pbs_batch_keysharded`` on a group of
   k+1 ranks), bit-identical to ``pbs_batch``'s exact mode;
4. a lane-sharded split.

The JAX function puts stage 4 behind a switch for its XLA compile; the
port compiles nothing and always runs it.  Rank 0 is the client: it makes
the keys from the seed, packs the server key and saves it with
``serialize`` (where a path is given; the other ranks load it), encrypts
the inputs (``parallel.replicate`` hands them to every rank) and decrypts
and checks the results.  Any failed check raises.  Usage:

    python -m fhestring_tpu_torch.dryrun --world 2 --device cuda \\
        --backend gloo

(``--device cpu`` runs the kernels' plain versions; NCCL needs one card a
rank.)  ``batch_sharded``, ``key_sharded``, ``poly_sharded`` and
``lane_sharded_contains`` run one of ``parallel.py``'s calls on numpy
inputs and return its output, time and kernel launches, and ``in_turn``
runs several in one spawn: the rank functions of the tests and of
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import metrics, parallel, shortint, torus
from .client import ClientKey
from .crypto import keys as K
from .crypto import pbs
from .crypto.kernels import blind_rotate32 as br
from .crypto.kernels import blind_rotate64 as br64
from .crypto.kernels import ext_product as ep
from .crypto.kernels import rotate_decompose as rd
from .numpy_ref import core as ref
from .params import PARAM_TEST_ZERO_NOISE, CryptoParams

KERNELS = {"blind_rotate32": br.blind_rotate32,
           "blind_rotate64": br64.blind_rotate64,
           "rotate_decompose": rd.rotate_diff_decompose,
           "ext_product": ep.ext_product}
KEY_STAGE_TABLE = [(3 * m + 1) % 16 for m in range(16)]
KEY_STAGE_B = 16
RANKS_TIMEOUT = 900.0  # seconds the command line's ranks may take


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


@contextlib.contextmanager
def _measured(group, device, record: dict):
    """Times the block (synchronised, after a barrier of the group) and
    counts the kernels' launches and the bootstraps in it into
    ``record``.  group None: no barrier."""
    if group is not None:
        dist.barrier(group=group)
    _sync(device)
    before = _launches()
    metrics.reset()
    t0 = time.perf_counter()
    yield
    _sync(device)
    record["seconds"] = time.perf_counter() - t0
    record["launches"] = {k: v - before[k] for k, v in _launches().items()}
    record["pbs"] = (metrics.GLOBAL.pbs_items, metrics.GLOBAL.pbs_calls)


@contextlib.contextmanager
def identity_bootstrap():
    """Every ``pbs_batch`` of the engine, sharded or not, replaced by the
    identity on the batch.  The engine never branches on ciphertext
    values, so its batches, counts and collectives are those of a real run
    at no bootstrap's cost; the outputs do not decrypt."""
    real = shortint.pbs_batch, pbs.pbs_batch
    shortint.pbs_batch = pbs.pbs_batch = (
        lambda flat, idx, bank, keys, **mode: flat)
    try:
        yield
    finally:
        shortint.pbs_batch, pbs.pbs_batch = real


# ---------------------------------------------------------------------------
# Keys and inputs
# ---------------------------------------------------------------------------

def load_keys(group, device, params: CryptoParams, seed: int = 0,
              path: str | None = None):
    """(ClientKey on rank 0 or None, ServerKey) on this rank.  Rank 0 makes
    a ``ClientKey(params, seed)`` and packs its server key, and, with
    ``path``, saves it there with ``serialize`` for the other ranks to
    load; without a path every rank makes the same keys from the seed."""
    from . import serialize

    rank = dist.get_rank(group)
    if rank == 0 or path is None:
        ck = ClientKey(params, seed, device=device)
        server = ck.get_server_key()
        if path is not None:
            serialize.save_packed_server_key(path, server)
    dist.barrier(group=group)
    if rank != 0 and path is not None:
        ck, server = None, serialize.load_packed_server_key(
            path, device=device)
    return (ck if rank == 0 else None), server


def _replicated(group, device, make, shape):
    """``make()`` on rank 0 (a tensor of ``shape``), zeros of that shape
    elsewhere, then rank 0's on every rank."""
    if dist.get_rank(group) == 0:
        value = make().to(device)
    else:
        value = torch.zeros(shape, dtype=torch.int64, device=device)
    return parallel.replicate(group, value)


def _string(ck, server, group, device, text: str, padding: int):
    """An FheString of ``text`` + padding NULs, encrypted on rank 0 and
    replicated."""
    from .ciphertext import FheString
    from .shortint import Blocks

    p = server.params
    shape = (len(text) + padding, 4, p.big_lwe_dimension + 1)
    ct = _replicated(group, device,
                     lambda: ck.encrypt(text, padding).blocks.ct, shape)
    return FheString(Blocks(ct, 3, 1.0))


# ---------------------------------------------------------------------------
# The four stages
# ---------------------------------------------------------------------------

def stage_contains(ck, server, group, device, text: str, pattern: str,
                   padding: int) -> dict:
    """Lane-sharded contains (``server.contains``, as a request calls it)
    of ``text`` + ``padding`` NULs, decrypted on rank 0 and held to
    Python's answer."""
    s = _string(ck, server, group, device, text, padding)
    pat = _string(ck, server, group, device, pattern, 0)
    rec = {"padding": padding}
    with _measured(group, device, rec), parallel.lane_sharded(server,
                                                         group):
        out = server.contains(s, pat)
    if ck is not None:
        rec["result"] = got = ck.decrypt_char(out)
        if got != int(pattern in text):
            raise AssertionError(f"contains({text!r}, {pattern!r}) "
                                 f"decrypts to {got}")
    return rec


def stage_split_trim(ck, server, group, device, identity: bool = False
                     ) -> dict:
    """Query-sharded split + trim: query r, "a<r> b<r>", on rank r; the
    results gathered to rank 0, which decrypts them, or with ``identity``
    (``identity_bootstrap``) holds each query's gathered bits and counts
    equal to its own run of that query, and decrypts nothing."""
    from .ciphertext import FheSplit, FheString

    world = dist.get_world_size(group)
    texts = [f"a{i % 10} b{i % 10}" for i in range(world)]
    p = server.params
    shape = (world, len(texts[0]) + 1, 4, p.big_lwe_dimension + 1)
    queries = _replicated(group, device, lambda: torch.stack(
        [ck.encrypt(t, 1).blocks.ct for t in texts]), shape)
    space = _string(ck, server, group, device, " ", 0)

    def run(query):
        q = FheString(shortint.Blocks(query, 3, 1.0))
        split = server.split(q, space)
        return (split, server.trim(q))

    rec = {"queries": texts}
    with contextlib.ExitStack() as stack:
        if identity:
            stack.enter_context(identity_bootstrap())
        with _measured(group, device, rec):
            split, trimmed = run(parallel.shard_string(group, queries)[0])
        grids = parallel.all_gather(split.buffers.ct, group)
        found = parallel.all_gather(split.pattern_found.blocks.ct, group)
        trims = parallel.all_gather(trimmed.blocks.ct, group)
        if identity and ck is not None:
            for i in range(world):
                alone = {}
                with _measured(None, device, alone):
                    want_split, want_trim = run(queries[i])
                if not (torch.equal(want_split.buffers.ct, grids[i])
                        and torch.equal(want_split.pattern_found.blocks.ct,
                                        found[i])
                        and torch.equal(want_trim.blocks.ct, trims[i])
                        and alone["pbs"] == rec["pbs"]):
                    raise AssertionError(f"query {i}: the gathered split + "
                                         f"trim differs from one rank's")
            return rec
    if ck is not None and not identity:
        for i, t in enumerate(texts):
            found_i = dataclasses.replace(
                split.pattern_found, blocks=dataclasses.replace(
                    split.pattern_found.blocks, ct=found[i]))
            parts, hit = ck.decrypt_split(FheSplit(
                dataclasses.replace(split.buffers, ct=grids[i]), found_i))
            words = [w for w in parts if w]
            if words != t.split(" ") or hit != 1:
                raise AssertionError(f"query {i} {t!r}: split gives "
                                     f"{words}, found {hit}")
            got = ck.decrypt(FheString(dataclasses.replace(
                trimmed.blocks, ct=trims[i])))
            if got != t.strip():
                raise AssertionError(f"query {i}: trim gives {got!r}")
    return rec


def stage_keysharded(ck, server, group, device) -> dict:
    """Key-sharded PBS on a group of the first k+1 ranks: bit-identical to
    one process's ``pbs_batch`` in the exact mode.  Ranks outside the
    group only join the group's creation."""
    p = server.params
    kgroup = parallel.make_group(p.glwe_dimension + 1)
    rec = {}
    if kgroup == dist.GroupMember.NON_GROUP_MEMBER:
        return rec
    dkeys = server.backend.sc.keys
    bank = K.pack_luts([KEY_STAGE_TABLE], p, device)
    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 16, size=KEY_STAGE_B)

    def encrypt():
        return torus.from_numpy(np.stack(
            [ref.shortint_encrypt(ck.secret, int(m), ck._rng) for m in msgs]))

    cts = _replicated(kgroup, device, encrypt,
                      (KEY_STAGE_B, p.big_lwe_dimension + 1))
    idx = torch.zeros(KEY_STAGE_B, dtype=torch.int64, device=device)
    shard = parallel.shard_keys(dkeys, kgroup)
    with _measured(kgroup, device, rec):
        got = parallel.pbs_batch_keysharded(cts, idx, bank, shard, kgroup)
    want = pbs.pbs_batch(cts, idx, bank, dkeys)
    if not torch.equal(got, want):
        raise AssertionError("the key-sharded PBS differs from pbs_batch")
    if ck is not None:
        out = torus.to_numpy(got)
        bad = sum(ref.shortint_decrypt(ck.secret, out[i])
                  != KEY_STAGE_TABLE[m] for i, m in enumerate(msgs))
        if bad:
            raise AssertionError(f"{bad} key-sharded outputs decrypt wrong")
    rec["bytes"] = shard.nbytes()
    return rec


def stage_lane_split(ck, server, group, device, text: str, pattern: str,
                     identity: bool = False) -> dict:
    """Lane-sharded split: with ``identity`` (``identity_bootstrap``) the
    sharded run and one rank's unsharded run are held equal bit for bit
    and in counts, and nothing is decrypted."""
    from .ciphertext import FheSplit

    world = dist.get_world_size(group)
    pad = (-len(text) - 1) % world + 1
    s = _string(ck, server, group, device, text, pad)
    pat = _string(ck, server, group, device, pattern, 0)
    rec = {"padding": pad}
    with contextlib.ExitStack() as stack:
        if identity:
            stack.enter_context(identity_bootstrap())
        with _measured(group, device, rec), \
                parallel.lane_sharded(server, group):
            split = server.split(s, pat)
        if identity:
            alone = {}
            with _measured(None, device, alone):
                want = server.split(s, pat)
            same = (torch.equal(want.buffers.ct, split.buffers.ct)
                    and torch.equal(want.pattern_found.blocks.ct,
                                    split.pattern_found.blocks.ct))
            if not same or alone["pbs"] != rec["pbs"]:
                raise AssertionError(
                    f"the lane-sharded split differs from one rank's: "
                    f"bits equal {same}, counts {rec['pbs']} against "
                    f"{alone['pbs']}")
            rec["buffers"] = torus.to_numpy(split.buffers.ct)
            return rec
    if ck is not None:
        parts, _ = ck.decrypt_split(FheSplit(split.buffers,
                                             split.pattern_found))
        words = [w for w in parts if w]
        if words != [w for w in text.split(pattern) if w]:
            raise AssertionError(f"split({text!r}, {pattern!r}) gives "
                                 f"{words}")
        rec["words"] = words
    return rec


def dryrun_multichip(group, device,
                     params: CryptoParams = PARAM_TEST_ZERO_NOISE,
                     text: str | None = None, pattern: str | None = None,
                     key_path: str | None = None,
                     identity_splits: bool = False) -> dict:
    """The four stages on this rank (a rank function for
    ``parallel.run_ranks``).  text and pattern: the contains stage's and
    the lane-sharded split's (default: the JAX dry run's, "ab" x world
    with "b", and "a b " repeated with " ").  identity_splits: the two
    split stages run with ``identity_bootstrap`` and are held to one
    rank's run, bit for bit and in counts (a real split costs thousands of
    bootstraps, minutes on a CPU).  Returns each stage's record: seconds,
    kernel launches, (PBS items, batches) and, on rank 0, what it
    decrypted."""
    world = dist.get_world_size(group)
    ck, server = load_keys(group, device, params, 0, key_path)
    text_c = text or "ab" * world
    # NULs up to the next multiple of the group's size, at least one, as
    # the JAX dry run pads
    pad = world - len(text_c) % world if len(text_c) % world else world
    out = {}
    out["contains"] = stage_contains(ck, server, group, device, text_c,
                                     pattern or "b", pad)
    out["split_trim"] = stage_split_trim(ck, server, group, device,
                                         identity_splits)
    out["keysharded"] = stage_keysharded(ck, server, group, device)
    out["lane_split"] = stage_lane_split(
        ck, server, group, device, text or "a b " * (max(world, 4) // 2),
        pattern or " ", identity=identity_splits)
    return out


# ---------------------------------------------------------------------------
# Rank functions of parallel.py's calls on numpy inputs
# ---------------------------------------------------------------------------

def _timed(group, device, fn, *args, **kwargs) -> dict:
    """``fn(*args, group=group, **kwargs)`` twice (the first loads the
    kernels and builds the constants), the second measured: its record
    (``_measured``) with the result in "out"."""
    fn(*args, group=group, **kwargs)
    rec = {}
    with _measured(group, device, rec):
        rec["out"] = fn(*args, group=group, **kwargs)
    return rec


def _pbs_inputs(device, key_path: str, ct: np.ndarray, lut_idx: np.ndarray,
                tables: list):
    """The packed server key saved at key_path, ct (uint64) and lut_idx as
    tensors, and tables packed as the LUT bank, on the device."""
    from . import serialize

    server = serialize.load_packed_server_key(key_path, device=device)
    bank = K.pack_luts(tables, server.params, device)
    return (server, torus.from_numpy(ct, device),
            torch.from_numpy(lut_idx).to(device), bank)


def batch_sharded(group, device, key_path: str, ct: np.ndarray,
                  lut_idx: np.ndarray, tables: list, rounded: bool = False,
                  approx: bool = False) -> dict:
    """``parallel.pbs_batch_sharded`` in that mode, the whole batch's
    result as uint64 numpy in "out"."""
    server, ct, idx, bank = _pbs_inputs(device, key_path, ct, lut_idx, tables)
    rec = _timed(group, device, parallel.pbs_batch_sharded, ct, idx, bank,
                 server.backend.sc.keys, rounded=rounded, approx=approx)
    rec["out"] = torus.to_numpy(rec["out"])
    return rec


def key_sharded(group, device, key_path: str, ct: np.ndarray,
                lut_idx: np.ndarray, tables: list) -> dict:
    """``parallel.pbs_batch_keysharded``: the rank keeps only its
    ``KeyShard`` of the loaded keys while it runs.  The record adds the
    "bytes" of the shard, the "unsharded_bytes" of the keys, and
    "step_parts": the seconds of a further, synchronised run by part
    (``pbs_batch_keysharded``'s ``times``)."""
    server, ct, idx, bank = _pbs_inputs(device, key_path, ct, lut_idx, tables)
    dkeys = server.backend.sc.keys
    shard = parallel.shard_keys(dkeys, group)
    whole = {"ksk": dkeys.ksk_limbs.numel(), "bsk": dkeys.bsk_limbs.numel()}
    del server, dkeys
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec = _timed(group, device, parallel.pbs_batch_keysharded, ct, idx, bank,
                 shard)
    rec["out"] = torus.to_numpy(rec["out"])
    rec["bytes"], rec["unsharded_bytes"] = shard.nbytes(), whole
    rec["step_parts"] = {}
    parallel.pbs_batch_keysharded(ct, idx, bank, shard, group,
                                  times=rec["step_parts"])
    return rec


def poly_sharded(group, device, fn, *arrays: np.ndarray, n_poly: int,
                 prime: int) -> dict:
    """One of ``parallel``'s polynomial-sharded functions (``fn``) on the
    arrays as tensors; the result as int64 numpy in "out"."""
    tensors = [torch.from_numpy(a).to(device) for a in arrays]
    rec = _timed(group, device, fn, *tensors, n_poly, prime)
    rec["out"] = rec["out"].cpu().numpy()
    return rec


def lane_sharded_contains(group, device, params: CryptoParams, seed: int,
                          text: str, pattern: str, padding: int) -> dict:
    """``stage_contains`` with every rank's keys made from the seed."""
    ck, server = load_keys(group, device, params, seed)
    return stage_contains(ck, server, group, device, text, pattern, padding)


def in_turn(group, device, calls: list) -> list:
    """calls: (rank function, positional arguments, keywords) triples, run
    in turn on this rank (a rank function for ``parallel.run_ranks``, so
    that one spawn serves them all); returns their results in order."""
    return [fn(group, device, *args, **kwargs) for fn, args, kwargs in calls]


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device; --device cpu runs on the CPU",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="fhe_dryrun_") as tmp:
        t0 = time.perf_counter()
        recs = parallel.run_ranks(
            args.world, dryrun_multichip, PARAM_TEST_ZERO_NOISE, None, None,
            os.path.join(tmp, "server_key.npz"), backend=args.backend,
            device=args.device, timeout=RANKS_TIMEOUT)
    rec = recs[0]
    chars = 2 * args.world + rec["contains"]["padding"]
    print(f"dryrun_multichip({args.world}, {args.backend}, {args.device}): "
          f"contains over a {chars}-char lane-sharded string OK "
          f"({rec['contains']['seconds']:.2f} s, PBS {rec['contains']['pbs']})")
    print(f"dryrun_multichip({args.world}): split + trim over "
          f"{args.world} query-sharded strings OK "
          f"({rec['split_trim']['seconds']:.2f} s)")
    print(f"dryrun_multichip({args.world}): key-sharded PBS over a "
          f"{PARAM_TEST_ZERO_NOISE.glwe_dimension + 1}-rank group "
          f"bit-identical OK ({rec['keysharded']['seconds']:.2f} s)")
    print(f"dryrun_multichip({args.world}): lane-sharded split OK "
          f"({rec['lane_split']['seconds']:.2f} s, PBS "
          f"{rec['lane_split']['pbs']}); {time.perf_counter() - t0:.1f} s "
          f"in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
