"""One run of one cell of the benchmark of ``fhestring_tpu_torch``.

    python3 -m fhebench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell names
a configuration (a parameter set and how it is served,
``fhebench/configs/<name>.json``) and a traffic mix
(``fhebench/traffic/<name>.json``).  A run makes the keys and every
request's ciphertexts from the seed (``scheme``, ``traffic``), packs the
keys with the program, warms up the cell's own path, then sends requests
for ``--seconds`` from the mix's ``clients`` closed-loop clients (one
where the mix names none; several only over the service, each on a thread
of its own), the window closing at the end of the last request begun
inside it.  Then it decrypts every result, holds each to the plain
reference (``reference``) and prints one JSON line: ``correct``,
``attempted``, ``failed``, the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics (``--trace 1``, from a device trace of the
window), ``device``, and last the numbers compared with their limits.

Metrics are found by name: ``fhebench/end_to_end/<name>.py`` and
``fhebench/layer_metrics/<name>.py`` each define ``read(window)``, which
returns a number or None (nothing to read: the metric is left out).
Each method a mix names is a file, ``fhebench/methods/<name>.py``: what a
request of it sends, how its result decrypts and the reference's answer.

Exit codes: 0 with a result line; 2 without the card(s) the cell asks
for, or where its mix asks for clients it cannot have (before any
set-up); 3 if JAX or the JAX package was loaded.  Nothing is printed to
standard output in either case.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """perf_counter() reading at which this process started (Linux), or
    now where /proc cannot tell."""
    now = time.perf_counter()
    try:
        import os

        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import types  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "fhestring_tpu")


@dataclasses.dataclass
class Done:
    """One request of the window.  With several clients the program's
    counters and the server's method span also hold other requests' work,
    so they are left None: the window's ``totals`` hold the counters."""

    request: int                 # index into the run's requests
    start_ns: int                # perf_counter_ns around the entry's call
    end_ns: int
    method_ns: tuple | None      # the server's method (service, 1 client)
    pbs_calls: int | None
    pbs_items: int | None
    result: object = None
    error: str | None = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Window:
    """What the metric readers read."""

    config: dict
    done: list
    window_s: float
    setup_s: float
    widths: list                 # the width of every PBS batch dispatched
    sm_count: int
    trace: object = None         # trace.Trace of a --trace 1 run
    totals: object = None        # the program's counters over the window
    clients: int = 1             # the mix's concurrent clients

    @property
    def served(self) -> list:
        return [d for d in self.done if d.error is None]

    def latencies_ms(self) -> list:
        return [d.seconds * 1e3 for d in self.done]


def load_reader(root: str, kind: str, name: str):
    """``read`` of ``<root>/<kind>/<name>.py``."""
    path = os.path.join(root, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"fhebench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def load_cell(bench: dict, name: str, base: str, root: str
              ) -> tuple[dict, dict]:
    """(configuration, mix) of the workload ``name``: the
    configuration's file as ``BENCHMARK.json`` names it, relative to
    ``base``; the mix's as ``root/traffic/<name>.json``.  A ValueError
    where the mix asks for clients it cannot have (``traffic.clients``)."""
    from . import traffic

    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(base, entry["file"])) as f:
        config = json.load(f)
    mix = traffic.load(traffic.find(root, cell["traffic"]))
    traffic.clients(mix)
    return config, mix


class TimedKey:
    """The ServerKey the service runs, recording the span of each method
    the server calls (a benchmark-side proxy: the program is unchanged).
    ``last`` is one request's only while one request is in flight."""

    def __init__(self, key, sync):
        self._key, self._sync = key, sync
        self.last = None

    def __getattr__(self, name):
        attr = getattr(self._key, name)
        if name.startswith("_") or not callable(attr):
            return attr

        def timed(*args):
            t0 = time.perf_counter_ns()
            out = attr(*args)
            self._sync()
            self.last = (t0, time.perf_counter_ns())
            return out
        return timed


def serve(config: dict, bsk, ksk, device):
    """The program's ServerKey on the benchmark's raw keys."""
    from fhestring_tpu_torch.crypto.keys import pack_server_keys
    from fhestring_tpu_torch.params import CryptoParams
    from fhestring_tpu_torch.server import ServerKey

    params = CryptoParams(**config["params"])
    keys = pack_server_keys(types.SimpleNamespace(bsk=bsk, ksk=ksk,
                                                  params=params),
                            device, with_ntt2=config["with_ntt2"])
    return ServerKey(keys, params)


def encrypt_inputs(p: dict, secret, requests, mix: dict, g, where,
                   root: str):
    """Per request, the call's arguments, the ciphertexts made in one batch
    on the generator's device and moved to ``where``."""
    import torch

    from fhestring_tpu_torch.ciphertext import FheString
    from fhestring_tpu_torch.shortint import Blocks

    from . import methods, scheme

    pad = b"\0" * mix["padding"]
    kinds = [methods.load(r.method, root) for r in requests]
    each = [methods.encrypted(k, r, pad) for k, r in zip(kinds, requests)]
    flat = [x for xs in each for x in xs]
    data = torch.zeros((len(flat), max(map(len, flat))), dtype=torch.int64)
    for i, x in enumerate(flat):
        data[i, :len(x)] = torch.tensor(list(x), dtype=torch.int64)
    ct = scheme.encrypt_bytes(p, secret, data.to(g.device), g).to(where)
    strings = iter(FheString(Blocks(ct[i, :len(x)], 3, 1.0))
                   for i, x in enumerate(flat))
    return [methods.arguments(k, r, [next(strings) for _ in xs])
            for k, r, xs in zip(kinds, requests, each)]


def result_answer(p: dict, secret, method, res):
    """(decrypted answer in the reference's form, widest noise share of
    what was decrypted), by the method file's ``decode``."""
    from . import scheme

    shares = []

    def decrypt(x):
        data, share = scheme.decrypt_bytes(p, secret,
                                           x.blocks.ct.to(secret.glwe.device))
        shares.append(share)
        return data

    def text(x):
        out = bytearray()
        for byte in decrypt(x).tolist():
            if byte == 0:
                break
            out.append(byte)
        return bytes(out)

    def char(x):
        return int(decrypt(x))

    got = method.decode(res, text, char)
    return got, max(shares)


def check(window: Window, requests, p: dict, secret, limits: dict,
          root: str) -> dict:
    """The numbers compared, each with its value and limit."""
    from . import methods

    wrong, noise = 0, 0.0
    for d in window.done:
        if d.error is not None:
            wrong += 1
            continue
        r = requests[d.request]
        method = methods.load(r.method, root)
        want = method.answer(r.string, r.pattern, r.to)
        got, share = result_answer(p, secret, method, d.result)
        wrong += got != want
        noise = max(noise, share)
    return {"wrong_answers": {"value": wrong, "limit": 0},
            "noise_share": {"value": noise,
                            "limit": limits["noise_share"]}}


class Dealer:
    """Numbers the window's requests in the order the clients send them,
    from 0, one at a time to any number of threads: ``take`` gives None
    once ``deadline_ns`` has passed and ``at_least`` have been sent."""

    def __init__(self, deadline_ns: int, at_least: int):
        self.deadline_ns, self.at_least = deadline_ns, at_least
        self.sent = 0
        self._lock = threading.Lock()

    def take(self) -> int | None:
        with self._lock:
            if (time.perf_counter_ns() >= self.deadline_ns
                    and self.sent >= self.at_least):
                return None
            self.sent += 1
            return self.sent - 1


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        name, limit = out[0].split(", ")
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": "unknown", "power_limit": "unknown"}


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", base: str = ".",
             root: str = HERE, key_hook=None, t_start: float | None = None,
             min_requests: int = 1) -> dict:
    """One run; returns the result line's object.  ``key_hook`` (the
    control's only) changes the raw bootstrap key before the program packs
    it.  ``min_requests`` (the tests' only) keeps the window open until it
    has sent that many requests, however slow the machine.

    The window opens as the clients start and closes at the latest end of
    a request; each client sends until ``seconds`` have passed, and every
    request sent is answered and counted.  One client runs on this thread,
    as a loop; several run on threads of their own, each with its own
    ``RemoteServerKey``, against the one server."""
    import torch

    from fhestring_tpu_torch import metrics

    from . import scheme, traffic
    from .trace import Recorder, summarize

    t_start = T_START if t_start is None else t_start
    config, mix = load_cell(bench, workload, base, root)
    n_clients = traffic.clients(mix)
    one = n_clients == 1
    p = config["params"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    parts = {"imports": time.perf_counter() - t_start}

    def part(name: str) -> None:
        sync()
        parts[name] = time.perf_counter() - t_start - sum(parts.values())

    g = scheme.generator(seed, dev)
    secret, bsk, ksk = scheme.keygen(p, g)
    if key_hook is not None:
        key_hook(bsk, config)
    part("keygen")
    key = serve(config, bsk, ksk, dev)
    del bsk, ksk
    part("pack")
    requests = traffic.make(mix, seed, root)
    service = mix["entry"] == "service"
    args = encrypt_inputs(p, secret, requests, mix, g,
                          torch.device("cpu") if service else dev, root)
    part("inputs")

    widths = []
    record_pbs = metrics.record_pbs

    def counted(n_items, n_padded):
        widths.append(int(n_items))
        record_pbs(n_items, n_padded)
    metrics.record_pbs = counted

    proxy, server, entries = None, None, [key]
    if service:
        from fhestring_tpu_torch.service import FheStringServer, RemoteServerKey

        proxy = TimedKey(key, sync) if one else None
        server = FheStringServer(proxy or key).start()
        entries = [RemoteServerKey(server.address, device="cpu", timeout=300)
                   for _ in range(n_clients)]
    try:
        def call(i: int, entry) -> Done:
            method = requests[i].method
            before = metrics.GLOBAL.snapshot() if one else None
            if proxy is not None:
                proxy.last = None
            t0 = time.perf_counter_ns()
            res, err = None, None
            try:
                res = getattr(entry, method)(*args[i])
                if not service:
                    sync()
            except Exception as e:  # a failed request is counted, not fatal
                err = repr(e)
            t1 = time.perf_counter_ns()
            if not one:
                return Done(i, t0, t1, None, None, None, res, err)
            d = metrics.GLOBAL.delta(before)
            return Done(i, t0, t1, proxy.last if proxy else None,
                        d.pbs_calls, d.pbs_items, res, err)

        for i in warmup_requests(requests):
            call(i, entries[0])
        part("warmup")
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        widths.clear()
        setup_s = time.perf_counter() - t_start

        recorder = Recorder() if trace else None
        sent = {}  # order of sending -> Done
        offset = time.time_ns() - time.perf_counter_ns()
        if recorder is not None:
            recorder.start()
        counters = metrics.GLOBAL.snapshot()
        w0 = time.perf_counter_ns()
        dealer = Dealer(w0 + int(seconds * 1e9), min_requests)

        def client(entry) -> None:
            # the k-th request sent is the deck's (k mod its length)-th
            while (k := dealer.take()) is not None:
                sent[k] = call(k % len(requests), entry)

        if one:
            client(entries[0])
        else:
            with ThreadPoolExecutor(n_clients) as pool:
                list(pool.map(client, entries))
        done = [sent[k] for k in range(len(sent))]
        w1 = max(d.end_ns for d in done)
        totals = metrics.GLOBAL.delta(counters)
        if recorder is not None:
            sync()
            recorder.stop()
    finally:
        metrics.record_pbs = record_pbs
        if server is not None:
            server.stop()

    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    sm_count = (torch.cuda.get_device_properties(dev).multi_processor_count
                if on_card else 0)
    window = Window(config, done, (w1 - w0) / 1e9, setup_s, widths,
                    sm_count, totals=totals, clients=n_clients)
    if recorder is not None:
        window.trace = summarize(recorder.events(), w0 + offset, w1 + offset,
                                 host_spans(window, requests, offset))
        del recorder

    kind = "layer_metrics" if trace else "end_to_end"
    out_metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = load_reader(root, kind, m["name"])(window)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del key, proxy
    if on_card:
        torch.cuda.empty_cache()
    checks = check(window, requests, p, secret, config["checks"], root)
    correct = (bool(done) and all(v["value"] <= v["limit"]
                                  for v in checks.values()))
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(done),
           "failed": sum(d.error is not None for d in done),
           "metrics": out_metrics, "device": info}
    if window.trace is not None:
        info["busy_s"] = window.trace.busy_s
        info["window_s"] = window.trace.window_s
        out["breakdown"] = breakdown(window.trace)
    out["setup_parts_s"] = parts
    out["card"] = card() if on_card else {}
    out["checks"] = checks
    return out


def warmup_requests(requests) -> list[int]:
    """Index of the shortest request of each method: every kernel and
    code path the cell's traffic drives, at the least cost."""
    picks = {}
    for i, r in enumerate(requests):
        if (r.method not in picks
                or len(r.string) < len(requests[picks[r.method]].string)):
            picks[r.method] = i
    return list(picks.values())


def host_spans(window: Window, requests, offset: int) -> list:
    """Sorted, disjoint (start, end, label) of what the host did in each
    request, in the trace's clock: the server's method, and the service's
    way in and out around it.  A request with no span of the server's
    method (in process, or a call that failed) is one stretch, ``method``;
    with several clients, whose server spans are not told apart, one
    stretch ``request``.  Where their requests overlap, each stretch goes
    to the one sent last (``trace.disjoint``)."""
    from .trace import disjoint

    spans = []
    for d in window.done:
        method = requests[d.request].method
        if d.method_ns is None:
            kind = "method" if window.clients == 1 else "request"
            spans.append((d.start_ns, d.end_ns, f"{kind} {method}"))
            continue
        m0, m1 = d.method_ns
        spans += [(d.start_ns, m0, "service, to the server"),
                  (m0, m1, f"method {method}"),
                  (m1, d.end_ns, "service, back to the client")]
    return disjoint([(a + offset, b + offset, label)
                     for a, b, label in spans])


def breakdown(tr) -> dict:
    top = sorted(tr.op_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], s] for name, s in top],
            "idle_gaps": [[label, s] for label, s in gaps]}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    try:
        load_cell(bench, args.workload, ".", HERE)
    except ValueError as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
