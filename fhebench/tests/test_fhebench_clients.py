"""Several concurrent clients of the service: whole runs of a tiny cell on
the CPU with 3 clients, the host spans of overlapping requests, the
dealing of requests to threads, and the committed mixes' requests, which
the key ``clients`` leaves as they were."""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading

import pytest

from fhebench import control, run, scheme, trace, traffic

SEED = 2**31 + 101
DECK = 8  # requests in one deck of the tiny mix: 4 methods, 2 each
CLIENTS = 3
PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_clients(monkeypatch, tiny, cell="tiny64.tiny", **kw):
    """A run that sends one deck from 3 clients, and what it checked:
    (result line, window, the run's dealer)."""
    seen = {}
    real_check, real_dealer = run.check, run.Dealer

    def check(window, *args):
        seen["window"] = window
        return real_check(window, *args)

    def dealer(*args):
        seen["dealer"] = real_dealer(*args)
        return seen["dealer"]
    monkeypatch.setattr(run, "check", check)
    monkeypatch.setattr(run, "Dealer", dealer)
    bench, base, root = tiny
    out = run.run_cell(bench, cell, SEED, 0.0, False, device="cpu",
                       base=base, root=root, min_requests=DECK, **kw)
    return out, seen["window"], seen["dealer"]


def most_in_flight(done) -> int:
    edges = sorted([(d.start_ns, 1) for d in done]
                   + [(d.end_ns, -1) for d in done])
    now = most = 0
    for _, step in edges:
        now += step
        most = max(most, now)
    return most


@pytest.mark.parametrize("cell", ["tiny64.tiny", "tiny32.tiny"])
def test_several_clients_run_correct(monkeypatch, tiny_clients, cell):
    out, window, dealer = run_clients(monkeypatch, tiny_clients, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert out["attempted"] == DECK and out["failed"] == 0
    assert window.clients == CLIENTS
    # each request of the deck sent once, in the order of sending, and
    # checked against its own request
    assert [d.request for d in window.done] == list(range(DECK))
    assert most_in_flight(window.done) == CLIENTS
    # no request is given another's counters or server span
    assert all(d.pbs_calls is None and d.pbs_items is None
               and d.method_ns is None for d in window.done)
    assert window.totals.pbs_calls > 0
    assert window.totals.pbs_items >= window.totals.pbs_calls
    assert len(window.widths) == window.totals.pbs_calls
    # the window opens at the deadline of a 0 s run and closes at the
    # latest end of a request, which need not be the last one sent
    end = max(d.end_ns for d in window.done)
    assert window.window_s == (end - dealer.deadline_ns) / 1e9
    names = set(out["metrics"])
    assert {"setup_s", "latency_p50_ms", "latency_p95_ms",
            "requests_per_s"} <= names


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_every_fault_fails_several_clients(monkeypatch, tiny_clients,
                                           fault):
    with control.FAULTS[fault]():
        out, window, _ = run_clients(monkeypatch, tiny_clients)
    assert out["attempted"] == DECK
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny64.tiny", "tiny32.tiny"])
def test_the_control_fails_several_clients(monkeypatch, tiny_clients, cell):
    sound, _, _ = run_clients(monkeypatch, tiny_clients, cell)
    low, _, _ = run_clients(monkeypatch, tiny_clients, cell,
                            key_hook=control.lower_precision_key)
    assert sound["correct"] and not low["correct"]
    assert (low["checks"]["noise_share"]["value"]
            >= 3 * sound["checks"]["noise_share"]["value"])


def test_several_clients_in_process_are_refused(tmp_path, monkeypatch,
                                                capsys, tiny_bench):
    bench, base, root = tiny_bench
    path = os.path.join(root, "traffic", "tiny.json")
    mix = traffic.load(path)
    assert mix["entry"] == "in_process"
    with open(path, "w") as f:
        json.dump(dict(mix, clients=CLIENTS), f)
    for c in bench["configs"]:
        c["file"] = os.path.join(base, c["file"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    def no_setup(*args):
        raise AssertionError("set-up began")
    monkeypatch.setattr(scheme, "keygen", no_setup)
    with pytest.raises(ValueError, match="service"):
        run.run_cell(bench, "tiny64.tiny", SEED, 0.0, False, device="cpu",
                     base=base, root=root)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run, "HERE", root)
    code = run.main(["--workload", "tiny64.tiny", "--seed", "1",
                     "--seconds", "1"])
    said = capsys.readouterr()
    assert code == 2
    assert said.out == ""
    assert "3 clients need the service entry" in said.err


@pytest.mark.parametrize("clients", [0, -1, 1.5, "2", True])
def test_clients_are_a_whole_number_from_one(clients):
    with pytest.raises(ValueError):
        traffic.clients({"entry": "service", "clients": clients})
    assert traffic.clients({"entry": "in_process"}) == 1
    assert traffic.clients({"entry": "service", "clients": 8}) == 8


S = 1_000_000  # ns of a ms


def overlapping_window() -> tuple[run.Window, list]:
    """Three clients' requests, each over the one before it, and a fourth
    after a gap."""
    requests = [traffic.Request(m, b"ab") for m in ("eq", "len", "find",
                                                   "eq")]
    done = [run.Done(0, 0, 10 * S, None, None, None),
            run.Done(1, 2 * S, 6 * S, None, None, None),
            run.Done(2, 4 * S, 14 * S, None, None, None),
            run.Done(3, 20 * S, 25 * S, None, None, None)]
    window = run.Window({}, done, 25e-3, 1.0, [], 0, clients=CLIENTS)
    return window, requests


def test_host_spans_of_overlapping_requests_are_disjoint():
    window, requests = overlapping_window()
    offset = 7
    spans = run.host_spans(window, requests, offset)
    assert spans == [(0 + offset, 2 * S + offset, "request eq"),
                     (2 * S + offset, 4 * S + offset, "request len"),
                     (4 * S + offset, 14 * S + offset, "request find"),
                     (20 * S + offset, 25 * S + offset, "request eq")]
    for (a0, a1, _), (b0, b1, _) in zip(spans, spans[1:]):
        assert a0 < a1 <= b0 < b1
    covered = sum(b - a for a, b, _ in spans)
    union = sum(b - a for a, b in trace.union(
        [(d.start_ns, d.end_ns) for d in window.done]))
    assert covered == union == 19 * S


def test_idle_under_overlapping_spans_is_counted_once():
    window, requests = overlapping_window()
    events = [("k", 1 * S, 3 * S), ("k", 12 * S, 21 * S)]
    spans = run.host_spans(window, requests, 0)
    tr = trace.summarize(events, 0, 25 * S, spans)
    assert tr.busy_s == 11e-3
    assert tr.idle_by_span == pytest.approx({
        "request eq": 1e-3 + 4e-3, "request len": 1e-3,
        "request find": 8e-3})
    assert sum(tr.idle_by_span.values()) == pytest.approx(
        tr.window_s - tr.busy_s)


def test_disjoint_spans_come_back_as_they_were():
    spans = [(0, 3, "a"), (3, 5, "b"), (5, 5, "c"), (7, 9, "a"),
             (9, 12, "d")]
    assert trace.disjoint(spans) == [s for s in spans if s[0] < s[1]]
    # the latest begun wins, and a span that outlasts it takes the rest
    assert trace.disjoint([(0, 10, "x"), (2, 4, "y"), (3, 5, "z")]) == [
        (0, 2, "x"), (2, 3, "y"), (3, 5, "z"), (5, 10, "x")]
    assert trace.disjoint([]) == []


def test_the_dealer_numbers_every_request_once_under_threads():
    count, threads = 20_000, 4 * (os.cpu_count() or 1)
    dealer = run.Dealer(0, count)  # the deadline has passed at once
    taken = [[] for _ in range(threads)]

    def client(mine):
        while (k := dealer.take()) is not None:
            mine.append(k)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=client, args=(t,)) for t in taken]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(k for t in taken for k in t) == list(range(count))
    assert dealer.take() is None


# sha256 of repr(traffic.make(mix, 0)): the requests of the committed
# mixes as they were before the key ``clients`` existed
DIGESTS = {
    "interactive": ("251376f266c5ad7ed3eab8dc391ba7b4"
                    "05f883b03dcc5cab85a31675bb9ba2a1", 288),
    "bulk": ("af559b771128867629128305b8e11a03"
             "11cfae2ebb4aac321702127933e562c0", 48),
    "split": ("946ce6b8702cf65abca4313597d40f0e"
              "bbf9b3f00daacd84d8cde8d30c4868bf", 16),
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_committed_mixes_make_the_same_requests(name):
    mix = traffic.load(traffic.find(PKG, name))
    assert traffic.clients(mix) == 1
    requests = traffic.make(mix, 0, PKG)
    digest, count = DIGESTS[name]
    assert len(requests) == count
    assert hashlib.sha256(repr(requests).encode()).hexdigest() == digest
