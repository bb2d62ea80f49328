"""The cell of many users, ``prod64.users32``: whole runs of a tiny
``prod64_users``-shaped cell with 4 clients on the CPU, its files and
entries, and its per-layer readers.

A sound run is correct, and its clients' bootstraps did merge; every
planted fault of ``control`` and the control make it not correct; so does
a fault that only a merged dispatch can make, outputs rolled by the first
post's width, so that each request gets another's results.  The readers
read the program's new counters where it has them and leave the metric
out where it has not, as a parent without them would run the cell.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import types

import pytest
import torch

from fhebench import control, run, traffic

SEED = 2**31 + 2026
DECK = 8   # requests in one deck of the tiny mix: 4 methods, 2 each
CLIENTS = 4
CELL = "tiny64_users.users4"
HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
REPO = os.path.dirname(PKG)
USERS = ["posts_per_dispatch.users", "dispatch_width.users",
         "pbs_wait_ms.users", "pbs_per_s.users", "rotation_roofline.users",
         "device_idle_pct.users"]


def bench_json() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_users(tmp_path):
    """(bench, base, root): the benchmark's folder copied, the 4-client
    mix as ``traffic/users4.json``, and one cell on the tiny
    configuration that reports what ``prod64.users32`` reports."""
    root = tmp_path / "fhebench"
    shutil.copytree(PKG, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(os.path.join(HERE, "configs", "users_mix.json"),
                root / "traffic" / "users4.json")
    bench = bench_json()
    bench["configs"] = [{"name": "tiny64_users", "source": "test",
                         "reduced": [], "why": "test",
                         "file": "fhebench/tests/configs/tiny64_users.json"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny64_users",
                           "traffic": "users4", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL if w == "prod64.users32" else w
                              for w in m["workloads"]]
    return bench, REPO, str(root)


def run_users(monkeypatch, tiny, **kw):
    """A run that sends one deck from 4 clients: (result line, window)."""
    seen = {}
    real_check = run.check

    def check(window, *args):
        seen["window"] = window
        return real_check(window, *args)
    monkeypatch.setattr(run, "check", check)
    bench, base, root = tiny
    out = run.run_cell(bench, CELL, SEED, 0.0, False, device="cpu",
                       base=base, root=root, min_requests=DECK, **kw)
    return out, seen["window"]


def test_a_sound_run_of_many_users_is_correct_and_merges(monkeypatch,
                                                         tiny_users):
    out, window = run_users(monkeypatch, tiny_users)
    assert out["correct"], out["checks"]
    assert out["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert out["attempted"] == DECK and out["failed"] == 0
    assert window.clients == CLIENTS
    assert set(out["metrics"]) == {"setup_s", "requests_per_s",
                                   "latency_p95_ms"}
    t = window.totals
    assert t.pbs_posts > t.pbs_calls == len(window.widths) > 0
    assert t.pbs_items == sum(window.widths)
    values = {name: run.load_reader(tiny_users[2], "layer_metrics", name)(
        window) for name in USERS}
    assert values["posts_per_dispatch.users"] == t.pbs_posts / t.pbs_calls
    assert values["dispatch_width.users"] == t.pbs_items / t.pbs_calls
    assert values["pbs_wait_ms.users"] > 0
    assert values["pbs_per_s.users"] == t.pbs_items / window.window_s
    # no device trace in an untraced run on the CPU
    assert values["rotation_roofline.users"] is None
    assert values["device_idle_pct.users"] is None


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_every_fault_fails_many_users(monkeypatch, tiny_users, fault):
    with control.FAULTS[fault]():
        out, _ = run_users(monkeypatch, tiny_users)
    assert out["attempted"] == DECK
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_the_control_fails_many_users(monkeypatch, tiny_users):
    sound, _ = run_users(monkeypatch, tiny_users)
    low, _ = run_users(monkeypatch, tiny_users,
                       key_hook=control.lower_precision_key)
    assert sound["correct"] and not low["correct"]
    assert (low["checks"]["noise_share"]["value"]
            >= 3 * sound["checks"]["noise_share"]["value"])


def test_results_crossed_between_users_fail_the_run(monkeypatch,
                                                    tiny_users):
    """Each merged dispatch's output rolled by the width of its first
    post: every request of it gets rows of another's (an unmerged
    dispatch is rolled by its own width, which changes nothing)."""
    from fhestring_tpu_torch import batching, shortint

    first = threading.local()
    real_merge, real_pbs = batching.merge, shortint.pbs_batch

    def merge(posts):
        first.width = posts[0].flat.shape[0]
        return real_merge(posts)

    def rolled(flat, idx, bank, keys, **mode):
        out = real_pbs(flat, idx, bank, keys, **mode)
        return torch.roll(out, first.__dict__.pop("width", 0), 0)
    monkeypatch.setattr(batching, "merge", merge)
    monkeypatch.setattr(shortint, "pbs_batch", rolled)
    out, window = run_users(monkeypatch, tiny_users)
    assert window.totals.pbs_posts > window.totals.pbs_calls
    assert out["attempted"] == DECK
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_the_users_cell_reports_its_metrics():
    bench = bench_json()
    e2e = {m["name"] for m in run.cell_metrics(bench, "prod64.users32",
                                               False)}
    assert e2e == {"requests_per_s", "latency_p95_ms", "setup_s"}
    layer = {m["name"] for m in run.cell_metrics(bench, "prod64.users32",
                                                 True)}
    assert layer == set(USERS)
    cell = next(w for w in bench["workloads"]
                if w["name"] == "prod64.users32")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "prod64_users", "users32", 1)


def test_the_users_configuration_is_prod64_served_to_many():
    def load(name):
        with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
            return json.load(f)
    users, prod = load("prod64_users"), load("prod64")
    for key in ("params", "with_ntt2", "work", "checks", "control",
                "reduced"):
        assert users[key] == prod[key], key
    assert "fhebench/reference.py" in users["reference"]
    assert "32" in users["assumed"]["clients"]


def test_the_users_mix_is_the_interactive_one_from_32_clients():
    users = traffic.load(traffic.find(PKG, "users32"))
    inter = traffic.load(traffic.find(PKG, "interactive"))
    assert traffic.clients(users) == 32
    assert set(users["basis"]) >= set(inter["basis"]) | {"clients"}
    same = set(inter) - {"why", "basis", "decks"}
    assert {k: users[k] for k in same} == {k: inter[k] for k in same}
    # the same requests, deck for deck, as the interactive mix makes
    a = traffic.make(users, 7, PKG)
    b = traffic.make(inter, 7, PKG)
    assert len(a) == 48 * users["decks"] and a[:len(b)] == b


@pytest.mark.parametrize("name", USERS)
def test_a_program_without_the_counters_leaves_the_metric_out(name):
    """As the parent of the coalescer runs the cell: no ``pbs_posts`` or
    ``pbs_wait_ns`` in the counters, and with several clients no
    per-request count; no trace in an untraced run."""
    totals = types.SimpleNamespace(pbs_calls=10, pbs_items=240,
                                   pbs_items_padded=240)
    window = run.Window({}, [], 51.0, 1.0, [24] * 10, 132, totals=totals,
                        clients=32)
    value = run.load_reader(PKG, "layer_metrics", name)(window)
    if name in ("dispatch_width.users", "pbs_per_s.users"):
        assert value == {"dispatch_width.users": 24.0,
                         "pbs_per_s.users": 240 / 51.0}[name]
    else:
        assert value is None
