"""Whole runs of a tiny cell on the CPU: a sound run is correct, the
control and every fault make it not correct, and new configuration, mix
and metric files are found by name."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from fhebench import control, run

SEED = 2**31 + 99


DECK = 8  # requests in one deck of the tiny mix: 4 methods, 2 each


def run_tiny(bench, base, root, cell="tiny64.tiny", seconds=0.3, **kw):
    return run.run_cell(bench, cell, SEED, seconds, False, device="cpu",
                        base=base, root=root, **kw)


@pytest.mark.parametrize("cell", ["tiny64.tiny", "tiny32.tiny"])
@pytest.mark.parametrize("entry", ["tiny_bench", "tiny_service"])
def test_a_sound_run_is_correct(request, cell, entry):
    out = run_tiny(*request.getfixturevalue(entry), cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    names = set(out["metrics"])
    assert {"setup_s", "latency_p50_ms", "latency_p95_ms",
            "requests_per_s"} <= names
    assert set(out["setup_parts_s"]) == {"imports", "keygen", "pack",
                                         "inputs", "warmup"}


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_every_fault_makes_the_run_not_correct(tiny_bench, fault):
    with control.FAULTS[fault]():
        out = run_tiny(*tiny_bench, seconds=0.1, min_requests=DECK)
    assert out["attempted"] >= DECK
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny64.tiny", "tiny32.tiny"])
def test_the_control_is_not_correct(tiny_bench, cell):
    sound = run_tiny(*tiny_bench, cell=cell)
    low = run_tiny(*tiny_bench, cell=cell,
                   key_hook=control.lower_precision_key)
    assert sound["correct"] and not low["correct"]
    assert (low["checks"]["noise_share"]["value"]
            >= 3 * sound["checks"]["noise_share"]["value"])


def test_new_files_are_found_by_name(tmp_path, tiny_bench):
    bench, base, root = tiny_bench
    # a configuration, a mix, a method and a metric that the harness has
    # not seen
    shutil.copy(os.path.join(base, "fhebench/tests/configs/tiny64.json"),
                tmp_path / "tiny64b.json")
    bench["configs"].append({"name": "tiny64b", "source": "test",
                             "reduced": [], "why": "test",
                             "file": str(tmp_path / "tiny64b.json")})
    mix = json.loads(open(os.path.join(root, "traffic", "tiny.json")).read())
    mix["methods"] = ["len", "ends_with"]
    with open(os.path.join(root, "methods", "ends_with.py"), "w") as f:
        f.write("from fhebench import reference as ref\n"
                "PATTERN = 'suffix'\n"
                "ENCRYPTED_PATTERN = True\n"
                "REPLACEMENT = False\n"
                "def decode(result, text, char):\n"
                "    return char(result)\n"
                "def answer(string, pattern, to):\n"
                "    return int(ref.ends_with(string, pattern))\n")
    with open(os.path.join(root, "traffic", "lens.json"), "w") as f:
        json.dump(mix, f)
    bench["workloads"].append({"name": "tiny64b.lens", "config": "tiny64b",
                               "traffic": "lens", "chips": 1, "why": "t"})
    with open(os.path.join(root, "end_to_end", "requests_seen.py"),
              "w") as f:
        f.write("def read(window):\n    return len(window.done)\n")
    bench["end_to_end"].append({"name": "requests_seen", "unit": "requests",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny64b.lens"]})
    with open(os.path.join(root, "layer_metrics", "lens_seen.py"),
              "w") as f:
        f.write("def read(window):\n    return 7.0\n")
    out = run_tiny(bench, base, root, cell="tiny64b.lens", seconds=0.1,
                   min_requests=4)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2
    assert out["metrics"]["requests_seen"]["value"] == out["attempted"]
    assert "latency_p50_ms" not in out["metrics"]
    assert run.load_reader(root, "layer_metrics", "lens_seen")(None) == 7.0


def test_the_cells_metrics_follow_benchmark_json():
    with open(os.path.join(os.path.dirname(run.HERE),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = {m["name"] for m in run.cell_metrics(bench, "prod64.interactive",
                                               False)}
    assert e2e == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    layer = {m["name"] for m in run.cell_metrics(bench, "turbo32.bulk",
                                                 True)}
    assert layer == {"pbs_per_request.bulk", "pbs_per_s.bulk",
                     "rotation_roofline.bulk", "device_idle_pct.bulk"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        kind = "end_to_end" if m in bench["end_to_end"] else "layer_metrics"
        assert os.path.exists(os.path.join(run.HERE, kind,
                                           f"{m['name']}.py")), m["name"]
