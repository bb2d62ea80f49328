"""Shared pieces of the benchmark's own tests: a tiny cell on the CPU.

``tiny_bench`` copies the benchmark's folder into a temporary directory
(so that a test may add files to it), adds the CPU test mix as
``traffic/tiny.json`` and returns (bench, base, root) for
``run.run_cell``: two cells, ``tiny64.tiny`` and ``tiny32.tiny``, on the
test sizes of the two configurations (n=32, N=256: seconds, not hours, on
a CPU), reporting every metric the real cells report.  ``tiny_clients``
serves the same cells to 3 concurrent clients.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
HERE = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device and nvcc; skips without them")
    # whole runs on the CPU: a worker that takes every core starves the
    # others under xdist, and a run then lasts minutes instead of seconds
    import torch

    torch.set_num_threads(min(2, torch.get_num_threads()))


def make_tiny(tmp_path, entry: str = "in_process", clients: int = 1):
    root = tmp_path / "fhebench"
    shutil.copytree(PKG, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(HERE, "configs", "tiny_mix.json")) as f:
        mix = json.load(f)
    mix["entry"] = entry
    if clients != 1:
        mix["clients"] = clients
    (root / "traffic" / "tiny.json").write_text(json.dumps(mix))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = ["tiny64.tiny", "tiny32.tiny"]
    bench["configs"] = [
        {"name": n, "source": "test", "reduced": [], "why": "test",
         "file": f"fhebench/tests/configs/{n}.json"}
        for n in ("tiny64", "tiny32")]
    bench["workloads"] = [
        {"name": c, "config": c.split(".")[0], "traffic": "tiny",
         "chips": 1, "why": "test"} for c in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = cells
    return bench, REPO, str(root)


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture
def tiny_service(tmp_path):
    return make_tiny(tmp_path, "service")


@pytest.fixture
def tiny_clients(tmp_path):
    return make_tiny(tmp_path, "service", clients=3)
