"""The device trace's arithmetic on synthetic intervals, and the percentile
and roofline readers."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

from fhebench import roofline, run, trace

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
S = 1_000_000_000  # ns


def test_busy_is_the_union_of_overlapping_intervals():
    events = [("k1", 0, 4 * S), ("k2", 1 * S, 3 * S), ("k3", 2 * S, 5 * S),
              ("k1", 7 * S, 8 * S)]
    tr = trace.summarize(events, 0, 10 * S, [])
    assert tr.busy_s == 6.0          # [0, 5) and [7, 8); the sum is 10
    assert tr.window_s == 10.0
    assert tr.op_s == {"k1": 5.0, "k2": 2.0, "k3": 3.0}
    assert tr.idle_by_span == {"between requests": 4.0}


def test_intervals_are_clipped_to_the_window():
    events = [("a", -2 * S, 1 * S), ("b", 9 * S, 12 * S), ("c", 20 * S, 21 * S)]
    tr = trace.summarize(events, 0, 10 * S, [])
    assert tr.busy_s == 2.0
    assert tr.op_s == {"a": 1.0, "b": 1.0}


def test_idle_gaps_are_laid_to_the_host_spans():
    events = [("k", 1 * S, 2 * S), ("k", 6 * S, 7 * S)]
    spans = [(0, 3 * S, "method x"), (3 * S, 5 * S, "service, back"),
             (6 * S, 8 * S, "method y")]
    tr = trace.summarize(events, 0, 10 * S, spans)
    assert tr.idle_by_span == {"method x": 2.0, "service, back": 2.0,
                               "between requests": 3.0, "method y": 1.0}
    assert sum(tr.idle_by_span.values()) == tr.window_s - tr.busy_s


def test_library_kernels_are_told_from_the_programs():
    assert trace.is_library(
        "void at::native::vectorized_elementwise_kernel<4, ...>(...)")
    assert trace.is_library("sm90_xmma_gemm_s8s8_s32_tn_n_tilesize128")
    assert trace.is_library("Memcpy HtoD (Pageable -> Device)")
    assert not trace.is_library("void blind_rotate64_kernel<true, true>(...)")
    assert not trace.is_library(
        "void rotate_cluster::kernel<(anonymous namespace)::Spec, 4>(...)")
    tr = trace.Trace(1.0, 0.5, {"void blind_rotate32_kernel(...)": 0.3,
                                "void at::native::reduce_kernel<>": 0.2}, {})
    assert tr.program_kernel_s() == 0.3


def reader(kind: str, name: str):
    return run.load_reader(PKG, kind, name)


def done(ms: float, i: int = 0) -> run.Done:
    return run.Done(i, 0, int(ms * 1e6), None, 2, 10)


def test_percentiles_are_taken_over_every_request():
    lat = list(range(1, 201))  # 200 requests of 1..200 ms
    w = run.Window({}, [done(x, i) for i, x in enumerate(lat)], 10.0, 1.0,
                   [], 0)
    assert reader("end_to_end", "latency_p50_ms")(w) == pytest.approx(100.5)
    assert reader("end_to_end", "latency_p95_ms")(w) == pytest.approx(190.05)
    assert reader("end_to_end", "requests_per_s")(w) == 20.0
    w.done[0].error = "failed"
    assert reader("end_to_end", "requests_per_s")(w) == 19.9


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,args", [("prod64", (2048, 32, 2 * 60)),
                                       ("turbo32", (2048, 28, 2 * 48))])
def test_the_count_per_item_step_is_chip_smokes(name, args):
    with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
        work = json.load(f)["work"]
    assert (work["polynomial_size"], work["transforms"],
            work["products"]) == args
    count = roofline.item_step_instructions(work)
    assert count == roofline.ntt_instructions(*args)
    assert count == chip_smoke().ntt_instructions(*args)
    assert count == {"prod64": 2_048_000, "turbo32": 1_773_568}[name]


def test_the_roofline_reads_the_least_time_over_the_kernels_time():
    with open(os.path.join(PKG, "configs", "prod64.json")) as f:
        config = json.load(f)
    peak = roofline.int32_peak(132)
    assert peak == 64 * 132 * 1.98e9
    per_item = 742 * 2_048_000 / peak
    key = 742 * 65536 / 3.35e12
    assert roofline.least_seconds([1], config, 132) == pytest.approx(
        max(per_item, key))
    assert roofline.least_seconds([8, 100], config, 132) == pytest.approx(
        108 * per_item)
    tr = trace.Trace(10.0, 9.0, {"void blind_rotate64_kernel<>": 2.0,
                                 "Memcpy DtoH": 1.0}, {})
    w = run.Window(config, [], 10.0, 1.0, [8, 100], 132, tr)
    got = reader("layer_metrics", "rotation_roofline.bulk")(w)
    assert got == pytest.approx(100 * 108 * per_item / 2.0)
    assert reader("layer_metrics", "device_idle_pct.bulk")(w) == \
        pytest.approx(10.0)
    w.trace = None
    assert reader("layer_metrics", "rotation_roofline.bulk")(w) is None
    assert reader("layer_metrics", "device_idle_pct.bulk")(w) is None
