"""The device trace of a window and what the per-layer metrics read from it.

``torch.profiler`` records every operation the card ran in the window
(kernels, copies, sets; CUPTI activity only, so the host pays little).
From its raw events this module takes:

- ``busy_s``: the union of the operations' intervals inside the window,
  not their sum, since operations on several streams overlap;
- ``op_s``: device seconds by operation name;
- ``idle_by_span``: the seconds of the window that the union leaves
  uncovered, by the host span (the benchmark's own) each gap fell in.

Host spans overlap where several clients have requests in flight;
``disjoint`` gives each stretch of host time to one of them before the
gaps are laid to them, so that no second is counted twice.

Library kernels (PyTorch's own, cuBLAS and CUTLASS products) are told
from the program's hand-written ones by name (``is_library``).
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq

LIBRARY_MARKS = ("at::", "cutlass", "cublas", "gemm", "xmma", "nvjet",
                 "memcpy", "memset", "splitk", "cub::", "thrust::")


def is_library(name: str) -> bool:
    """An operation of PyTorch, its libraries or the driver (copies and
    sets), not a kernel of the program's own."""
    low = name.lower()
    return any(mark in low for mark in LIBRARY_MARKS)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    op_s: dict            # name -> device seconds inside the window
    idle_by_span: dict    # host span label -> idle device seconds

    def program_kernel_s(self) -> float:
        return sum(s for name, s in self.op_s.items() if not is_library(name))


def union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def disjoint(spans) -> list:
    """Sorted, disjoint (start, end, label) from spans that may overlap:
    each stretch goes to the span begun latest of those that cover it (of
    two begun at once, the later in the list).  Disjoint spans come back
    as they were, less any of no length."""
    order = sorted(range(len(spans)), key=lambda j: spans[j][0])
    bounds = sorted({t for s in spans for t in s[:2]})
    covering, out, k = [], [], 0  # heap of (-start, -index)
    for a, b in zip(bounds, bounds[1:]):
        while k < len(order) and spans[order[k]][0] <= a:
            heapq.heappush(covering, (-spans[order[k]][0], -order[k]))
            k += 1
        while covering and spans[-covering[0][1]][1] <= a:
            heapq.heappop(covering)
        if not covering:
            continue
        j = -covering[0][1]
        if out and out[-1][3] == j and out[-1][1] == a:
            out[-1][1] = b
        else:
            out.append([a, b, spans[j][2], j])
    return [(a, b, label) for a, b, label, _ in out]


def summarize(events, t0: int, t1: int, spans) -> Trace:
    """events: (name, start_ns, end_ns) of device operations; [t0, t1)
    the window in the same clock; spans: sorted, disjoint (start_ns,
    end_ns, label) of what the host was doing."""
    op_s: dict[str, float] = {}
    clipped = []
    for name, start, end in events:
        start, end = max(start, t0), min(end, t1)
        if end <= start:
            continue
        clipped.append((start, end))
        op_s[name] = op_s.get(name, 0.0) + (end - start) / 1e9
    merged = union(clipped)
    busy = sum(end - start for start, end in merged)
    gaps, last = [], t0
    for start, end in merged:
        if start > last:
            gaps.append((last, start))
        last = max(last, end)
    if t1 > last:
        gaps.append((last, t1))
    return Trace((t1 - t0) / 1e9, busy / 1e9, op_s,
                 idle_by_label(gaps, spans))


def idle_by_label(gaps, spans) -> dict:
    """Seconds of each gap attributed to the host spans it overlaps; the
    rest to "between requests"."""
    starts = [s[0] for s in spans]
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(spans) and spans[i][0] < g1:
            s0, s1, label = spans[i]
            part = min(g1, s1) - max(g0, s0)
            if part > 0:
                out[label] = out.get(label, 0.0) + part / 1e9
                covered += part
            i += 1
        if g1 - g0 > covered:
            key = "between requests"
            out[key] = out.get(key, 0.0) + (g1 - g0 - covered) / 1e9
    return out


class Recorder:
    """``torch.profiler`` around a window, device activity only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def events(self):
        """(name, start_ns, end_ns) of every device operation recorded."""
        from torch.autograd import DeviceType

        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                start = e.start_ns()
                out.append((e.name(), start, start + e.duration_ns()))
        return out
