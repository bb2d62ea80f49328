"""Measurement scripts for the CUDA kernels; each runs on a machine with
one NVIDIA GPU and nvcc (``python3 -m fhestring_tpu_torch.tools.<name>``)
and prints the card's name and power limit beside its numbers."""

from __future__ import annotations

import subprocess
import time

import torch


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, one line."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, repeat: int = 2) -> float:
    """Mean milliseconds of fn() over `repeat` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def graph_ms(fn, launches: int = 20, repeat: int = 5) -> float:
    """Device milliseconds of one fn(): `launches` calls captured into a
    CUDA graph, the mean over `repeat` replays after a warm-up one.  fn must
    allocate nothing.  The step-wise wrappers' launch counts are put back
    afterwards: launches made to time a kernel are none of a served
    path."""
    from ..crypto.kernels import ext_product, ntt_ext, rotate_decompose

    kernels = (rotate_decompose.rotate_diff_decompose,
               ext_product.ext_product, ntt_ext.ntt_ext)
    counts = [k.launches for k in kernels]
    fn()  # loads the kernels: a capture cannot
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = cuda_ms(graph.replay, repeat) / launches
    for kernel, count in zip(kernels, counts):
        kernel.launches = count
    return ms


def wall_ms(fn, repeat: int = 20) -> float:
    """Host milliseconds of one fn() launched eagerly, `repeat` calls back to
    back after a warm-up and a synchronise at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / repeat


def random_khat(gen, n_steps: int, digit_polys: int, out_polys: int, n: int):
    """A key of random residues in the kernels' layout, int16 [n_steps, 2,
    digit_polys, out_polys, n] (u16 bits): K1 takes (6, 8), K2 (2, 16)."""
    kh = torch.cat([torch.randint(0, q, (n_steps, 1, digit_polys, out_polys,
                                         n), generator=gen)
                    for q in (40961, 61441)], dim=1)
    return torch.where(kh >= 1 << 15, kh - (1 << 16), kh).to(torch.int16)
