"""Torus arithmetic mod 2**64 on int64 tensors.

A torus element is held as an int64 tensor whose bits are the u64 residue in
two's complement: ``v`` and ``v + 2**64`` are the same element.  Addition,
subtraction, negation, multiplication by a small integer and sums then wrap
mod 2**64 exactly as u64 arithmetic does, so most ops are the plain tensor
operators; only the logical right shift needs a mask (``>>`` on int64 is
arithmetic).  This replaces the JAX package's ``torus.U64`` pair of uint32
planes (``fhestring_tpu/torus.py``).  ``torch.uint32`` is avoided: on CPU it
has no add, sub, shift, compare, where or gather.

Every op here is pinned against numpy uint64 in tests/test_torch_torus.py,
including int64 wraparound, which torch does not document.
"""

from __future__ import annotations

import numpy as np
import torch

from . import metrics

MASK32 = 0xFFFFFFFF


def wrap(value: int) -> int:
    """A Python int reduced mod 2**64 into int64 two's-complement range."""
    value = int(value) % (1 << 64)
    return value - (1 << 64) if value >= (1 << 63) else value


def from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """uint64 numpy array -> int64 tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(arr).astype(np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def _staged(t: torch.Tensor, device) -> tuple[torch.Tensor, bool]:
    """``t`` copied into fresh page-locked memory and from there onto the
    CUDA ``device`` on the current stream, without waiting for the card;
    and whether the staging is page-locked."""
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(device, non_blocking=True), staged.is_pinned()


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """``t``, data on the host, copied onto ``device`` as ``to_device``
    copies it, and counted nowhere: the service's copies of the
    ciphertexts it receives, which are no part of a method's work."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return _staged(t, device)[0]


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t``, plain data on the host, copied onto the server's ``device``.

    On a CUDA device the host does not wait for the card: ``t`` is copied
    into fresh page-locked memory, so the caller may overwrite or drop it as
    soon as this returns, and from there onto the card asynchronously on
    the current stream.  PyTorch's caching host allocator keeps the staging
    block until that copy has run.  Elsewhere this is ``t.to(device)``.

    Each call adds one to ``metrics.GLOBAL.host_copies`` (on the CPU as
    well, where nothing is copied, so that the CPU counts what the card
    does) and is recorded as a ``copy`` span.  A copy onto the card whose
    staging is not page-locked, which CUDA may make wait on the stream,
    also adds one to ``metrics.GLOBAL.blocking_copies``."""
    with metrics.span("copy"):
        if torch.device(device).type != "cuda":
            metrics.count(host_copies=1)
            return t.to(device)
        out, pinned = _staged(t, device)
        metrics.count(host_copies=1, blocking_copies=not pinned)
        return out


def to_numpy(v: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits.

    From a CUDA device the copy goes into page-locked memory on the current
    stream, and the thread sleeps on an event until the card has run it.
    A plain ``.cpu()`` spins a CPU core in its synchronise meanwhile; a
    server whose many request threads wait for their results at once would
    take the cores its other threads need."""
    v = v.detach()
    if v.device.type == "cuda":
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        copied = torch.cuda.Event(blocking=True)
        copied.record(torch.cuda.current_stream(v.device))
        copied.synchronize()
        v = host
    return v.contiguous().numpy().view(np.uint64)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def neg(a: torch.Tensor) -> torch.Tensor:
    return -a


def add_scalar(a: torch.Tensor, value: int) -> torch.Tensor:
    return a + wrap(value)


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a small non-negative integer constant (mod 2**64)."""
    return a * int(c)


def shl(a: torch.Tensor, k: int) -> torch.Tensor:
    """Left shift by a static amount (bits shifted past bit 63 are lost)."""
    if k == 0:
        return a
    if k >= 64:
        return torch.zeros_like(a)
    return a << k


def shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 residue by a static amount."""
    if k == 0:
        return a
    if k >= 64:
        return torch.zeros_like(a)
    return (a >> k) & ((1 << (64 - k)) - 1)


def round_shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Rounded right shift: floor((a + 2**(k-1)) / 2**k) mod 2**64."""
    assert k >= 1
    return shr(add_scalar(a, 1 << (k - 1)), k)


def sum_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum along an axis mod 2**64."""
    return a.sum(dim=axis, dtype=torch.int64)


def hi32(a: torch.Tensor) -> torch.Tensor:
    """The top 32 bits of each element as an int32 tensor (the u32 payload
    of a 32-bit-subgroup value, reinterpreted as signed)."""
    return (a >> 32).to(torch.int32)


def from_hi32(hi: torch.Tensor) -> torch.Tensor:
    """int32 payload -> int64 torus element payload * 2**32."""
    return hi.to(torch.int64) << 32
