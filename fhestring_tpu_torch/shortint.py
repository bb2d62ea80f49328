"""Shortint layer: 2-bit-message blocks with LUT-based evaluation.

Mirrors the JAX package's ``shortint.py`` (the role of tfhe-rs's shortint
module for the ``PARAM_MESSAGE_2_CARRY_2`` encoding): each block holds a
value in [0, 16) (2 message bits + 2 carry bits + padding bit), linear
operations are free (noise-additive), and any function on packed values in
[0, 16) costs one programmable bootstrap.

The container tracks ``degree`` (max possible plaintext value) and
``noise_var`` (variance in fresh-PBS units) as Python values, so packing
safety (degree <= 15, noise within budget) is asserted on every op.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import metrics, parallel, torus
from .batching import Coalescer, card_fence
from .crypto.keys import DeviceServerKeys, pack_luts
from .crypto.pbs import pbs_batch, served_mode
from .params import CryptoParams

MAX_NOISE_VAR = 34.0  # default for sets without a calibrated noise_budget
MAX_DEGREE = 15


@dataclasses.dataclass
class Blocks:
    """A tensor of shortint blocks: ct is int64 torus [..., kN+1]."""

    ct: torch.Tensor
    degree: int
    noise_var: float

    @property
    def shape(self):
        return tuple(self.ct.shape[:-1])


def _with_body_added(ct: torch.Tensor, value: int) -> torch.Tensor:
    """A copy of ct with ``value`` added to every body coefficient."""
    out = ct.clone()
    out[..., -1] += torus.wrap(value)
    return out


class ShortintContext:
    """Server-side evaluator: owns device keys, a LUT cache and the
    coalescer (``batching``) that merges concurrent requests' batches."""

    def __init__(self, keys: DeviceServerKeys):
        self.keys = keys
        self.params: CryptoParams = keys.params
        self.device = keys.device
        # Per-set linear-noise budget (fresh-PBS variance units); see
        # params.CryptoParams.noise_budget for the derivation.
        self.max_noise_var: float = getattr(
            keys.params, "noise_budget", MAX_NOISE_VAR)
        self._lut_cache: dict[tuple, torch.Tensor] = {}
        # A torch.distributed process group while the server runs
        # lane-sharded (parallel.lane_sharded), else None.
        self.group = None
        self.batches = Coalescer(
            self._dispatch,
            (lambda: card_fence(self.device))
            if self.device.type == "cuda" else None)

    # -- constructors -------------------------------------------------------
    def trivial(self, values) -> Blocks:
        """Noiseless server-side constants (tfhe create_trivial_radix
        analog)."""
        p = self.params
        values = np.asarray(values, dtype=np.uint64)
        ct = np.zeros(values.shape + (p.big_lwe_dimension + 1,), dtype=np.uint64)
        ct[..., -1] = (values % np.uint64(p.full_space)) * np.uint64(p.delta)
        return Blocks(torus.to_device(torus.from_numpy(ct), self.device),
                      int(values.max()) if values.size else 0, 0.0)

    def from_numpy_cts(self, cts: np.ndarray, degree: int = 3) -> Blocks:
        return Blocks(torus.from_numpy(cts, self.device), degree, 1.0)

    # -- linear algebra (no PBS) --------------------------------------------
    def add(self, a: Blocks, b: Blocks) -> Blocks:
        assert a.degree + b.degree <= MAX_DEGREE, (a.degree, b.degree)
        return Blocks(a.ct + b.ct, a.degree + b.degree,
                      a.noise_var + b.noise_var)

    def sub_from_scalar(self, scalar: int, a: Blocks) -> Blocks:
        """scalar - a, where a.degree <= scalar (e.g. bit flip 1 - x)."""
        assert a.degree <= scalar <= MAX_DEGREE
        return Blocks(_with_body_added(-a.ct, scalar * self.params.delta),
                      scalar, a.noise_var)

    def scalar_mul(self, a: Blocks, c: int) -> Blocks:
        assert a.degree * c <= MAX_DEGREE
        return Blocks(torus.mul_small(a.ct, c), a.degree * c,
                      a.noise_var * c * c)

    def add_scalar(self, a: Blocks, c: int) -> Blocks:
        assert a.degree + c <= MAX_DEGREE
        return Blocks(_with_body_added(a.ct, c * self.params.delta),
                      a.degree + c, a.noise_var)

    def sum_many(self, blocks: list[Blocks]) -> Blocks:
        out = blocks[0]
        for b in blocks[1:]:
            out = self.add(out, b)
        return out

    def sum_axis(self, a: Blocks, axis: int, count: int, max_value: int) -> Blocks:
        """Sum along an axis of known length; caller guarantees the summed
        plaintext value never exceeds max_value <= 15."""
        assert max_value <= MAX_DEGREE
        ax = axis if axis >= 0 else axis - 1  # account for trailing ct dim
        return Blocks(torus.sum_axis(a.ct, ax), max_value, a.noise_var * count)

    # -- LUT evaluation (PBS) -------------------------------------------------
    def _bank_for(self, tables: tuple[tuple[int, ...], ...]) -> torch.Tensor:
        bank = self._lut_cache.get(tables)
        if bank is None:
            # two threads may pack the same tables; both then use the one
            # that setdefault keeps, so that equal banks are one tensor
            bank = self._lut_cache.setdefault(tables, pack_luts(
                [list(t) for t in tables], self.params, self.device))
        return bank

    def _pbs_padded(self, flat: torch.Tensor, idx: torch.Tensor,
                    bank: torch.Tensor) -> torch.Tensor:
        """Bootstrap ``flat`` through ``bank[idx]``: a post to the
        coalescer, which dispatches it merged with the batches of the
        other requests in flight (``batching``), or alone where there are
        none."""
        return self.batches.post(flat, idx, bank)

    def _dispatch(self, flat: torch.Tensor, idx: torch.Tensor,
                  bank: torch.Tensor, posts: int = 1) -> torch.Tensor:
        """Run pbs_batch on a batch of bounded width, made of ``posts``
        requests' posts.

        Batches wider than the chunk size run in chunks (bounds the
        keyswitch and accumulator memory).  On CPU the batch is padded to a
        power of two, as the JAX package pads on CPU, so counts and padded
        counts match it there.  The CUDA kernels take any batch, so on the
        card nothing is padded.  The blind-rotation mode is
        ``served_mode``'s, the route the key's.  Under
        ``parallel.lane_sharded`` the batch is sharded over the process
        group (``parallel.pbs_batch_sharded``) and counted once, as one
        process counts it.  Each batch that
        reaches ``pbs_batch`` is one ``pbs.dispatch`` span and one
        ``metrics.record_pbs``."""
        n = flat.shape[0]
        on_cpu = flat.device.type == "cpu"
        max_chunk = 4096 if on_cpu else 8192
        if n > max_chunk:
            return torch.cat([
                self._dispatch(flat[s:s + max_chunk], idx[s:s + max_chunk],
                               bank, posts)
                for s in range(0, n, max_chunk)])
        if on_cpu:
            padded = max(8, 1 << (n - 1).bit_length()) if n > 1 else 8
        else:
            padded = n
        metrics.record_pbs(n, padded)
        with metrics.span("pbs.dispatch", width=n, posts=posts):
            if padded != n:
                flat = torch.cat([flat,
                                  flat.new_zeros((padded - n, flat.shape[1]))])
                idx = torch.cat([idx, idx.new_zeros(padded - n)])
            rounded, approx = served_mode(self.keys, flat.device)
            if self.group is not None:
                return parallel.pbs_batch_sharded(
                    flat, idx, bank, self.keys, self.group, rounded=rounded,
                    approx=approx)[:n]
            return pbs_batch(flat, idx, bank, self.keys, rounded=rounded,
                             approx=approx)[:n]

    def apply_lut(self, a: Blocks, table) -> Blocks:
        """Univariate LUT via one batched PBS. table: 16 ints in [0, 16)."""
        table = tuple(int(v) % 16 for v in table)
        assert a.noise_var <= self.max_noise_var
        bank = self._bank_for((table,))
        flat = a.ct.reshape(-1, a.ct.shape[-1])
        idx = torch.zeros(flat.shape[0], dtype=torch.int64, device=flat.device)
        out = self._pbs_padded(flat, idx, bank)
        return Blocks(out.reshape(a.ct.shape), max(table), 1.0)

    def apply_lut_multi(self, a: Blocks, tables, table_idx) -> Blocks:
        """Per-element LUT selection: tables [L][16], table_idx ints of
        a.shape (numpy array or tensor)."""
        tables = tuple(tuple(int(v) % 16 for v in t) for t in tables)
        assert a.noise_var <= self.max_noise_var
        bank = self._bank_for(tables)
        flat = a.ct.reshape(-1, a.ct.shape[-1])
        idx = torus.to_device(
            torch.as_tensor(np.asarray(table_idx).reshape(-1),
                            dtype=torch.int64), flat.device)
        out = self._pbs_padded(flat, idx, bank)
        return Blocks(out.reshape(a.ct.shape), max(max(t) for t in tables), 1.0)

    def apply_lut_bivariate(self, x: Blocks, y: Blocks, fn: Callable[[int, int], int]) -> Blocks:
        """LUT over a packed pair: out = fn(x, y) with x,y in [0, msg_mod)."""
        m = self.params.message_modulus
        assert x.degree < m and y.degree < m, (x.degree, y.degree)
        packed = self.add(self.scalar_mul(x, m), y)
        table = [fn(u // m, u % m) for u in range(self.params.plaintext_space)]
        return self.apply_lut(packed, table)

    def refresh(self, a: Blocks) -> Blocks:
        """Identity bootstrap (noise reset), degree preserved <= 3."""
        assert a.degree <= 3
        return self.apply_lut(a, list(range(4)) * 4)

    def maybe_refresh(self, a: Blocks, incoming_var: float) -> Blocks:
        if a.noise_var + incoming_var > self.max_noise_var:
            return self.refresh(a)
        return a
