"""Evaluation backends for the string engine.

The string engine (engine/strings.py) is written once against a duck-typed
backend interface operating on tensors of encrypted u8 chars ("CT") and
encrypted 0/1 bits ("BT"); all shapes/indices are public (data-oblivious
control flow).

Two implementations, as in the JAX package's ``engine/backend.py``:

- ClearBackend: plain numpy uint8, copied unchanged.  The executable spec
  of the engine ops, including ``scan``.
- FheBackend: real TFHE on torch tensors via RadixContext; every op lowers
  to batched PBS.  It runs eagerly: ``scan`` and ``scan_out`` are Python
  loops with ClearBackend.scan as the spec, where the JAX package traces a
  ``lax.scan``; each is an ``engine.scan`` span and counts its steps in
  ``metrics.GLOBAL.scan_steps``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metrics, torus
from ..radix import NB, RadixContext
from ..shortint import Blocks, ShortintContext

# =============================================================================
# Clear (plaintext) backend
# =============================================================================

class ClearBackend:
    """numpy-uint8 semantics: the executable spec of the engine ops."""

    name = "clear"
    xp = np  # plaintext index math inside scan bodies

    # -- scan / dynamic indexing (engine sequential kernels) -----------------
    def scan(self, body, carry, xs: dict, length: int):
        """Run body(carry, x) for i in [0, length); x = {k: xs[k][i]}.
        Plain Python loop — the executable spec of the FHE lax.scan path."""
        for i in range(length):
            carry = body(carry, {k: v[i] for k, v in xs.items()})
        return carry

    def scan_out(self, body, carry, xs: dict, length: int):
        """Like scan, but body returns (carry, y); returns (carry, ys) with
        the per-step ys stacked along a new leading axis.  Keeps scan
        carries small: per-step products belong in ys, not in the carry."""
        ys = []
        for i in range(length):
            carry, y = body(carry, {k: v[i] for k, v in xs.items()})
            ys.append(y)
        return carry, np.stack(ys)

    def dynamic_slice(self, x, start, size: int, axis=0):
        start = int(np.clip(start, 0, x.shape[axis] - size))
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, start + size)
        return x[tuple(idx)]

    dynamic_slice_bits = dynamic_slice

    def dynamic_update_slice(self, x, upd, start, axis=0):
        start = int(np.clip(start, 0, x.shape[axis] - upd.shape[axis]))
        out = x.copy()
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, start + upd.shape[axis])
        out[tuple(idx)] = upd
        return out

    dynamic_update_slice_bits = dynamic_update_slice

    def select_pmask(self, mask, x, y):
        """Plaintext 0/1 mask select (public positions, no crypto cost)."""
        return np.where(np.asarray(mask) != 0, x, y).astype(np.uint8)

    select_pmask_bits = select_pmask

    def mul_pmask(self, x, mask):
        return (x * np.asarray(mask).astype(np.uint8)).astype(np.uint8)

    mul_pmask_bits = mul_pmask

    def trivial_bits_dyn(self, v):
        """Trivial bit encryption of a runtime-computed plaintext value."""
        return np.asarray(v, dtype=np.uint8) & np.uint8(1)

    def declare(self, x, degree: int, noise_var: float):
        """Fix static (degree, noise) metadata — identity on plaintext."""
        return x

    declare_bits = declare

    # -- constructors / structure ------------------------------------------
    def trivial_chars(self, values):
        return np.asarray(values, dtype=np.uint8)

    def trivial_bits(self, values):
        return np.asarray(values, dtype=np.uint8) & np.uint8(1)

    def shape(self, x):
        return x.shape

    def concat(self, xs, axis=0):
        return np.concatenate(xs, axis=axis)

    def stack(self, xs, axis=0):
        return np.stack(xs, axis=axis)

    def take(self, x, idx, axis=0):
        return np.take(x, idx, axis=axis)

    def reshape(self, x, shape):
        return x.reshape(shape)

    def reshape_bits(self, x, shape):
        return x.reshape(shape)

    def shape_bits(self, x):
        return x.shape

    def broadcast_to(self, x, shape):
        return np.broadcast_to(x, shape)

    def zeros_chars(self, shape):
        return np.zeros(shape, dtype=np.uint8)

    # -- char ops -------------------------------------------------------------
    def eq(self, x, y):
        return (x == y).astype(np.uint8)

    def ne(self, x, y):
        return (x != y).astype(np.uint8)

    def lt(self, x, y):
        return (x < y).astype(np.uint8)

    def le(self, x, y):
        return (x <= y).astype(np.uint8)

    def gt(self, x, y):
        return (x > y).astype(np.uint8)

    def ge(self, x, y):
        return (x >= y).astype(np.uint8)

    def select(self, c, x, y):
        return np.where(c != 0, x, y).astype(np.uint8)

    def mul_bit(self, x, b):
        return (x * b).astype(np.uint8)

    def add_chars(self, x, y):
        return (x.astype(np.int32) + y).astype(np.uint8)

    def sub_chars(self, x, y):
        return (x.astype(np.int32) - y).astype(np.uint8)

    def ne_zero(self, x):
        return (x != 0).astype(np.uint8)

    def eq_zero(self, x):
        return (x == 0).astype(np.uint8)

    def is_whitespace(self, x):
        return np.isin(x, [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20]).astype(np.uint8)

    def is_uppercase(self, x):
        return ((x >= 0x41) & (x <= 0x5A)).astype(np.uint8)

    def is_lowercase(self, x):
        return ((x >= 0x61) & (x <= 0x7A)).astype(np.uint8)

    def to_upper(self, x):
        return (x - 32 * self.is_lowercase(x)).astype(np.uint8)

    def to_lower(self, x):
        return (x + 32 * self.is_uppercase(x)).astype(np.uint8)

    # -- bit ops ---------------------------------------------------------------
    def and_(self, a, b):
        return (a & b).astype(np.uint8)

    def or_(self, a, b):
        return (a | b).astype(np.uint8)

    def not_(self, a):
        return (1 - a).astype(np.uint8)

    def any_axis(self, bits, axis):
        return bits.any(axis=axis).astype(np.uint8)

    def all_axis(self, bits, axis):
        return bits.all(axis=axis).astype(np.uint8)

    def cum_or(self, bits, axis, reverse=False, exclusive=False):
        b = bits
        if reverse:
            b = np.flip(b, axis=axis)
        out = np.maximum.accumulate(b, axis=axis)
        if exclusive:
            shifted = np.roll(out, 1, axis=axis)
            idx = [slice(None)] * out.ndim
            idx[axis] = 0
            shifted[tuple(idx)] = 0
            out = shifted
        if reverse:
            out = np.flip(out, axis=axis)
        return out.astype(np.uint8)

    def sum_bits(self, bits, axis):
        return bits.sum(axis=axis).astype(np.uint8)

    def cumsum_bits(self, bits, axis):
        """Inclusive prefix count of bits, as u8 chars."""
        return np.cumsum(bits, axis=axis).astype(np.uint8)

    def weighted_onehot_sum(self, onehot, weights, axis):
        """sum_i onehot_i * weights_i along axis; onehot has <= 1 set."""
        w = np.asarray(weights, dtype=np.uint8)
        shape = [1] * onehot.ndim
        shape[axis] = len(w)
        return (onehot * w.reshape(shape)).sum(axis=axis).astype(np.uint8)

    def sum_onehot_chars(self, chars, axis):
        """Sum chars along axis when at most one is nonzero."""
        return chars.sum(axis=axis, dtype=np.int32).astype(np.uint8)

    # -- linear (PBS-free in FHE) helpers for oblivious routing -------------
    def char_bit(self, x, k: int):
        """Bit k of a char value, as a bit tensor."""
        return ((x >> k) & 1).astype(np.uint8)

    def char_bits(self, x, nbits: int):
        """Bits 0..nbits-1 of a char value, stacked on a new leading axis."""
        ks = np.arange(nbits).reshape((nbits,) + (1,) * x.ndim)
        return ((x[None] >> ks) & 1).astype(np.uint8)

    def sub_exact(self, x, y):
        """x - y, valid when y's value is <= x's blockwise (e.g. y = x*m)."""
        return (x - y).astype(np.uint8)

    sub_exact_bits = sub_exact

    def add_nooverlap(self, x, y):
        """x + y when at most one is nonzero per slot (no carries)."""
        return (x + y).astype(np.uint8)

    add_nooverlap_bits = add_nooverlap


# =============================================================================
# FHE backend
# =============================================================================

class FheBackend:
    """Real TFHE on torch tensors: CT = Blocks [..., 4, kN+1], BT = Blocks
    [...]."""

    name = "fhe"
    xp = np  # plaintext index math inside the (eager) scan bodies

    def __init__(self, rc: RadixContext):
        self.rc = rc
        self.sc: ShortintContext = rc.sc

    # -- scan / dynamic indexing (engine sequential kernels) -----------------
    def scan(self, body, carry, xs: dict, length: int):
        """The engine's sequential hot loops as a Python loop: the spec is
        ClearBackend.scan.  Every step runs eagerly, so each PBS inside the
        body is dispatched, and counted, once per step."""
        metrics.count(scan_steps=length)
        with metrics.span("engine.scan", steps=length):
            for i in range(length):
                carry = body(carry, {k: v[i] for k, v in xs.items()})
        return carry

    def scan_out(self, body, carry, xs: dict, length: int):
        """scan with the per-step Blocks outputs stacked along a new leading
        axis (the engine keeps their metadata constant with declare)."""
        ys = []
        metrics.count(scan_steps=length)
        with metrics.span("engine.scan", steps=length):
            for i in range(length):
                carry, y = body(carry, {k: v[i] for k, v in xs.items()})
                ys.append(y)
        return carry, Blocks(torch.stack([y.ct for y in ys]),
                             max(y.degree for y in ys),
                             max(y.noise_var for y in ys))

    @staticmethod
    def _raw_axis(x: Blocks, axis: int, tail: int) -> int:
        ax = axis if axis >= 0 else axis - tail
        return ax + x.ct.dim() if ax < 0 else ax

    def _dyn_slice(self, x: Blocks, start, size: int, axis: int, tail: int):
        """Slice with the start clamped into range, as jax.lax.dynamic_slice
        and ClearBackend.dynamic_slice do."""
        ax = self._raw_axis(x, axis, tail)
        start = int(np.clip(int(start), 0, x.ct.shape[ax] - size))
        return Blocks(x.ct.narrow(ax, start, size), x.degree, x.noise_var)

    def dynamic_slice(self, x: Blocks, start, size: int, axis=0):
        return self._dyn_slice(x, start, size, axis, tail=2)

    def dynamic_slice_bits(self, x: Blocks, start, size: int, axis=0):
        return self._dyn_slice(x, start, size, axis, tail=1)

    def _dyn_update(self, x: Blocks, upd: Blocks, start, axis: int, tail: int):
        """Copy of x with upd written at start (clamped as in
        jax.lax.dynamic_update_slice)."""
        ax = self._raw_axis(x, axis, tail)
        size = upd.ct.shape[ax]
        start = int(np.clip(int(start), 0, x.ct.shape[ax] - size))
        out = x.ct.clone()
        out.narrow(ax, start, size).copy_(upd.ct)
        return Blocks(out, max(x.degree, upd.degree),
                      max(x.noise_var, upd.noise_var))

    def dynamic_update_slice(self, x: Blocks, upd: Blocks, start, axis=0):
        return self._dyn_update(x, upd, start, axis, tail=2)

    def dynamic_update_slice_bits(self, x: Blocks, upd: Blocks, start, axis=0):
        return self._dyn_update(x, upd, start, axis, tail=1)

    def _pmask(self, mask, tail: int) -> torch.Tensor:
        m = np.asarray(mask) != 0
        return torus.to_device(
            torch.from_numpy(m.reshape(m.shape + (1,) * tail)), self.sc.device)

    def _pmask_where(self, mask, x: Blocks, y: Blocks, tail: int):
        """Select by a PLAINTEXT 0/1 mask: pure torus where, no PBS and no
        noise cost (the positions are public, the values stay encrypted)."""
        return Blocks(torch.where(self._pmask(mask, tail), x.ct, y.ct),
                      max(x.degree, y.degree), max(x.noise_var, y.noise_var))

    def select_pmask(self, mask, x: Blocks, y: Blocks):
        return self._pmask_where(mask, x, y, tail=2)

    def select_pmask_bits(self, mask, x: Blocks, y: Blocks):
        return self._pmask_where(mask, x, y, tail=1)

    def mul_pmask(self, x: Blocks, mask):
        return self._mul_pmask(x, mask, tail=2)

    def mul_pmask_bits(self, x: Blocks, mask):
        return self._mul_pmask(x, mask, tail=1)

    def _mul_pmask(self, x: Blocks, mask, tail: int):
        out = torch.where(self._pmask(mask, tail), x.ct,
                          torch.zeros_like(x.ct))
        return Blocks(out, x.degree, x.noise_var)

    def trivial_bits_dyn(self, v):
        """Trivial bit of a plaintext value computed at run time: delta*v at
        the body coefficient."""
        p = self.sc.params
        v = np.asarray(v)
        ct = np.zeros(v.shape + (p.big_lwe_dimension + 1,), np.uint64)
        ct[..., -1] = (v != 0).astype(np.uint64) * np.uint64(p.delta)
        return Blocks(torus.to_device(torus.from_numpy(ct), self.sc.device),
                      1, 0.0)

    def declare(self, x: Blocks, degree: int, noise_var: float) -> Blocks:
        """Widen (degree, noise) metadata to fixed scan-carry values.
        Sound because both only ever bound the true plaintext/noise."""
        assert x.degree <= degree and x.noise_var <= noise_var + 1e-9, (
            x.degree, x.noise_var, degree, noise_var)
        return Blocks(x.ct, degree, noise_var)

    declare_bits = declare

    # -- constructors / structure ------------------------------------------
    def trivial_chars(self, values):
        return self.rc.trivial_chars(np.asarray(values, dtype=np.uint64))

    def trivial_bits(self, values):
        return self.rc.trivial_bits(np.asarray(values, dtype=np.uint64))

    def shape(self, x: Blocks):
        """Batch shape of a CHAR tensor ([..., NB, kN+1]).

        Chars and bits are distinguished by call-site contract, never by
        shape sniffing; use shape_bits for bit tensors."""
        return tuple(x.ct.shape[:-2])

    def shape_bits(self, x: Blocks):
        """Batch shape of a BITS tensor ([..., kN+1])."""
        return tuple(x.ct.shape[:-1])

    def _map(self, fn, *xs: Blocks) -> Blocks:
        out = fn(*[x.ct for x in xs])
        return Blocks(out, max(x.degree for x in xs), max(x.noise_var for x in xs))

    def concat(self, xs, axis=0):
        return self._map(lambda *cts: torch.cat(cts, dim=axis), *xs)

    def stack(self, xs, axis=0):
        assert axis >= 0, "use non-negative axes for stack"
        return self._map(lambda *cts: torch.stack(cts, dim=axis), *xs)

    def take(self, x: Blocks, idx, axis=0):
        """np.take semantics along a raw ct axis (idx may be any shape).

        Indexes with the flat index and then shapes the result: indexing
        with a 0-d index tensor would read it back to the host, which waits
        for the card."""
        axis = axis % x.ct.dim()
        index = torus.to_device(
            torch.as_tensor(np.asarray(idx), dtype=torch.int64), x.ct.device)
        out = x.ct[(slice(None),) * axis + (index.reshape(-1),)]
        shape = x.ct.shape[:axis] + index.shape + x.ct.shape[axis + 1:]
        return Blocks(out.reshape(shape), x.degree, x.noise_var)

    def reshape(self, x: Blocks, shape):
        """Reshape the batch dims of a CHAR tensor (tail [NB, kN+1] kept)."""
        return Blocks(x.ct.reshape(tuple(shape) + x.ct.shape[-2:]), x.degree,
                      x.noise_var)

    def reshape_bits(self, x: Blocks, shape):
        """Reshape the batch dims of a BITS tensor (tail [kN+1] kept)."""
        return Blocks(x.ct.reshape(tuple(shape) + x.ct.shape[-1:]), x.degree,
                      x.noise_var)

    def broadcast_to(self, x: Blocks, shape):
        """Broadcast the batch dims of a CHAR tensor."""
        return Blocks(x.ct.expand(tuple(shape) + x.ct.shape[-2:]), x.degree,
                      x.noise_var)

    def zeros_chars(self, shape):
        return self.trivial_chars(np.zeros(shape, dtype=np.uint64))

    # -- char ops ---------------------------------------------------------------
    def eq(self, x, y):
        return self.rc.eq(*self._align(x, y))

    def ne(self, x, y):
        return self.rc.ne(*self._align(x, y))

    def lt(self, x, y):
        return self.rc.lt(*self._align(x, y))

    def le(self, x, y):
        return self.rc.le(*self._align(x, y))

    def gt(self, x, y):
        return self.rc.gt(*self._align(x, y))

    def ge(self, x, y):
        return self.rc.ge(*self._align(x, y))

    def _align(self, x: Blocks, y: Blocks):
        """Broadcast two char tensors to a common batch shape."""
        sx, sy = self.shape(x), self.shape(y)
        common = np.broadcast_shapes(sx, sy)
        if sx != common:
            x = self.broadcast_to(x, common)
        if sy != common:
            y = self.broadcast_to(y, common)
        return x, y

    def _align_bit(self, c: Blocks, target_shape):
        if tuple(self.shape_bits(c)) != tuple(target_shape):
            c = Blocks(c.ct.expand(tuple(target_shape) + c.ct.shape[-1:]),
                       c.degree, c.noise_var)
        return c

    def select(self, c, x, y):
        x, y = self._align(x, y)
        c = self._align_bit(c, self.shape(x))
        return self.rc.select(c, x, y)

    def mul_bit(self, x, b):
        b = self._align_bit(b, self.shape(x))
        return self.rc.mul_bit(x, b)

    def add_chars(self, x, y):
        return self.rc.add_chars(*self._align(x, y))

    def sub_chars(self, x, y):
        return self.rc.sub_chars(*self._align(x, y))

    def ne_zero(self, x):
        return self.rc.ne_zero(x)

    def eq_zero(self, x):
        return self.rc.eq_zero(x)

    def is_whitespace(self, x):
        return self.rc.is_whitespace(x)

    def is_uppercase(self, x):
        return self.rc.is_uppercase(x)

    def is_lowercase(self, x):
        return self.rc.is_lowercase(x)

    def to_upper(self, x):
        return self.rc.to_upper_char(x)

    def to_lower(self, x):
        return self.rc.to_lower_char(x)

    # -- bit ops -----------------------------------------------------------------
    def and_(self, a, b):
        a, b = self._align_bits(a, b)
        return self.rc.and_(a, b)

    def or_(self, a, b):
        a, b = self._align_bits(a, b)
        return self.rc.or_(a, b)

    def _align_bits(self, a: Blocks, b: Blocks):
        common = np.broadcast_shapes(self.shape_bits(a), self.shape_bits(b))
        return self._align_bit(a, common), self._align_bit(b, common)

    def not_(self, a):
        return self.rc.not_(a)

    def any_axis(self, bits, axis):
        return self.rc.any_axis(bits, axis)

    def all_axis(self, bits, axis):
        return self.rc.all_axis(bits, axis)

    def cum_or(self, bits: Blocks, axis, reverse=False, exclusive=False):
        """Hillis-Steele prefix OR scan (log-depth)."""
        n = bits.ct.shape[axis if axis >= 0 else axis - 1]
        if axis < 0:
            axis = bits.ct.dim() - 1 + axis
        cur = bits
        shift = 1
        while shift < n:
            cur = self.rc.or_(cur, Blocks(_shifted(cur.ct, axis, shift, reverse),
                                          cur.degree, cur.noise_var))
            shift *= 2
        if exclusive:
            cur = Blocks(_shifted(cur.ct, axis, 1, reverse), cur.degree,
                         cur.noise_var)
        return cur

    def sum_bits(self, bits, axis):
        return self.rc.sum_bits(bits, axis)

    def _cumsum_chars(self, chars: Blocks, axis: int) -> Blocks:
        """Inclusive prefix sum of chars, Hillis-Steele with radix adds
        (7 PBS/position/stage). axis indexes the RAW ct tensor."""
        n = chars.ct.shape[axis]
        cur = chars
        shift = 1
        while shift < n:
            shifted = Blocks(_shifted(cur.ct, axis, shift), cur.degree,
                             cur.noise_var)
            cur = self.rc.add_chars(cur, shifted)
            shift *= 2
        return cur

    def cumsum_bits(self, bits: Blocks, axis):
        """Inclusive prefix count of bits, as u8 chars.

        Grouped carry-save scan: within groups of up to 15 positions the
        inclusive prefixes are pure linear torus shift-adds (degree <= 15);
        ONE LUT pair then extracts every in-group prefix to (mod 4, div 4)
        radix blocks; only the G = ceil(L/g) group totals pay the full radix
        Hillis-Steele, and a final radix add recombines base + in-group."""
        sc = self.sc
        nd = bits.ct.dim()
        if axis < 0:
            axis = nd - 1 + axis
        # the in-group linear sums must stay in one block's value space
        # (degree*g <= 15) AND inside the noise budget at the extraction LUT
        if bits.noise_var * 2 > sc.max_noise_var:
            bits = sc.apply_lut(bits, list(range(16)))  # value-preserving
        ct = bits.ct.movedim(axis, -2)
        L = ct.shape[-2]
        g = max(2, min(15 // max(bits.degree, 1),
                       int(sc.max_noise_var //
                           max(bits.noise_var, 1e-9))))
        assert g * max(bits.degree, 1) <= 15, (g, bits.degree)
        G = -(-L // g)
        pad = G * g - L
        if pad:
            ct = torch.cat([ct, ct.new_zeros(ct.shape[:-2] + (pad,)
                                             + ct.shape[-1:])], dim=-2)
        gs = tuple(ct.shape[:-2]) + (G, g) + tuple(ct.shape[-1:])
        cur = ct.reshape(gs)
        s = 1
        while s < g:  # in-group inclusive prefix: linear, zero PBS
            cur = cur + _shifted(cur, cur.dim() - 2, s)
            s *= 2
        pref = Blocks(cur, min(15, max(1, bits.degree) * g),
                      bits.noise_var * g)
        # ONE multi-table batch extracts both radix blocks (mod 4, div 4)
        # of every in-group prefix
        pref2 = Blocks(torch.stack([pref.ct, pref.ct]), pref.degree,
                       pref.noise_var)
        idx = np.broadcast_to(
            np.arange(2).reshape((2,) + (1,) * (len(gs) - 1)), (2,) + gs[:-1])
        both = sc.apply_lut_multi(
            pref2, ([v % 4 for v in range(16)], [v // 4 for v in range(16)]),
            idx)
        low = Blocks(both.ct[0], both.degree, both.noise_var)   # [.., G, g]
        high = Blocks(both.ct[1], both.degree, both.noise_var)
        zblk = sc.trivial(np.zeros(gs[:-1], np.uint64))
        ingroup = self.rc.from_blocks([low, high, zblk, zblk])  # chars
        if G > 1:
            # group totals = in-group prefix at position g-1, as chars
            tot = Blocks(ingroup.ct[..., g - 1, :, :], ingroup.degree,
                         ingroup.noise_var)
            inc = self._cumsum_chars(tot, axis=tot.ct.dim() - 3)
            base = _shifted(inc.ct, inc.ct.dim() - 3, 1)
            bexp = Blocks(base[..., :, None, :, :].expand(ingroup.ct.shape),
                          inc.degree, inc.noise_var)
            out = self.rc.add_chars(ingroup, bexp)
        else:
            out = ingroup
        flat = out.ct.reshape(out.ct.shape[:-4] + (G * g,)
                              + out.ct.shape[-2:])[..., :L, :, :]
        return Blocks(flat.movedim(-3, axis), out.degree, out.noise_var)

    def weighted_onehot_sum(self, onehot: Blocks, weights, axis):
        """sum_i onehot_i * w_i via per-bitplane ORs (no noise blowup)."""
        w = np.asarray(weights, dtype=np.uint64)
        if axis < 0:
            axis = onehot.ct.dim() - 1 + axis
        blocks = []
        for b in range(NB):
            wb = ((w >> np.uint64(2 * b)) & np.uint64(3)).astype(np.int64)
            parts = []
            for bitpos, bitval in ((0, 1), (1, 2)):
                cols = np.nonzero((wb >> bitpos) & 1)[0]
                if len(cols) == 0:
                    continue
                sub = self.take(onehot, cols, axis=axis)
                anyb = self.rc.any_axis(sub, axis)
                parts.append(self.sc.scalar_mul(anyb, bitval))
            if not parts:
                shape = (onehot.ct.shape[:axis]
                         + onehot.ct.shape[axis + 1:-1])
                blocks.append(self.sc.trivial(np.zeros(shape, np.uint64)))
            elif len(parts) == 1:
                blocks.append(parts[0])
            else:
                blocks.append(self.sc.add(parts[0], parts[1]))
        return self.rc.from_blocks(blocks)

    def sum_onehot_chars(self, chars: Blocks, axis):
        """Sum chars along axis when at most one is nonzero: grouped linear
        sums with refresh bootstraps to bound noise."""
        if axis < 0:
            axis = len(self.shape(chars)) + axis
        cur = chars
        while cur.ct.shape[axis] > 1:
            n = cur.ct.shape[axis]
            g = max(2, min(n, int(self.sc.max_noise_var // max(cur.noise_var, 1e-9))))
            pad = (-n) % g
            ct = cur.ct
            if pad:
                zshape = list(ct.shape)
                zshape[axis] = pad
                ct = torch.cat([ct, ct.new_zeros(zshape)], dim=axis)
            shape = list(ct.shape)
            shape[axis:axis + 1] = [shape[axis] // g, g]
            summed = torus.sum_axis(ct.reshape(shape), axis + 1)
            cur = Blocks(summed, 3, cur.noise_var * g)
            if cur.noise_var * 16 + 2 > self.sc.max_noise_var and cur.ct.shape[axis] > 1:
                cur = self.sc.apply_lut(cur, list(range(4)) * 4)
        out = Blocks(cur.ct.squeeze(axis), 3, cur.noise_var)
        if out.noise_var * 16 + 2 > self.sc.max_noise_var:
            out = self.sc.apply_lut(out, list(range(4)) * 4)
        return out

    # -- linear (PBS-free) helpers for oblivious routing ---------------------
    def char_bit(self, x: Blocks, k: int) -> Blocks:
        """Bit k of a char value as an encrypted bit: ONE LUT on block k//2
        (each 2-bit radix block holds bits 2j, 2j+1)."""
        blk = self.rc.block(x, k // 2)
        tab = [(v >> (k % 2)) & 1 if v < 4 else 0 for v in range(16)]
        return self.sc.apply_lut(blk, tab)

    def char_bits(self, x: Blocks, nbits: int) -> Blocks:
        """Bits 0..nbits-1 stacked on a new leading axis, in ONE PBS batch:
        gather each bit's source block, then a multi-table LUT selecting
        the even/odd bit table per plane."""
        blks = [self.rc.block(x, k // 2) for k in range(nbits)]
        stacked = Blocks(torch.stack([b.ct for b in blks]),
                         max(b.degree for b in blks),
                         max(b.noise_var for b in blks))
        tabs = ([(v & 1) if v < 4 else 0 for v in range(16)],
                [((v >> 1) & 1) if v < 4 else 0 for v in range(16)])
        idx = np.broadcast_to(
            (np.arange(nbits) % 2).reshape((nbits,) + (1,) * (stacked.ct.dim() - 2)),
            stacked.ct.shape[:-1])
        return self.sc.apply_lut_multi(stacked, tabs, idx)

    def sub_exact(self, x: Blocks, y: Blocks) -> Blocks:
        """x - y when y's blocks are each <= x's blocks (e.g. y = mul_bit(
        x, m)): pure torus subtraction — zero PBS, noise adds."""
        return Blocks(x.ct - y.ct, x.degree, x.noise_var + y.noise_var)

    sub_exact_bits = sub_exact

    def add_nooverlap(self, x: Blocks, y: Blocks) -> Blocks:
        """x + y when at most one operand is nonzero per slot (oblivious
        routing invariant): pure torus add — zero PBS, no carries needed."""
        return Blocks(x.ct + y.ct, max(x.degree, y.degree),
                      x.noise_var + y.noise_var)

    add_nooverlap_bits = add_nooverlap


def _shifted(ct: torch.Tensor, axis: int, shift: int,
             reverse: bool = False) -> torch.Tensor:
    """ct shifted by `shift` along `axis` (towards higher indices, or lower
    when reverse), zero-filled: the Hillis-Steele step."""
    n = ct.shape[axis]
    zeros = ct.new_zeros(ct.shape[:axis] + (min(shift, n),)
                         + ct.shape[axis + 1:])
    if reverse:
        return torch.cat([ct.narrow(axis, min(shift, n), n - min(shift, n)),
                          zeros], dim=axis)
    return torch.cat([zeros, ct.narrow(axis, 0, n - min(shift, n))], dim=axis)
