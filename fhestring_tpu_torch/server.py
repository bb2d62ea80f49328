"""Server-side API: the typed facade over the string engine.

Method-for-method parity with the reference's MyServerKey
(src/server_key/mod.rs, split.rs, trim.rs; full surface listed in
SURVEY.md section 2.2): every encrypted method plus its ``*_clear``
plaintext-pattern twin (clear patterns become trivial ciphertexts, exactly
like the reference, e.g. mod.rs:198-211).

The server never sees plaintext or secret keys — it holds only the packed
evaluation keys (bootstrap + keyswitch).

Each public method is one ``server.<method>`` span while the span recorder
is on (``metrics.record_spans``); a method called from inside another
records none, and the span ends after a synchronise of the key's device
(a ``sync`` span of its own), so that it holds the method's device work.
While the recorder is off the server does not synchronise.

The outermost public method of a thread is one member of the shortint
layer's coalescer from its start to its return (``batching``): while
several threads are inside methods of one ``ServerKey``, their PBS batches
go to the card merged.  So a ``ServerKey`` may be called from several
threads at once, as ``service.FheStringServer`` calls it.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from . import metrics
from .ciphertext import FheChar, FheSplit, FheString, FheStrip
from .crypto.keys import DeviceServerKeys
from .engine.backend import FheBackend
from .engine.strings import StringEngine
from .params import CryptoParams
from .radix import RadixContext
from .shortint import ShortintContext


class ServerKey:
    def __init__(self, device_keys: DeviceServerKeys, params: CryptoParams):
        self.params = params
        self.backend = FheBackend(RadixContext(ShortintContext(device_keys)))
        self.engine = StringEngine(self.backend)

    # ---- helpers ---------------------------------------------------------
    def _trivial_pattern(self, text: str):
        """Clear patterns as trivial ciphertexts (reference mod.rs:204-208)."""
        data = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        return self.backend.trivial_chars(data.astype(np.uint64))

    def _pat(self, pattern: FheString):
        return pattern.blocks

    def _bit_char(self, bit) -> FheChar:
        return FheChar(self.engine._bit_to_char(bit))

    def _char(self, chars) -> FheChar:
        return FheChar(chars)

    def trivial_char(self, value: int) -> FheChar:
        return FheChar(self.backend.trivial_chars(np.uint64(value)))

    # ---- predicates -------------------------------------------------------
    def contains(self, s: FheString, pattern: FheString) -> FheChar:
        return self._bit_char(self.engine.contains(s.blocks, self._pat(pattern)))

    def contains_clear(self, s: FheString, pattern: str) -> FheChar:
        return self._bit_char(
            self.engine.contains(s.blocks, self._trivial_pattern(pattern)))

    def starts_with(self, s: FheString, pattern: FheString) -> FheChar:
        return self._bit_char(self.engine.starts_with(s.blocks, self._pat(pattern)))

    def starts_with_clear(self, s: FheString, pattern: str) -> FheChar:
        return self._bit_char(
            self.engine.starts_with(s.blocks, self._trivial_pattern(pattern)))

    def ends_with(self, s: FheString, pattern: FheString) -> FheChar:
        return self._bit_char(self.engine.ends_with(s.blocks, self._pat(pattern)))

    def ends_with_clear(self, s: FheString, pattern: str) -> FheChar:
        return self._bit_char(
            self.engine.ends_with(s.blocks, self._trivial_pattern(pattern)))

    def is_empty(self, s: FheString) -> FheChar:
        return self._bit_char(self.engine.is_empty(s.blocks))

    def len(self, s: FheString) -> FheChar:
        return self._char(self.engine.len(s.blocks))

    def eq(self, s: FheString, t: FheString) -> FheChar:
        return self._bit_char(self.engine.eq_strings(s.blocks, t.blocks))

    def ne(self, s: FheString, t: FheString) -> FheChar:
        return self._bit_char(self.engine.ne_strings(s.blocks, t.blocks))

    def eq_ignore_case(self, s: FheString, t: FheString) -> FheChar:
        return self._bit_char(self.engine.eq_ignore_case(s.blocks, t.blocks))

    def lt(self, s: FheString, t: FheString) -> FheChar:
        return self._bit_char(self.engine.compare(s.blocks, t.blocks, "lt"))

    def le(self, s: FheString, t: FheString) -> FheChar:
        return self._bit_char(self.engine.compare(s.blocks, t.blocks, "le"))

    def gt(self, s: FheString, t: FheString) -> FheChar:
        return self._bit_char(self.engine.compare(s.blocks, t.blocks, "gt"))

    def ge(self, s: FheString, t: FheString) -> FheChar:
        return self._bit_char(self.engine.compare(s.blocks, t.blocks, "ge"))

    # ---- search -------------------------------------------------------------
    def find(self, s: FheString, pattern: FheString) -> FheChar:
        return self._char(self.engine.find(s.blocks, self._pat(pattern)))

    def find_clear(self, s: FheString, pattern: str) -> FheChar:
        return self._char(
            self.engine.find(s.blocks, self._trivial_pattern(pattern)))

    def rfind(self, s: FheString, pattern: FheString) -> FheChar:
        return self._char(self.engine.rfind(s.blocks, self._pat(pattern)))

    def rfind_clear(self, s: FheString, pattern: str) -> FheChar:
        return self._char(
            self.engine.rfind(s.blocks, self._trivial_pattern(pattern)))

    # ---- rewriting ------------------------------------------------------------
    def to_upper(self, s: FheString) -> FheString:
        return FheString(self.engine.to_upper(s.blocks))

    def to_lower(self, s: FheString) -> FheString:
        return FheString(self.engine.to_lower(s.blocks))

    def concatenate(self, s: FheString, t: FheString) -> FheString:
        return FheString(self.engine.concatenate(s.blocks, t.blocks))

    def repeat_clear(self, s: FheString, n: int) -> FheString:
        return FheString(self.engine.repeat_clear(s.blocks, n))

    def repeat(self, s: FheString, n: FheChar) -> FheString:
        return FheString(self.engine.repeat(s.blocks, n.blocks))

    def replace(self, s: FheString, frm: FheString, to: FheString) -> FheString:
        return FheString(self.engine.replace(s.blocks, frm.blocks, to.blocks))

    def replace_clear(self, s: FheString, frm: str, to: str) -> FheString:
        return FheString(self.engine.replace(
            s.blocks, self._trivial_pattern(frm), self._trivial_pattern(to)))

    def replacen(self, s: FheString, frm: FheString, to: FheString,
                 n: FheChar) -> FheString:
        return FheString(self.engine.replace(s.blocks, frm.blocks, to.blocks,
                                             n_enc=n.blocks))

    def replacen_clear(self, s: FheString, frm: str, to: str, n: int) -> FheString:
        return FheString(self.engine.replace(
            s.blocks, self._trivial_pattern(frm), self._trivial_pattern(to),
            n_enc=self.backend.trivial_chars(np.uint64(n))))

    def trim(self, s: FheString) -> FheString:
        return FheString(self.engine.trim(s.blocks))

    def trim_start(self, s: FheString) -> FheString:
        return FheString(self.engine.trim_start(s.blocks))

    def trim_end(self, s: FheString) -> FheString:
        return FheString(self.engine.trim_end(s.blocks))

    # ---- strip ------------------------------------------------------------------
    def strip_prefix(self, s: FheString, pattern: FheString) -> FheStrip:
        out, flag = self.engine.strip_prefix(s.blocks, self._pat(pattern))
        return FheStrip(FheString(out), self._bit_char(flag))

    def strip_prefix_clear(self, s: FheString, pattern: str) -> FheStrip:
        out, flag = self.engine.strip_prefix(s.blocks, self._trivial_pattern(pattern))
        return FheStrip(FheString(out), self._bit_char(flag))

    def strip_suffix(self, s: FheString, pattern: FheString) -> FheStrip:
        out, flag = self.engine.strip_suffix(s.blocks, self._pat(pattern))
        return FheStrip(FheString(out), self._bit_char(flag))

    def strip_suffix_clear(self, s: FheString, pattern: str) -> FheStrip:
        out, flag = self.engine.strip_suffix(s.blocks, self._trivial_pattern(pattern))
        return FheStrip(FheString(out), self._bit_char(flag))

    # ---- splits -------------------------------------------------------------------
    def _mk_split(self, buffers, found) -> FheSplit:
        return FheSplit(buffers, self._bit_char(found))

    def split(self, s, pattern: FheString) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._pat(pattern), False, False, None))

    def split_clear(self, s, pattern: str) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._trivial_pattern(pattern), False, False, None))

    def split_inclusive(self, s, pattern: FheString) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._pat(pattern), True, False, None))

    def split_inclusive_clear(self, s, pattern: str) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._trivial_pattern(pattern), True, False, None))

    def split_terminator(self, s, pattern: FheString) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._pat(pattern), False, True, None))

    def split_terminator_clear(self, s, pattern: str) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._trivial_pattern(pattern), False, True, None))

    def splitn(self, s, pattern: FheString, n: FheChar) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._pat(pattern), False, False, n.blocks,
            skip_first_edge=True))

    def splitn_clear(self, s, pattern: str, n: int) -> FheSplit:
        return self._mk_split(*self.engine._split(
            s.blocks, self._trivial_pattern(pattern), False, False,
            self.backend.trivial_chars(np.uint64(n)), skip_first_edge=True))

    def rsplit(self, s, pattern: FheString) -> FheSplit:
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._pat(pattern), False, False, None))

    def rsplit_clear(self, s, pattern: str) -> FheSplit:
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._trivial_pattern(pattern), False, False, None))

    def rsplitn(self, s, pattern: FheString, n: FheChar) -> FheSplit:
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._pat(pattern), False, False, n.blocks))

    def rsplitn_clear(self, s, pattern: str, n: int) -> FheSplit:
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._trivial_pattern(pattern), False, False,
            self.backend.trivial_chars(np.uint64(n))))

    def rsplit_once(self, s, pattern: FheString) -> FheSplit:
        """n = 2, reference split.rs:681-694."""
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._pat(pattern), False, False,
            self.backend.trivial_chars(np.uint64(2))))

    def rsplit_once_clear(self, s, pattern: str) -> FheSplit:
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._trivial_pattern(pattern), False, False,
            self.backend.trivial_chars(np.uint64(2))))

    def rsplit_terminator(self, s, pattern: FheString) -> FheSplit:
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._pat(pattern), False, True, None))

    def rsplit_terminator_clear(self, s, pattern: str) -> FheSplit:
        return self._mk_split(*self.engine._rsplit(
            s.blocks, self._trivial_pattern(pattern), False, True, None))

    def split_ascii_whitespace(self, s: FheString) -> FheSplit:
        return self._mk_split(*self.engine.split_ascii_whitespace(s.blocks))


_inside = threading.local()    # .method: a public method is running


def _traced(name: str, method):
    label = f"server.{name}"

    @functools.wraps(method)
    def traced(self, *args):
        if getattr(_inside, "method", False):
            return method(self, *args)
        sc = self.backend.sc
        _inside.method = True
        sc.batches.enter()
        try:
            with metrics.span(label) as span:
                try:
                    out = method(self, *args)
                finally:
                    # before the sync, so that no other request's batch
                    # waits on it
                    sc.batches.leave()
                if span is not None and sc.device.type == "cuda":
                    with metrics.span("sync"):
                        torch.cuda.synchronize(sc.device)
            return out
        finally:
            _inside.method = False
    return traced


for _name, _method in list(vars(ServerKey).items()):
    if not _name.startswith("_") and callable(_method):
        setattr(ServerKey, _name, _traced(_name, _method))
del _name, _method
