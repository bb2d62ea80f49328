"""All 52 method variants of the ported CLI against the JAX package, at the
32-bit CI set PARAM_TEST32_ZERO_NOISE.

Each variant goes through ``run_fhe_str_method`` of both packages' ``cli.py``
with the arguments of benchmarks/methods.py ("hello world", "ello", n = 2,
from "o", to "0").  Both runs see the same evaluation keys (the port's
ServerKey is packed from the JAX ClientKey's raw keys) and the same input
ciphertexts: the six inputs a method encrypts are encrypted once by the JAX
client and handed to both servers, the port's as tensors of the same u64
words.

Three tiers, because the 52 variants are 279,080 bootstraps on these
strings (378,208 at the 64-bit set) and a bootstrap costs some 7 ms in the
JAX package and 27 ms in the port's plain PyTorch path on one CPU core:

- ``test_variant_counts_match_jax_package`` (all 52): both engines run
  the variant with the bootstrap itself replaced by the identity (the
  engine's control flow, shapes and noise tracking never depend on
  ciphertext values), and ``metrics.GLOBAL`` must have counted the same
  PBS calls, items and padded items.  This executes every line of the
  port's engine that the variant reaches, in seconds.
- ``test_variant_matches_jax_package`` (the 24 variants of ``REAL``: all
  with at most 250 bootstraps, and EndsWith, StripSuffix, StripPrefix and
  Replace): real bootstraps; the output ciphertexts (every block of the string, char or
  strip pair the server method returns) are bit-identical, both decrypt to
  what Python's ``str`` gives (the CLI's own oracles), and the counts agree.
- the same for the other variants (the splits, Repeat, Concatenate, Trim,
  the other replaces), marked ``slow``: 7 to 30 minutes each on a CPU
  core.  tests/test_torch_cli_short_q32.py and _q64.py run them with real
  bootstraps in the default tier on a one-character string, where they
  cost hundreds of bootstraps and not thousands.  The card runs all 52 for
  real (``chip_smoke.py``).

Tolerance: zero.  On the CPU every layer of both packages is exact integer
arithmetic.  tests/test_torch_cli_q64.py runs the same checks at the 64-bit
CI set through the helpers of this file.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from fhestring_tpu import cli as jcli
from fhestring_tpu import metrics as jmetrics
from fhestring_tpu import params as jparams
from fhestring_tpu import torus as jtorus
from fhestring_tpu.client import ClientKey as JaxClientKey
from fhestring_tpu_torch import cli, metrics, params, torus
from fhestring_tpu_torch.ciphertext import FheChar, FheString, blocks_from_numpy
from fhestring_tpu_torch.client import ClientKey
from fhestring_tpu_torch.crypto.keys import pack_server_keys
from fhestring_tpu_torch.server import ServerKey
from fhestring_tpu_torch.shortint import Blocks

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 21
ARGS = argparse.Namespace(string="hello world", pattern="ello", n=2, frm="o",
                          to="0")
CLI_ARGV = ["--string", ARGS.string, "--pattern", ARGS.pattern, "--n",
            str(ARGS.n), "--from", ARGS.frm, "--to", ARGS.to]
# family -> (port set, JAX set, the CLI's --params name)
FAMILIES = {
    "q32": (params.PARAM_TEST32_ZERO_NOISE, jparams.PARAM_TEST32_ZERO_NOISE,
            "test32"),
    "q64": (params.PARAM_TEST_ZERO_NOISE, jparams.PARAM_TEST_ZERO_NOISE,
            "test"),
}


# The variants run with real bootstraps in the default tier: the 20 of at
# most 250 PBS each on these strings, and one ends_with, both strips and one
# replace beyond that (up to 810 PBS).
REAL = ["StartsWith", "StartsWithClear", "ToLower", "ToUpper", "Len",
        "IsEmpty", "Eq", "Ne", "TrimEnd", "EqIgnoreCase", "Lt", "Le", "Gt",
        "Ge", "Contains", "ContainsClear", "Find", "FindClear", "Rfind",
        "RfindClear", "EndsWith", "StripSuffix", "StripPrefix", "Replace"]
# main() runs these in the default tier (all 52 in the slow one)
MAIN_METHODS = ["StartsWith", "ToUpper", "Len", "IsEmpty", "Ne", "Contains",
                "RfindClear"]


def variant_cases():
    """The 52 names as cases of the real-bootstrap test: those outside
    ``REAL`` marked slow."""
    return [pytest.param(m, marks=() if m in REAL else pytest.mark.slow)
            for m in cli.METHODS]


class _Recorder:
    """A ServerKey whose every method call also keeps what it returned."""

    def __init__(self, server):
        self._server = server
        self.returned = []

    def __getattr__(self, name):
        method = getattr(self._server, name)

        def call(*args, **kwargs):
            out = method(*args, **kwargs)
            self.returned.append(out)
            return out
        return call


class _FixedInputs:
    """A client that hands out ciphertexts encrypted beforehand (so that two
    runs of a method see the same ones) and decrypts with the real client.
    ``inputs``: {(kind, plaintext): ciphertext}."""

    def __init__(self, client, inputs):
        self._client = client
        self._inputs = inputs

    def encrypt(self, string, padding):
        assert padding == cli.STRING_PADDING
        return self._inputs["padded", string]

    def encrypt_no_padding(self, string):
        return self._inputs["bare", string]

    def encrypt_char(self, value):
        return self._inputs["char", value]

    def __getattr__(self, name):  # decrypt, decrypt_char, decrypt_split, ...
        return getattr(self._client, name)


def _jax_inputs(jck, a):
    made = {("padded", s): jck.encrypt(s, jcli.STRING_PADDING)
            for s in (a.string, a.pattern)}
    made.update({("bare", s): jck.encrypt_no_padding(s)
                 for s in (a.pattern, a.frm, a.to)})
    made["char", a.n % 256] = jck.encrypt_char(a.n % 256)
    return made


def _to_port(value):
    """A JAX-package FheString or FheChar as the port's, same u64 words."""
    blocks = value.blocks
    ct = blocks_from_numpy(jtorus.to_numpy(blocks.ct), "cpu").ct
    kind = FheString if ct.dim() == 3 else FheChar
    return kind(Blocks(ct, int(blocks.degree), float(blocks.noise_var)))


def _words(value, to_numpy):
    """The u64 ciphertext words of whatever a server method returned: a
    list of arrays, one per Blocks it holds."""
    if hasattr(value, "buffers"):      # FheSplit
        parts = [value.buffers, value.pattern_found.blocks]
    elif hasattr(value, "string"):     # FheStrip
        parts = [value.string.blocks, value.pattern_found.blocks]
    else:                              # FheString, FheChar
        parts = [value.blocks]
    return [to_numpy(b.ct) for b in parts]


class Pair:
    """Both packages' servers on one set of keys, and one set of inputs
    (those of ``args``, the CLI's arguments)."""

    def __init__(self, family, args=ARGS):
        port_p, jax_p, self.params_name = FAMILIES[family]
        self.args = args
        self.jck = JaxClientKey(jax_p, seed=SEED)
        self.jsrv = self.jck.get_server_key()
        self.ck = ClientKey(port_p, seed=SEED, device="cpu")   # same seed, same secret key
        np.testing.assert_array_equal(self.ck.secret.big_lwe_sk,
                                      self.jck.secret.big_lwe_sk)
        self.srv = ServerKey(pack_server_keys(self.jck._server_raw, "cpu",
                                              params=port_p), port_p)
        self.jin = _jax_inputs(self.jck, args)
        self.pin = {k: _to_port(v) for k, v in self.jin.items()}
        self.counts = {}  # method -> (pbs_calls, pbs_items, pbs_items_padded)

    def run(self, method):
        """Run one variant through both CLIs; returns (JAX ok, port ok, JAX
        outputs, port outputs, JAX counts, port counts)."""
        jrec = _Recorder(self.jsrv)
        jmetrics.reset()
        with contextlib.redirect_stdout(io.StringIO()):
            jok = jcli.run_fhe_str_method(
                jrec, _FixedInputs(self.jck, self.jin), self.args, method)
        jcounts = (jmetrics.GLOBAL.pbs_calls, jmetrics.GLOBAL.pbs_items,
                   jmetrics.GLOBAL.pbs_items_padded)
        rec = _Recorder(self.srv)
        metrics.reset()
        with contextlib.redirect_stdout(io.StringIO()):
            ok = cli.run_fhe_str_method(
                rec, _FixedInputs(self.ck, self.pin), self.args, method)
        counts = (metrics.GLOBAL.pbs_calls, metrics.GLOBAL.pbs_items,
                  metrics.GLOBAL.pbs_items_padded)
        jout = [w for v in jrec.returned for w in _words(v, jtorus.to_numpy)]
        out = [w for v in rec.returned for w in _words(v, torus.to_numpy)]
        return jok, ok, jout, out, jcounts, counts


@contextlib.contextmanager
def identity_bootstrap():
    """Both packages' ``pbs_batch`` replaced by the identity on the batch
    (same shape and type as its result), as the engines call it."""
    import fhestring_tpu.shortint as jshortint
    import fhestring_tpu_torch.shortint as shortint

    real = jshortint.pbs_batch, shortint.pbs_batch
    jshortint.pbs_batch = shortint.pbs_batch = (
        lambda flat, idx, bank, keys, **route: flat)
    try:
        yield
    finally:
        jshortint.pbs_batch, shortint.pbs_batch = real


def check_counts(pair, method):
    """Equal (calls, items, padded items) with the bootstrap stubbed out;
    returns them."""
    with identity_bootstrap():
        _, _, jout, out, jcounts, counts = pair.run(method)
    assert len(out) == len(jout) >= 1
    for got, want in zip(out, jout):
        assert got.shape == want.shape
    assert counts == jcounts
    assert counts[0] > 0 and counts[1] >= counts[0]
    pair.counts[method] = counts
    return counts


def check_method(pair, method):
    jok, ok, jout, out, jcounts, counts = pair.run(method)
    assert jok, f"{method}: the JAX package's result is not Python's"
    assert ok, f"{method}: the port's result is not Python's"
    assert len(out) == len(jout) and len(out) >= 1
    for got, want in zip(out, jout):
        np.testing.assert_array_equal(got, want)
    assert counts == jcounts
    assert counts[0] > 0 and counts[1] > 0


def check_cli_main(params_name, capsys, methods=None):
    """``main`` on the CPU: exit code 0, a line per method in the
    reference's format, and the closing count.  methods: ``--methods``
    (default: all 52)."""
    argv = CLI_ARGV + ["--params", params_name, "--device", "cpu", "--metrics"]
    rc = cli.main(argv + (["--methods", *methods] if methods else []))
    lines = capsys.readouterr().out.splitlines()
    methods = methods or cli.METHODS
    assert rc == 0
    assert lines[-1] == f"{len(methods)}/{len(methods)} methods passed"
    rows = [ln for ln in lines if ln.startswith("Test ")]
    assert len(rows) == len(methods)
    for name, row in zip(methods, rows):
        assert row.startswith("Test Passed: OK, Result: "), row
        tail = row.rsplit(", ", 1)[1].split()      # <Method> <t>s [...]
        assert tail[0] == name and tail[1].endswith("s"), row
        assert tail[2].startswith("[") and tail[3:] == ["PBS", "in", tail[5],
                                                        "batches]"], row


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_methods_and_oracles_are_the_reference_clis():
    assert cli.METHODS == jcli.METHODS and len(cli.METHODS) == 52
    assert sorted(cli.PARAM_SETS) == sorted(jcli.PARAM_SETS)
    for s, n, p in [("a,b,,c", 2, ","), ("a,b", 5, ","), ("abc", 0, "b"),
                    ("xxabxxab", 1, "ab"), ("", 3, "a")]:
        assert cli._py_rsplitn(s, n, p) == jcli._py_rsplitn(s, n, p)
        assert cli._py_splitn(s, n, p) == jcli._py_splitn(s, n, p)
        assert cli._py_split_inclusive(s, p) == jcli._py_split_inclusive(s, p)
        assert (cli._py_rsplit_terminator(s, p)
                == jcli._py_rsplit_terminator(s, p))


def test_default_device_without_cuda_fails_with_a_message(capsys):
    """No silent CPU run: the default device is cuda, and without one the
    CLI stops before any keygen."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit) as stop:
        cli.main(CLI_ARGV + ["--params", "test32"])
    assert stop.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


@pytest.fixture(scope="module")
def pair():
    return Pair("q32")


@pytest.mark.parametrize("method", cli.METHODS)
def test_variant_counts_match_jax_package(pair, method):
    check_counts(pair, method)


@pytest.mark.parametrize("method", variant_cases())
def test_variant_matches_jax_package(pair, method):
    check_method(pair, method)


def test_counts_are_chip_smokes_turbo_table(pair):
    """The 32-bit CI set has the turbo set's noise budget, so the counts of
    the 52 runs above are those of the turbo set: chip_smoke.py holds the
    card's CLI run to this table.  The PBS items are the rows of
    benchmarks/methods_turbo_r5c.jsonl (279,080 in all); the JAX engine as
    it stands makes 36 fewer batches than that table lists (5,408 for
    5,444, in 28 rows), on the CPU as in the table's run."""
    smoke = load_chip_smoke()
    assert (params.PARAM_TEST32_ZERO_NOISE.noise_budget
            == params.PARAM_TURBO.noise_budget)
    with open(os.path.join(ROOT, "benchmarks",
                           "methods_turbo_r5c.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["method"] for r in rows] == cli.METHODS == list(
        smoke.TURBO_COUNTS)
    for row in rows:
        method = row["method"]
        calls, items, _ = (pair.counts.get(method)
                           or check_counts(pair, method))
        assert smoke.TURBO_COUNTS[method] == (items, calls), method
        assert row["pbs"] == items, row
        assert 0 <= row["pbs_batches"] - calls <= 2, row
    assert sum(v[0] for v in smoke.TURBO_COUNTS.values()) == 279080
    assert sum(v[1] for v in smoke.TURBO_COUNTS.values()) == 5408


def test_cli_main_passes_its_methods(capsys):
    check_cli_main("test32", capsys, MAIN_METHODS)


@pytest.mark.slow
def test_cli_main_passes_all_52(capsys):
    check_cli_main("test32", capsys)
