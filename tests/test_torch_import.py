"""The port imports torch and numpy, never jax, and its public surface
matches the JAX package's.

Each import check runs in a fresh interpreter with ``sys.modules["jax"] =
None``, so any import of jax, direct or through ``fhestring_tpu`` (whose
``__init__`` imports jax), raises ImportError.  Tolerance: none applies.
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "fhestring_tpu_torch",
    "fhestring_tpu_torch.params",
    "fhestring_tpu_torch.torus",
    "fhestring_tpu_torch.numpy_ref",
    "fhestring_tpu_torch.native",
    "fhestring_tpu_torch.crypto.ntt",
    "fhestring_tpu_torch.crypto.keys",
    "fhestring_tpu_torch.crypto.kernels.cuda_build",
    "fhestring_tpu_torch.crypto.kernels.cluster",
    "fhestring_tpu_torch.crypto.kernels.blind_rotate32",
    "fhestring_tpu_torch.crypto.kernels.blind_rotate64",
    "fhestring_tpu_torch.crypto.kernels.rotate_decompose",
    "fhestring_tpu_torch.crypto.kernels.ext_product",
    "fhestring_tpu_torch.crypto.kernels.ntt_ext",
    "fhestring_tpu_torch.crypto.pbs",
    "fhestring_tpu_torch.metrics",
    "fhestring_tpu_torch.shortint",
    "fhestring_tpu_torch.radix",
    "fhestring_tpu_torch.engine.strings",
    "fhestring_tpu_torch.engine.backend",
    "fhestring_tpu_torch.ciphertext",
    "fhestring_tpu_torch.client",
    "fhestring_tpu_torch.server",
    "fhestring_tpu_torch.utils",
    "fhestring_tpu_torch.cli",
    "fhestring_tpu_torch.tools.stepwise_sweep",
    "fhestring_tpu_torch.tools.k3_phases",
    "fhestring_tpu_torch.tools.rotation_sweep",
    "fhestring_tpu_torch.tools.step_breakdown",
    "fhestring_tpu_torch.tools.profile_requests",
]

_PROBE = """
import importlib, sys
sys.modules["jax"] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "fhestring_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def _probe(*modules):
    return subprocess.run([sys.executable, "-c", _PROBE, *modules],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_port_imports_with_jax_blocked():
    proc = _probe(*MODULES)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_probe_detects_a_jax_import():
    """The probe itself is live: importing the JAX package under it fails."""
    proc = _probe("fhestring_tpu.numpy_ref")
    assert proc.returncode != 0


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(ROOT, "fhestring_tpu_torch"))
    for f in files if f.endswith(".py")))
def test_no_jax_in_port_sources(path):
    with open(path) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src, path
    assert "from fhestring_tpu " not in src and "import fhestring_tpu\n" not in src
    assert "from fhestring_tpu." not in src, path


def _exports(init_path):
    """Names a package ``__init__`` imports from its ``.params`` module."""
    with open(init_path) as f:
        tree = ast.parse(f.read())
    return {a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            and node.module == "params" for a in node.names}


def test_package_exports_the_jax_packages_params():
    """Every parameter name the JAX package exports, the port exports too
    (and it keeps its turbo names)."""
    import fhestring_tpu_torch

    want = _exports(os.path.join(ROOT, "fhestring_tpu", "__init__.py"))
    assert {"PARAM_PROD", "PARAM_MESSAGE_2_CARRY_2_KS_PBS_64",
            "PARAM_TEST_ZERO_NOISE", "PARAM_TEST_NOISY"} <= want
    for name in want | {"PARAM_TURBO", "PARAM_MESSAGE_2_CARRY_2_KS_PBS_32",
                        "PARAM_TEST32_ZERO_NOISE", "PARAM_TEST32_STAT"}:
        assert hasattr(fhestring_tpu_torch, name), name
    from fhestring_tpu_torch import params

    assert fhestring_tpu_torch.PARAM_PROD is params.PARAM_PROD


@pytest.mark.parametrize("method", ["__init__", "from_params"])
def test_client_key_defaults_to_param_prod(method):
    """ClientKey() and ClientKey.from_params() default to PARAM_PROD, as the
    JAX package's do (read from the signatures: no keygen at prod here)."""
    from fhestring_tpu.client import ClientKey as JaxClientKey
    from fhestring_tpu_torch.client import ClientKey
    from fhestring_tpu_torch.params import PARAM_PROD

    default = inspect.signature(getattr(ClientKey, method)).parameters[
        "params"].default
    jax_default = inspect.signature(getattr(JaxClientKey, method)).parameters[
        "params"].default
    assert default is PARAM_PROD
    assert dataclasses.asdict(default) == dataclasses.asdict(jax_default)


def test_get_server_key_takes_the_jax_packages_positional_parameters():
    """``get_server_key(False)`` means "no NTT key" in both packages: the
    positional parameters agree in name, order and default; the port's
    ``device`` is keyword-only, and ``cache_path`` raises until the port
    has ``serialize.py``."""
    from fhestring_tpu.client import ClientKey as JaxClientKey
    from fhestring_tpu_torch import PARAM_TEST32_ZERO_NOISE
    from fhestring_tpu_torch.client import ClientKey

    def positional(cls):
        return [(p.name, p.default) for p in inspect.signature(
            cls.get_server_key).parameters.values()
            if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]

    assert positional(ClientKey) == positional(JaxClientKey) == [
        ("self", inspect.Parameter.empty), ("with_ntt2", None),
        ("cache_path", None)]
    own = inspect.signature(ClientKey.get_server_key).parameters
    assert own["device"].kind is inspect.Parameter.KEYWORD_ONLY
    ck = ClientKey(PARAM_TEST32_ZERO_NOISE, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ck.get_server_key(None, "keys.npz")
    with pytest.raises(TypeError):
        ck.get_server_key(None, None, "cpu")
    assert ck.get_server_key(True, device="cpu").backend.sc.keys \
        .bsk_ntt32 is not None


@pytest.mark.parametrize("name", ["abs_difference", "trim_vector",
                                  "trim_str_vector",
                                  "adjust_end_of_pattern"])
def test_utils_are_the_jax_packages(name):
    from fhestring_tpu import utils as jutils
    from fhestring_tpu_torch import utils

    cases = {"abs_difference": [(3, 9), (9, 3), (4, 4)],
             "trim_vector": [(["", "a", "", "b", ""],), ([],), (["", ""],)],
             "trim_str_vector": [(["", "a\0\0", ""], True), (["a\0"], False)],
             "adjust_end_of_pattern": [(5, 2), (2, 5), (3, 3)]}
    for args in cases[name]:
        assert getattr(utils, name)(*args) == getattr(jutils, name)(*args)


NATIVE_SOURCES = ["csprng.cpp", "keygen.cpp"]


@pytest.mark.parametrize("name", NATIVE_SOURCES)
def test_native_sources_are_the_ports_own_copies(name):
    """The port builds its keygen and CSPRNG from its own copies of the C++
    sources, byte-identical to the JAX package's, so both packages derive
    the same keys from a seed."""
    from fhestring_tpu_torch import native

    assert os.path.samefile(native._SRC_DIR,
                            os.path.join(ROOT, "fhestring_tpu_torch", "native"))
    with open(os.path.join(native._SRC_DIR, name), "rb") as f:
        own = f.read()
    with open(os.path.join(ROOT, "fhestring_tpu", "native", name), "rb") as f:
        assert own == f.read()


def test_native_sources_include_only_each_other():
    """keygen.cpp includes csprng.cpp and no other file of the repository."""
    local = []
    for name in NATIVE_SOURCES:
        with open(os.path.join(ROOT, "fhestring_tpu_torch", "native",
                               name)) as f:
            local += [ln.split('"')[1] for ln in f
                      if ln.startswith("#include \"")]
    assert local == ["csprng.cpp"]


def _string_constants(path):
    """Every string constant of a Python source that is not a docstring
    (parts of f-strings included), with its line."""
    with open(path) as f:
        tree = ast.parse(f.read())
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                docstrings.add(id(body[0].value))
    return [(node.value, node.lineno) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings]


PORT_SOURCES = sorted(
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(ROOT, "fhestring_tpu_torch"))
    for f in files if f.endswith(".py")) + [os.path.join(ROOT, "chip_smoke.py")]


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in PORT_SOURCES])
def test_port_names_no_path_of_the_jax_package(path):
    """No module of the port, nor chip_smoke.py, can open a file under
    ``fhestring_tpu/``: outside docstrings and comments, no string names
    that directory, but for the ``replaces`` entries of chip_smoke's kernels
    line (file:line of the TPU kernel each CUDA kernel replaces)."""
    replaces = "fhestring_tpu/crypto/kernels/"
    for value, line in _string_constants(path):
        if path.endswith("chip_smoke.py") and value.startswith(replaces):
            continue
        parts = value.replace("\\", "/").split("/")
        assert "fhestring_tpu" not in parts, (path, line, value)
