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
