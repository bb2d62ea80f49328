"""Nothing the benchmark runs loads JAX or the JAX package, and the
yardstick (the reference and what makes the inputs) loads nothing of the
program.  Top-level module names are compared whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from fhebench import run

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
YARDSTICK = ("reference", "scheme", "traffic", "roofline", "trace",
             "methods")


def loaded_after(code: str) -> set[str]:
    """Top-level names of the modules loaded by ``code`` in a fresh
    interpreter (the test process has JAX loaded by other tests)."""
    probe = code + (
        "\nimport sys, json"
        "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    code = (
        "import json\n"
        "from fhebench import run, control, count_mix\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for c in bench['configs']:\n"
        "    c['file'] = 'fhebench/tests/configs/tiny' + (\n"
        "        '64' if c['name'] == 'prod64' else '32') + '.json'\n"
        "out = run.run_cell(bench, 'turbo32.interactive', 5, 0.1, False,\n"
        "                   device='cpu')\n"
        "assert out['correct'], out['checks']\n")
    names = loaded_after(code)
    assert "fhestring_tpu_torch" in names and "torch" in names
    assert not names & set(run.FORBIDDEN), names & set(run.FORBIDDEN)


def test_the_yardstick_loads_nothing_of_the_program():
    names = loaded_after(
        "".join(f"import fhebench.{m}\n" for m in YARDSTICK)
        + "import os\n"
        "for f in sorted(os.listdir(fhebench.methods.HERE)):\n"
        "    if f.endswith('.py') and f != '__init__.py':\n"
        "        fhebench.methods.load(f[:-3]).answer(b'ab', b'b', b'c')\n")
    assert "fhestring_tpu_torch" not in names
    assert not names & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "fhestring_tpu", raising=False)
    monkeypatch.setitem(sys.modules, "fhestring_tpu_torch.fake", object())
    before = run.forbidden_modules()
    assert "fhestring_tpu" not in before
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
