"""The string methods a mix may ask for, one file each, found by name.

``methods/<name>.py`` holds everything of the method ``<name>`` (the
name of the ``ServerKey`` method it calls): how the generator makes a
request of it, what the request sends encrypted and in clear, how its
result decrypts, and the plain reference's answer.  A mix that needs a
method the benchmark lacks adds its file; no other file changes.

A method file defines:

- ``PATTERN``: where a matching pattern lies in the string: ``None`` (the
  method takes no pattern), ``"anywhere"``, ``"prefix"``, ``"suffix"``, or
  ``"whole"`` (a second string of the string's length, the same string
  where it matches, sent padded as the string is);
- ``ENCRYPTED_PATTERN``: whether the pattern is sent encrypted (otherwise
  it is passed in clear, as ``str``);
- ``REPLACEMENT``: whether a request also carries a replacement of the
  pattern's length, passed in clear after the pattern;
- ``decode(result, text, char)``: the decrypted answer, in the form
  ``answer`` gives, from the program's result; ``text(x)`` and ``char(x)``
  decrypt an object with ``.blocks`` to bytes (up to the first NUL) and to
  a whole number;
- ``answer(string, pattern, to)``: the plain reference's answer, from the
  plaintexts alone (``fhebench.reference``'s loops; nothing of the
  program).
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))
_loaded: dict = {}


def load(name: str, root: str | None = None):
    """The module of ``<root>/methods/<name>.py`` (root: the benchmark's
    folder); a ValueError where there is no such file."""
    path = os.path.join(root, "methods", f"{name}.py") if root else (
        os.path.join(HERE, f"{name}.py"))
    if path not in _loaded:
        if not os.path.exists(path):
            raise ValueError(f"no method file for {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"fhebench_method_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


def encrypted(method, r, pad: bytes) -> list[bytes]:
    """The byte strings a request sends encrypted, in argument order: the
    string (padded), then an encrypted pattern (padded where it is a whole
    string)."""
    out = [r.string + pad]
    if method.ENCRYPTED_PATTERN:
        out.append(r.pattern + (pad if method.PATTERN == "whole" else b""))
    return out


def arguments(method, r, strings: list) -> tuple:
    """The call's arguments: the encrypted pieces, then the clear pattern
    and replacement as ``str``."""
    clear = []
    if method.PATTERN is not None and not method.ENCRYPTED_PATTERN:
        clear.append(r.pattern.decode())
    if method.REPLACEMENT:
        clear.append(r.to.decode())
    return (*strings, *clear)
