"""Native (C++) client-side components, loaded with ctypes.

The C++ sources are this package's own copies, ``csprng.cpp`` and
``keygen.cpp`` beside this file (AES-128-CTR randomness and the OpenMP TFHE
keygen; ``keygen.cpp`` includes ``csprng.cpp``), byte-identical to the JAX
package's.  They are compiled with g++ at first use into this package's
build directory (``fhestring_tpu_torch/build/``), keyed by a hash of the
source, so the JAX package's own libraries are never rebuilt or overwritten.

Semantics are those of ``fhestring_tpu.native``: the same AES key gives the
same random stream and the same keys, so a ``ClientKey(seed=...)`` of either
package yields identical secret keys and ciphertexts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import secrets
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "build")
_LIBS: dict[str, ctypes.CDLL | None] = {}


def _build(name: str, src: str, extra_groups) -> str | None:
    """Compile ``src`` into BUILD_DIR/lib<name>-<hash>.so; None without g++."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    for extra in extra_groups:
        try:
            subprocess.run(["g++", *flags, *extra, src, "-o", tmp],
                           check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
        os.replace(tmp, out)
        return out
    return None


def _load(name: str):
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(_SRC_DIR, f"{name}.cpp")
    groups = ((["-maes", "-msse4.1", "-fopenmp"], ["-maes", "-msse4.1"],
               ["-fopenmp"], []) if name == "keygen"
              else (["-maes", "-msse4.1"], []))
    path = _build(name, src, groups) if os.path.exists(src) else None
    lib = None
    if path is not None:
        lib = ctypes.CDLL(path)
        c = ctypes
        if name == "csprng":
            lib.aes128_ctr_fill.argtypes = [
                c.c_void_p, c.c_size_t, c.c_char_p, c.c_uint64]
            lib.aes128_ctr_fill.restype = None
        else:
            lib.tfhe_keygen.argtypes = [
                c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32,
                c.c_uint32, c.c_uint32, c.c_uint32, c.c_double, c.c_double,
                c.c_char_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p]
            lib.tfhe_keygen.restype = None
    _LIBS[name] = lib
    return lib


def keygen_available() -> bool:
    return _load("keygen") is not None


def keygen_native(params, key: bytes):
    """Native keygen: (SecretKeys, ServerKeys) with numpy_ref's layouts.

    ``key`` is the client's 16-byte AES key; the keygen draws from counter
    regions >= 2^32, disjoint from SecureRng's encryption stream."""
    lib = _load("keygen")
    if lib is None:
        raise RuntimeError("no C++ compiler available for native keygen")
    from ..numpy_ref import core as ref

    p = params
    assert p.q_bits == 64, "native keygen assumes the 64-bit torus"
    assert len(key) == 16
    n, k, N, ell = (p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
                    p.pbs_level)
    lwe_sk = np.zeros(n, dtype=np.int64)
    glwe_sk = np.zeros((k, N), dtype=np.int64)
    bsk = np.zeros((n, (k + 1) * ell, k + 1, N), dtype=np.uint64)
    ksk = np.zeros((k * N, p.ks_level, n + 1), dtype=np.uint64)
    lib.tfhe_keygen(
        n, k, N, ell, p.pbs_base_log, p.ks_level, p.ks_base_log,
        p.torus_bits, float(p.lwe_noise_std), float(p.glwe_noise_std), key,
        lwe_sk.ctypes.data_as(ctypes.c_void_p),
        glwe_sk.ctypes.data_as(ctypes.c_void_p),
        bsk.ctypes.data_as(ctypes.c_void_p),
        ksk.ctypes.data_as(ctypes.c_void_p),
    )
    return ref.SecretKeys(p, lwe_sk, glwe_sk), ref.ServerKeys(p, bsk, ksk)


class SecureRng:
    """AES-CTR-backed RNG with the numpy Generator subset the crypto layer
    uses (integers, normal); the same draws as ``fhestring_tpu.native.
    SecureRng``.  Falls back to numpy's PCG64 (not secure) without g++."""

    def __init__(self, key: bytes | None = None, seed: int | None = None):
        if key is None:
            key = (secrets.token_bytes(16) if seed is None
                   else int(seed).to_bytes(16, "little", signed=False))
        assert len(key) == 16
        self._key = key
        self._counter = 0
        self._lib = _load("csprng")
        self._fallback = None
        if self._lib is None:
            self._fallback = np.random.default_rng(
                int.from_bytes(key, "little") & ((1 << 63) - 1))

    @property
    def is_secure(self) -> bool:
        return self._lib is not None

    def _bytes(self, n: int) -> np.ndarray:
        if self._lib is None:
            return self._fallback.integers(0, 256, size=n, dtype=np.uint8)
        out = np.empty(n, dtype=np.uint8)
        self._lib.aes128_ctr_fill(
            out.ctypes.data_as(ctypes.c_void_p), n, self._key, self._counter)
        self._counter += (n + 15) // 16
        return out

    def integers(self, low, high, size=None, dtype=np.int64):
        size = () if size is None else size
        n = int(np.prod(size)) if size else 1
        span = int(high) - int(low)
        raw = self._bytes(n * 8).view(np.uint64)
        if span & (span - 1) == 0:  # power of two: no modulo bias
            vals = (raw & np.uint64(span - 1)).astype(np.uint64)
        else:
            vals = raw % np.uint64(span)
        out = (vals.astype(np.uint64) + np.uint64(low)).astype(dtype)
        return out.reshape(size) if size else dtype(out[0])

    def normal(self, loc=0.0, scale=1.0, size=None):
        size = () if size is None else size
        n = int(np.prod(size)) if size else 1
        m = n + (n & 1)
        u = self._bytes(m * 8).view(np.uint64)
        # uniforms in (0, 1]
        u01 = (u.astype(np.float64) + 1.0) / 2.0**64
        u1, u2 = u01[: m // 2], u01[m // 2:]
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:n]
        out = loc + scale * z
        return out.reshape(size) if size else float(out[0])
