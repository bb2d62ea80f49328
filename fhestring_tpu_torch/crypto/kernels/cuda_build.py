"""Build and load the package's CUDA kernels (``csrc/*.cu``) with nvcc.

Each source is compiled on its own into a shared library with a plain C
interface, ``BUILD_DIR/<name>-<hash>.so``, keyed by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, and loaded with ctypes.
A build happens at first use, in the process that needs it; ``build``
starts one nvcc per missing library, all at once, and waits for them, so
several kernels build in the time of the slowest.  A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

from ...native import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# source name -> nvcc's output (ptxas registers and spills) when this
# process compiled it
LOGS: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (whether or not it exists yet).
    The key hashes the source, every header under ``csrc/`` (a source may
    include any of them) and the flags, so an edited header rebuilds."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def sources() -> list[str]:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build(*names: str) -> list[str]:
    """Compile the named sources that are not built yet, in parallel;
    returns their library paths."""
    paths = [library_path(name) for name in names]
    running = []
    for name, path in zip(names, paths):
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in running:
        LOGS[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{name}:\n{LOGS[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str, functions: dict) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it once per process.

    functions: C symbol -> (argtypes, restype).  Every library also
    exports ``fhe_cuda_error_string(int) -> const char*``."""
    if name not in _LIBS:
        lib = ctypes.CDLL(build(name)[0])
        for symbol, (argtypes, restype) in functions.items():
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = restype
        lib.fhe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fhe_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


_READY: dict[tuple[str, int], ctypes.CDLL] = {}


def ready(name: str, functions: dict, init: str,
          device_index: int) -> ctypes.CDLL:
    """``load`` and, once per device, the library's ``init`` function
    (``int init(void)``, a cudaError_t), which loads its kernels on the
    current device and sets their attributes.  A stream capture can do
    neither, so a caller that captures launches calls this first."""
    if (name, device_index) not in _READY:
        lib = load(name, functions)
        with torch.cuda.device(device_index):
            check(lib, getattr(lib, init)(), f"{name} init")
        _READY[name, device_index] = lib
    return _READY[name, device_index]


def check_out(out: torch.Tensor, shape: tuple, dtype: torch.dtype,
              device: torch.device) -> None:
    """Raise unless ``out`` is a buffer a kernel can write its result to."""
    if (out.dtype != dtype or tuple(out.shape) != tuple(shape)
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {device}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.fhe_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of the CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
