"""What a step of K2 (``blind_rotate64``) spends on each of its parts.

Builds copies of ``csrc/blind_rotate64.cu`` in which one part of the step
returns at once (the copies give wrong results: they are timed, never
compared), and times each body (1, 2, 4 and 8 blocks an item) at B=8,
N=2048, n=742 in the production and the exact mode.  A part's cost is the base time less the time without it.
Parts: the pointwise products, the forward or the inverse transforms, and
of the transforms the pass of the 1-2 left-over stages, the pass on
neighbouring coefficients, and the passes of 3 stages.  Usage:

    python3 -m fhestring_tpu_torch.tools.step_breakdown [B ...]

(batches; default 8).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from ..crypto import ntt
from ..crypto.kernels import blind_rotate64 as br64
from ..crypto.kernels import cuda_build
from . import card, cuda_ms, random_khat

VARIANTS = {"base": 0, "no pointwise": 1, "no forward": 2, "no inverse": 4,
            "no left-over pass": 8, "no neighbour pass": 16,
            "no 3-stage passes": 32, "no transforms": 6,
            "no transforms, no pointwise": 7}
SKIP_PASS = """#ifdef FHE_SKIP
  if ((FHE_SKIP & %d) || ((FHE_SKIP & 8) && kS < 3) ||
      ((FHE_SKIP & 16) && kContig) ||
      ((FHE_SKIP & 32) && kS == 3 && !kContig)) {
    __syncthreads();
    return;
  }
#endif
"""


def patched_sources(directory: str) -> str:
    """Copy csrc/ to `directory` with the FHE_SKIP returns put in."""
    for name in os.listdir(cuda_build.CSRC):
        shutil.copy(os.path.join(cuda_build.CSRC, name), directory)
    path = os.path.join(directory, "ntt64.cuh")
    with open(path) as f:
        src = f.read()
    for anchor, text in (
            ("  const int log_u = kContig ? 0 : log_n - s0 - kS;\n",
             SKIP_PASS % 2),
            ("  const int log_u = kContig ? 0 : log_u_;\n", SKIP_PASS % 4),
            ("  for (int h = threadIdx.x; h < n; h += blockDim.x) {\n"
             "    uint32_t d[kDigitPolys];\n",
             "#ifdef FHE_SKIP\n  if (FHE_SKIP & 1) {\n    __syncthreads();\n"
             "    return;\n  }\n#endif\n")):
        if src.count(anchor) != 1:
            raise RuntimeError(f"ntt64.cuh changed: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    with open(path, "w") as f:
        f.write(src)
    return os.path.join(directory, "blind_rotate64.cu")


def main() -> None:
    print(card())
    n, steps = 2048, 742
    batches = tuple(map(int, sys.argv[1:])) or (8,)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    khat = random_khat(gen, steps, 2, 16, n).to(dev)
    tw = ntt.kernel_twiddles(n, "cuda")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        source = patched_sources(tmp)
        builds = {}
        for name, mask in VARIANTS.items():
            lib = os.path.join(tmp, f"skip{mask}.so")
            builds[name] = (lib, subprocess.Popen(
                [nvcc, *(f for f in cuda_build.NVCC_FLAGS
                         if f not in ("-Xptxas", "-v")),
                 f"-DFHE_SKIP={mask}", "-o", lib, source],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        functions = {}
        for name, (lib, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            cdll = ctypes.CDLL(lib)
            err = cdll.fhe_blind_rotate64_init()
            if err:  # the bodies' shared memory above 48 KB
                raise RuntimeError(f"init failed for {name}: {err}")
            fn = cdll.fhe_blind_rotate64
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            functions[name] = fn
        for batch in batches:
            acc = torch.randint(-2**63, 2**63 - 1, (batch, 2, n),
                                dtype=torch.int64, generator=gen).to(dev)
            amt = torch.randint(0, 2 * n, (batch, steps), dtype=torch.int32,
                                generator=gen).to(dev)
            out = torch.empty_like(acc)
            print(f"K2 at B={batch} N={n} n={steps}, ms: body<c> production "
                  f"(p) and exact (x)")
            for name, fn in functions.items():
                row = [f"{name:28s}"]
                for cluster in br64.CLUSTERS:
                    for rounded, approx in ((1, 1), (0, 0)):
                        def run():
                            err = fn(acc.data_ptr(), out.data_ptr(),
                                     amt.data_ptr(), khat.data_ptr(),
                                     tw.data_ptr(), batch, steps, n,
                                     rounded, approx, cluster,
                                     torch.cuda.current_stream().cuda_stream)
                            if err:
                                raise RuntimeError(f"launch failed: {err}")
                        row.append(f"<{cluster}>{'p' if rounded else 'x'} "
                                   f"{cuda_ms(run):6.2f}")
                print(" ".join(row), flush=True)


if __name__ == "__main__":
    main()
