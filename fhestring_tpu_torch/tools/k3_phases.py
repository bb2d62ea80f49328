"""Where a block of K3 (``csrc/ext_product.cu``) spends its cycles: a copy
of the kernel's source with ``clock64`` and ``%globaltimer`` readings
around its phases, built beside the real one.

For each (batch, body): when the blocks start and end (ns from the first
block's start) and, per block, the cycles of staging, of the product loop
and of the recombination with its atomics; from the loop's cycles, the
cycles a warp takes per ``mma.sync``.  The copy is made by inserting lines
at marked places of the source and fails if a mark is gone.  Usage:

    python3 -m fhestring_tpu_torch.tools.k3_phases
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

from ..crypto import keys
from ..crypto.kernels import cuda_build
from ..crypto.kernels import ext_product as ep
from . import card

N = 2048
CASES = ((8, (1, 512, 8)), (8, (1, 1024, 4)), (15, (2, 512, 8)),
         (33, (1, 1024, 4)), (2048, (2, 1024, 1)), (2048, (2, 512, 1)))
SLOTS, WORDS = 1 << 14, 6  # blocks recorded, u64 words a block
# (mark in the source, text put in its place): every mark must occur
EDITS = (
    ("namespace {\n",
     "__device__ unsigned long long g_prof[%d];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\nnamespace {\n" % (SLOTS * WORDS)),
    ("  for (int ch = blockIdx.z * per_block;",
     "  const unsigned long long g0 = gtime();\n"
     "  long long t1 = 0, t2 = clock64(), ts = 0, tk = 0;\n"
     "  for (int ch = blockIdx.z * per_block;"),
    ("    cp_async_wait_all();\n    __syncthreads();\n",
     "    cp_async_wait_all();\n    __syncthreads();\n"
     "    t1 = clock64();\n    ts += t1 - t2;\n"),
    ("    __syncthreads();\n  }\n\n  // ext = sum_s",
     "    __syncthreads();\n    t2 = clock64();\n    tk += t2 - t1;\n  }\n\n"
     "  // ext = sum_s"),
    ("                  static_cast<unsigned long long>(sum));\n      }\n}\n",
     "                  static_cast<unsigned long long>(sum));\n      }\n"
     "  const size_t bl = (static_cast<size_t>(blockIdx.z) * gridDim.y +\n"
     "                     blockIdx.y) * gridDim.x + blockIdx.x;\n"
     "  if (threadIdx.x == 0 && bl < %d) {\n"
     "    unsigned long long* p = g_prof + bl * %d;\n"
     "    p[0] = g0; p[1] = ts; p[2] = tk; p[3] = clock64() - t2;\n"
     "    p[4] = gtime();\n  }\n}\n" % (SLOTS, WORDS)),
)
READER = ('\nextern "C" int fhe_prof(void* dst, int count) {\n'
          "  return (int)cudaMemcpyFromSymbol(\n"
          "      dst, g_prof, sizeof(unsigned long long) * count);\n}\n")


def build() -> ctypes.CDLL:
    with open(os.path.join(cuda_build.CSRC, "ext_product.cu")) as f:
        src = f.read()
    for mark, text in EDITS:
        if src.count(mark) < 1:
            raise SystemExit(f"mark not in ext_product.cu: {mark!r}")
        src = src.replace(mark, text, 1)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_build.BUILD_DIR, "ext_product_phases")
    with open(path + ".cu", "w") as f:
        f.write(src + READER)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run(["/usr/local/cuda/bin/nvcc", *flags, "-o", path + ".so",
                    path + ".cu"], check=True)
    lib = ctypes.CDLL(path + ".so")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fhe_ext_product.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
    lib.fhe_prof.argtypes = [vp, i]
    if lib.fhe_ext_product_init():
        raise SystemExit("init failed")
    return lib


def main() -> None:
    print(card())
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bsk = torch.randint(-2**63, 2**63 - 1, (3, 2, 2, N), dtype=torch.int64,
                        generator=gen)
    limbs = keys.pack_bsk_limbs(bsk, dev)
    for batch, body in CASES:
        groups, chunk, split = body
        dl = torch.randint(-128, 128, (3, batch, 2 * N), dtype=torch.int8,
                           generator=gen).to(dev)
        out = torch.zeros((batch, 2, N), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for step in range(3):  # the last launch, on a cold key, is read
            err = lib.fhe_ext_product(dl.data_ptr(), limbs[step].data_ptr(),
                                      out.data_ptr(), batch, N, 2, *body,
                                      stream)
            torch.cuda.synchronize()
        if err or not torch.equal(out, 0 + sum(
                ep.ext_product(dl, limbs[s], body=body) for s in range(3))):
            raise SystemExit(f"the instrumented kernel is wrong at {body}")
        blocks = min((N // ep.M_TILE) * 2 * -(-batch // (ep.ITEMS * groups))
                     * split, SLOTS)
        buf = np.zeros(blocks * WORDS, np.uint64)
        lib.fhe_prof(buf.ctypes.data, buf.size)
        p = buf.reshape(blocks, WORDS).astype(np.int64)
        first = p[:, 0].min()
        products = (2 * N // chunk // split) * (chunk // 32) * 2 * 21 * groups
        med = [int(np.median(p[:, k])) for k in (1, 2, 3)]
        print(f"B={batch} body={body} blocks={blocks}: starts ns median "
              f"{int(np.median(p[:, 0] - first))} max "
              f"{(p[:, 0] - first).max()}, ends ns median "
              f"{int(np.median(p[:, 4] - first))} max "
              f"{(p[:, 4] - first).max()}; cycles a block (median): staging "
              f"{med[0]}, products {med[1]}, recombination {med[2]}; "
              f"{products} products a warp, {med[1] / products:.1f} cycles "
              f"each")


if __name__ == "__main__":
    main()
