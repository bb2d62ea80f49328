"""The build key of the port's CUDA kernels (``kernels/cuda_build.py``).

A library is named by a hash of its source, of every shared header under
``csrc/`` and of the nvcc flags, so editing any of them gives a new path
and a stale library is never loaded.  Runs on a copy of ``csrc/`` in a
temporary directory; nothing is compiled.  Tolerance: none applies.
"""

import os
import shutil

import pytest

from fhestring_tpu_torch.crypto.kernels import cuda_build

KERNELS = ["blind_rotate32", "blind_rotate64", "ext_product", "ntt_ext",
           "rotate_decompose"]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    monkeypatch.setattr(cuda_build, "CSRC", str(copy))
    return copy


def test_sources_lists_every_kernel():
    assert cuda_build.sources() == KERNELS


def test_path_is_stable_and_under_the_build_dir(csrc):
    path = cuda_build.library_path("ntt_ext")
    assert path == cuda_build.library_path("ntt_ext")
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("ntt_ext-")


@pytest.mark.parametrize("name", KERNELS)
def test_editing_a_shared_header_changes_every_path(csrc, name):
    before = cuda_build.library_path(name)
    with open(csrc / "ntt64.cuh", "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.library_path(name) != before


def test_a_new_header_changes_the_path(csrc):
    before = cuda_build.library_path("blind_rotate64")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path("blind_rotate64") != before


def test_editing_a_source_changes_only_its_path(csrc):
    before = {name: cuda_build.library_path(name) for name in KERNELS}
    with open(csrc / "ext_product.cu", "a") as f:
        f.write("\n// edited\n")
    after = {name: cuda_build.library_path(name) for name in KERNELS}
    assert [n for n in KERNELS if after[n] != before[n]] == ["ext_product"]


def test_the_flags_are_part_of_the_key(csrc, monkeypatch):
    before = cuda_build.library_path("rotate_decompose")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        [*cuda_build.NVCC_FLAGS, "-lineinfo"])
    assert cuda_build.library_path("rotate_decompose") != before
