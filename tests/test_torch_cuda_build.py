"""The port's kernel build (pathway_tpu_torch/ops/cuda_build.py): a
library's name hashes its source and every header the source includes, so
an edit to a shared header (ops/csrc/knn_topk.cuh) rebuilds each library
that includes it and no other. Run on a copy of ops/csrc/; no nvcc."""

import os
import shutil

import pytest

from pathway_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = os.path.join(os.path.dirname(cuda_build.__file__), "csrc")
    dst = tmp_path / "csrc"
    shutil.copytree(src, dst)
    monkeypatch.setattr(cuda_build, "_SRC_DIR", str(dst))
    return dst


def _paths():
    return {name: cuda_build.CudaLibrary(name, {}).path()
            for name in ("knn_i8", "knn_bf16", "attention")}


def test_sources_follow_local_includes(csrc_copy):
    lib = cuda_build.CudaLibrary("knn_bf16", {})
    assert [os.path.basename(p) for p in lib.sources()] == [
        "knn_bf16.cu", "knn_topk.cuh"]
    assert [os.path.basename(p) for p in
            cuda_build.CudaLibrary("attention", {}).sources()] == [
        "attention.cu"]


def test_header_edit_changes_the_path_of_its_includers_only(csrc_copy):
    before = _paths()
    assert _paths() == before  # the hash is a function of the files
    with open(csrc_copy / "knn_topk.cuh", "a") as f:
        f.write("\n// an edit\n")
    after = _paths()
    assert after["knn_i8"] != before["knn_i8"]
    assert after["knn_bf16"] != before["knn_bf16"]
    assert after["attention"] == before["attention"]
    with open(csrc_copy / "knn_bf16.cu", "a") as f:
        f.write("\n// an edit\n")
    again = _paths()
    assert again["knn_bf16"] != after["knn_bf16"]
    assert again["knn_i8"] == after["knn_i8"]


def test_nested_include_is_hashed(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("// inner\n")
    with open(csrc_copy / "knn_topk.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    lib = cuda_build.CudaLibrary("knn_i8", {})
    assert os.path.basename(lib.sources()[-1]) == "inner.cuh"
    before = lib.path()
    (csrc_copy / "inner.cuh").write_text("// inner, edited\n")
    assert lib.path() != before
