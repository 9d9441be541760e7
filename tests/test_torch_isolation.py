"""The port stands alone: pathway_tpu_torch (and chip_smoke.py) import
neither jax nor anything of pathway_tpu, and its entry points never drop
to the CPU unless asked."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pathway_tpu")

_SLICE = """
import sys
import numpy as np
import torch
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, DeviceEmbeddingKnnIndex
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

emb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")
idx = DeviceEmbeddingKnnIndex(emb, BruteForceKnnIndex(
    64, reserved_space=64, dtype="bfloat16", device="cpu"))
docs = [f"doc {i} word{i} word{i * 7}" for i in range(40)]
idx.add_batch([Pointer(i) for i in range(40)], docs)
res = idx.search([(Pointer(10**6), docs[5], 3, None)])
assert len(res[0]) == 3, res
# path 2: the ragged embedder into an int8 index
remb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu", ragged=True)
ridx = DeviceEmbeddingKnnIndex(remb, BruteForceKnnIndex(
    64, reserved_space=64, dtype="int8", metric="cos", device="cpu"))
ridx.add_batch([Pointer(i) for i in range(40)], docs)
res = ridx.search([(Pointer(10**6), docs[7], 3, None)])
assert len(res[0]) == 3, res
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pathway_tpu"))
print("FORBIDDEN", bad)
"""


def _is_forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_slice_runs_without_jax_or_reference_modules():
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def _port_files():
    root = os.path.join(REPO, "pathway_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_forbidden_import_in_port_sources():
    offenders = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(path, n) for n in names if _is_forbidden(n)]
    assert not offenders


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from pathway_tpu_torch.models.encoder import (Encoder, EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    cfg = EncoderConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncoderEmbedder(config=cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BruteForceKnnIndex(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Encoder.from_params(init_params_host(0, cfg), cfg)


def test_cuda_device_carries_its_index(monkeypatch):
    """"cuda" resolves to "cuda:<current>", the device of the tensors made
    on it, so the index's device checks accept the encoder's output."""
    from pathway_tpu_torch._device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
