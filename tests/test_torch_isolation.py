"""The port stands alone: pathway_tpu_torch (and chip_smoke.py) import
neither jax nor anything of pathway_tpu, nor aiohttp or any other package
the chip machine lacks (it has Python's standard library, torch, triton,
numpy, scipy, einops, pytest and hypothesis), and its entry points never
drop to the CPU unless asked."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pathway_tpu", "aiohttp")
# what the chip machine has besides Python's standard library
CHIP_PACKAGES = frozenset(("torch", "triton", "numpy", "scipy", "einops",
                           "pytest", "hypothesis", "pathway_tpu_torch"))

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
# the engine's batch path: the embedder as a batch device UDF
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.runner import GraphRunner
t = pw.debug.table_from_rows(pw.schema_from_types(data=str),
                             [(d, 2 * (i // 8), 1) for i, d in enumerate(docs)],
                             is_stream=True)
runner = GraphRunner()
cap = runner.capture(t.filter(pw.this.data != "").select(
    embedding=emb(pw.this.data), n=pw.apply(len, pw.this.data)))
runner.run_batch(n_workers=1)
assert len(cap.events) == 40, cap.events
# the served path: a rest_connector graph under pw.run answers one POST
import json, threading, time, urllib.request
from pathway_tpu_torch.engine import streaming
from pathway_tpu_torch.internals.parse_graph import G
G.clear()
ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=0)
q, writer = pw.io.http.rest_connector(
    webserver=ws, route="/q", schema=pw.schema_from_types(query=str),
    delete_completed_queries=True, autocommit_duration_ms=5)
writer(q.select(n=pw.apply(len, q.query)))
th = threading.Thread(target=pw.run, daemon=True)
th.start()
deadline = time.monotonic() + 30
while not (ws._started.is_set() and ws.port):
    assert time.monotonic() < deadline and th.is_alive()
    time.sleep(0.01)
req = urllib.request.Request(f"http://127.0.0.1:{ws.port}/q",
                             data=json.dumps({"query": "four"}).encode())
try:
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert (resp.status, resp.read()) == (200, b"4")
finally:
    streaming.stop_all()
    th.join(30)
assert not th.is_alive()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pathway_tpu",
                                    "aiohttp"))
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


def _guarded_imports(tree) -> set[int]:
    """ids of the import nodes inside a ``try`` whose handlers catch
    ImportError: the module runs without that package (and raises by
    name where it is needed)."""
    guarded = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        catches = set()
        for h in node.handlers:
            types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
            catches |= {getattr(t, "id", None) for t in types}
        if catches & {"ImportError", "ModuleNotFoundError"}:
            for stmt in node.body:
                guarded |= {id(n) for n in ast.walk(stmt)}
    return guarded


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    guarded = _guarded_imports(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            yield n, id(node) in guarded


def test_no_forbidden_import_in_port_sources():
    offenders = [(path, n) for path in _port_files()
                 for n, _guarded in _imports(path) if _is_forbidden(n)]
    assert not offenders


def test_port_imports_only_what_the_chip_machine_has():
    """Every import of the port and of chip_smoke.py is of the standard
    library or of a package the chip machine has, unless the module runs
    without it (an import guarded by ``except ImportError``)."""
    offenders = []
    for path in _port_files():
        for n, guarded in _imports(path):
            top = n.split(".")[0]
            if top in sys.stdlib_module_names or top in CHIP_PACKAGES:
                continue
            if not guarded:
                offenders.append((os.path.relpath(path, REPO), n))
    assert not offenders


def test_the_isolation_checks_catch_an_offender(tmp_path):
    """The two checks above on a file that imports aiohttp and yaml at the
    top and pandas under ``except ImportError``."""
    bad = tmp_path / "bad.py"
    bad.write_text("import aiohttp\nfrom yaml import safe_dump\n"
                   "try:\n    import pandas\nexcept ImportError:\n"
                   "    pandas = None\n")
    got = list(_imports(str(bad)))
    assert got == [("aiohttp", False), ("yaml", False), ("pandas", True)]
    assert [n for n, _ in got if _is_forbidden(n)] == ["aiohttp"]


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
