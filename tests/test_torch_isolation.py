"""The port stands alone: pathway_tpu_torch (and chip_smoke.py) import
neither jax nor anything of pathway_tpu, nor aiohttp, optax, pandas, a
Kafka client package or any other package the chip machine lacks (it has Python's standard library, torch,
triton, numpy, scipy, einops, pytest and hypothesis; PIL only inside the
function that decodes image bytes), and its entry points never drop to
the CPU unless asked."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pathway_tpu", "aiohttp", "optax", "kafka",
             "confluent_kafka")
# imported only inside the function that needs it (models/clip.py
# load_image, models/hf_loader.py's safetensors read): a machine without it
# fails in that call and nowhere else
LAZY_PACKAGES = frozenset(("PIL", "safetensors", "transformers"))
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


_TEMPORAL = """
import datetime
import importlib.abc
import sys

attempts = []


class NoPandas(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "pandas":
            attempts.append(name)
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, NoPandas())
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.runner import GraphRunner

ticks = [(f"k{i % 3}", i, 2 * i + i % 5, 2 * (1 + i // 6), 1)
         for i in range(40)]
schema = pw.schema_from_types(k=str, v=int, at=int)
t = pw.debug.table_from_rows(schema, ticks, is_stream=True)
u = pw.debug.table_from_rows(schema, ticks[::3], is_stream=True)
base = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)
d_schema = pw.schema_from_types(k=str, v=int, at=datetime.datetime)
dt = pw.debug.table_from_rows(
    d_schema, [(k, v, base + datetime.timedelta(minutes=a), tick, diff)
               for k, v, a, tick, diff in ticks], is_stream=True)
minute = datetime.timedelta(minutes=1)
outs = []
for window in (pw.temporal.tumbling(10), pw.temporal.sliding(hop=5,
               duration=10), pw.temporal.session(max_gap=3)):
    outs.append(pw.temporal.windowby(
        t, t.at, window=window, instance=t.k,
        behavior=pw.temporal.common_behavior(delay=4, cutoff=20),
    ).reduce(s=pw.reducers.sum(pw.this.v)))
for window in (pw.temporal.tumbling(10 * minute),
               pw.temporal.sliding(hop=5 * minute, duration=10 * minute)):
    outs.append(pw.temporal.windowby(dt, dt.at, window=window).reduce(
        s=pw.reducers.sum(pw.this.v)))
outs.append(pw.temporal.asof_now_join(t, u, t.k == u.k, how="left").select(
    a=t.v, b=u.v))
outs.append(pw.temporal.asof_join_outer(t, u, t.at, u.at, t.k == u.k,
            direction="nearest").select(a=t.v, b=u.v))
outs.append(pw.temporal.interval_join_outer(
    dt, dt, dt.at, dt.at, pw.temporal.interval(-minute, minute)).select(
    a=pw.left.v))
outs.append(pw.temporal.window_join_outer(
    t, u, t.at, u.at, pw.temporal.session(max_gap=2)).select(a=t.v, b=u.v))
outs.append(t.sort(t.at).select(pw.this.prev))
outs.append(t.diff(t.at, t.v))
outs.append(t.with_columns(x=pw.if_else(t.v % 2 == 0, None, 1.0 * t.v))
            .interpolate(pw.this.at, pw.this.x))
runner = GraphRunner()
caps = [runner.capture(o) for o in outs]
runner.run_batch(n_workers=1)
assert all(c.events for c in caps), [len(c.events) for c in caps]
print("PANDAS", attempts, "pandas" in sys.modules)
"""


def test_temporal_runs_with_pandas_blocked():
    """Every temporal entry point, numeric and datetime times, runs in a
    process where importing pandas raises (the chip machine has none)."""
    proc = subprocess.run([sys.executable, "-c", _TEMPORAL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "PANDAS [] False" in proc.stdout, proc.stdout


_CONFIGS = """
import os
import sys
import tempfile

BLOCKED = ("pandas", "pyarrow", "jax", "pathway_tpu", "aiohttp", "optax")
for name in BLOCKED:  # importing any of them raises; find_spec says absent
    sys.modules[name] = None
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.runner import GraphRunner
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.stdlib.indexing import (
    default_brute_force_knn_document_index)
from pathway_tpu_torch.stdlib.ml import KNNIndex
from pathway_tpu_torch.xpacks.llm import llms, prompts, rerankers
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder
from pathway_tpu_torch.xpacks.llm.question_answering import (
    AdaptiveRAGQuestionAnswerer)
from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

root = tempfile.mkdtemp()
# config 1: a CSV into KNNIndex
with open(os.path.join(root, "v.csv"), "w") as f:
    f.write("doc_id,a,b,c\\n" + "".join(
        f"{i},{i % 3},{i % 5},{i % 7}\\n" for i in range(30)))
t = pw.io.csv.read(os.path.join(root, "v.csv"), mode="static")
data = t.select(pw.this.doc_id, vec=pw.apply_with_type(
    lambda *xs: np.array(xs, float), np.ndarray, t.a, t.b, t.c))
qs = pw.debug.table_from_rows(pw.schema_from_types(q=np.ndarray),
                              [(np.array([1.0, 2.0, 3.0]),)])
near = KNNIndex(data.vec, data, n_dimensions=3, device="cpu"
                ).get_nearest_items(qs.q, k=2, with_distances=True)
# config 3: files into the adaptive answerer, with its reranker
docs_dir = os.path.join(root, "docs")
os.makedirs(docs_dir)
for i in range(6):
    with open(os.path.join(docs_dir, f"f{i}.txt"), "w") as f:
        f.write(f"document {i} about word{i} and word{i + 1}")


class Chat(llms.BaseChat):
    async def __wrapped__(self, messages, **kwargs):
        prompt = self._as_messages(messages)[-1]["content"]
        return "yes" if prompt.count("[doc ") >= 2 else prompts.NO_INFO_ANSWER


emb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")
store = VectorStoreServer(
    pw.io.fs.read(docs_dir, format="plaintext_by_file", mode="static",
                  with_metadata=True),
    embedder=emb, splitter=TokenCountSplitter(max_tokens=5),
    index_builder=lambda c: default_brute_force_knn_document_index(
        c.text, c, embedder=emb, dimensions=64, dtype="bfloat16"))
rag = AdaptiveRAGQuestionAnswerer(Chat(), store, n_starting_documents=1)
questions = pw.debug.table_from_rows(
    pw.schema_from_types(prompt=str, filters=str | None), [("word3", None)])
scored = questions.select(s=rerankers.EncoderReranker(emb)(
    pw.this.prompt, pw.this.prompt))
runner = GraphRunner()
caps = [runner.capture(x) for x in (near, rag.answer_query(questions),
                                    scored)]
runner.run_batch(n_workers=1)
assert [len(c.events) for c in caps] == [1, 1, 1], caps
assert caps[1].events[0][1] == ("yes",), caps[1].events
print("LOADED", sorted(m for m, mod in sys.modules.items()
                      if mod is not None and m.split(".")[0] in BLOCKED))
"""


def test_configs_1_and_3_run_without_jax_pandas_or_aiohttp():
    """BASELINE.md's configs 1 (a CSV into ``KNNIndex``) and 3 (files into
    the adaptive answerer and its reranker) run on the CPU in a process
    where importing jax, pathway_tpu, pandas, pyarrow, aiohttp or optax
    raises, and none of them is loaded."""
    proc = subprocess.run([sys.executable, "-c", _CONFIGS], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


_CONFIG5 = """
import json
import sys
import threading
import time

BLOCKED = ("jax", "pathway_tpu", "kafka", "confluent_kafka", "pandas",
           "aiohttp", "optax")
for name in BLOCKED:  # importing any of them raises; find_spec says absent
    sys.modules[name] = None
import torch
import pathway_tpu_torch as pw
from chip_smoke import LogBroker
from pathway_tpu_torch.engine import streaming
from pathway_tpu_torch.io.kafka._protocol import KafkaClient
from pathway_tpu_torch.models.encoder import EncoderConfig
from pathway_tpu_torch.parallel import (MeshConfig, ShardedKnnIndex,
                                        make_mesh, use_mesh)
from pathway_tpu_torch.stdlib.indexing import (
    default_brute_force_knn_document_index, nearest_neighbors)
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

docs = [f"doc {i} word{i} word{i * 7} word{i * 3}" for i in range(32)]
broker = LogBroker({"docs": 4, "queries": 1})
settings = {"bootstrap.servers": f"127.0.0.1:{broker.port}"}
client = KafkaClient(settings["bootstrap.servers"])
for p in range(4):
    client.produce("docs", p, [(None, json.dumps({"doc": docs[i]}).encode())
                               for i in range(p, 32, 4)])
built = []
build = nearest_neighbors.BruteForceKnnFactory.build
nearest_neighbors.BruteForceKnnFactory.build = \
    lambda self: built.append(build(self)) or built[-1]
emb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")
t = pw.io.kafka.read(settings, topic="docs", format="json",
                     schema=pw.schema_from_types(doc=str),
                     autocommit_duration_ms=20)
q = pw.io.kafka.read(settings, topic="queries", format="json",
                     schema=pw.schema_from_types(query=str),
                     autocommit_duration_ms=20)
index = default_brute_force_knn_document_index(
    t.doc, t, embedder=emb, dimensions=64, mesh="auto", dtype="bfloat16",
    device="cpu")
res = index.query_as_of_now(q.query, number_of_matches=2)
answers = []
pw.io.subscribe(res, lambda key, row, time, is_addition:
                answers.append(row["doc"]))
with use_mesh(make_mesh(MeshConfig(data=4), devices=["cpu"] * 4)):
    th = threading.Thread(target=pw.run, daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while not (built and len(built[0]) == 32):
        assert time.monotonic() < deadline and th.is_alive()
        time.sleep(0.02)
    client.produce("queries", 0, [(None, json.dumps({"query": docs[5]})
                                   .encode())])
    while not answers:
        assert time.monotonic() < deadline and th.is_alive()
        time.sleep(0.02)
    streaming.stop_all()
    th.join(30)
client.close()
broker.close()
assert not th.is_alive()
assert isinstance(built[0], ShardedKnnIndex) and built[0].n_shards == 4
assert answers[0][0] == docs[5], answers
print("LOADED", sorted(m for m, mod in sys.modules.items()
                      if mod is not None and m.split(".")[0] in BLOCKED))
"""


def test_config5_runs_without_jax_or_a_kafka_package():
    """BASELINE.md config 5 on the CPU — a Kafka topic (chip_smoke.py's
    broker on 127.0.0.1) read by ``pw.io.kafka`` at 4 workers into
    ``mesh="auto"`` under a 4-shard CPU mesh — runs in a process where
    importing jax, pathway_tpu, kafka, confluent_kafka, pandas, aiohttp or
    optax raises, and none of them is loaded."""
    env = dict(os.environ, PATHWAY_THREADS="4")
    proc = subprocess.run([sys.executable, "-c", _CONFIG5], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


_ML_AND_PROFILER = """
import os
import sys
import tempfile

BLOCKED = ("jax", "pathway_tpu", "networkx", "sklearn", "pandas")
for name in BLOCKED:  # importing any of them raises; find_spec says absent
    sys.modules[name] = None
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.profiler import Profiler, install_profiler
from pathway_tpu_torch.internals.runner import run_tables
from pathway_tpu_torch.stdlib.ml import classifiers, hmm
from pathway_tpu_torch.stdlib.ml.datasets import classification

prof = Profiler(sample_interval_ms=2.0, device="cpu")
install_profiler(prof)
prof.start()
out_dir = prof.start_device_capture(tempfile.mkdtemp())
rng = np.random.default_rng(0)
pts = np.concatenate([c * 10.0 + rng.standard_normal((20, 6)) * 0.3
                      for c in np.eye(3, 6)])
labels = [f"c{i // 20}" for i in range(60)]
data = pw.debug.table_from_rows(
    pw.schema_from_types(data=np.ndarray, label=str),
    [(pts[i], labels[i]) for i in range(60)])
queries = pw.debug.table_from_rows(pw.schema_from_types(data=np.ndarray),
                                   [(pts[5],), (pts[25],), (pts[45],)])
bucketed = classifiers.knn_lsh_classify(
    classifiers.knn_lsh_euclidean_classifier_train(data, d=6, M=4, L=12,
                                                   A=2.0), queries, k=3)
exact = classifiers.knn_lsh_classify(
    classifiers.knn_lsh_classifier_train(data, n_dimensions=6,
                                         device="cpu"), queries, k=3)
clusters = classifiers.clustering_via_lsh(
    data.select(data.data),
    classifiers.generate_euclidean_lsh_bucketer(6, M=3, L=8, A=4.0), 3,
    device="cpu")


class Nodes(dict):
    def __call__(self):
        return list(self)


class Graph:
    def __init__(self):
        self.nodes, self.graph = Nodes(), {"start_nodes": ["a"]}

    def edges(self, data=False):
        return [("a", "a", {"log_transition_ppb": 0.0})]


g = Graph()
g.nodes["a"] = {"calc_emission_log_ppb": lambda obs: -1.0}
obs = pw.debug.table_from_rows(pw.schema_from_types(o=str), [("x",)])
decoded = obs.reduce(s=pw.reducers.udf_reducer(
    hmm.create_hmm_reducer(g))(obs.o))
fuzzy = pw.ml.fuzzy_match(data.label, data.label)
caps = run_tables(bucketed, exact, clusters, decoded, fuzzy)
got = [sorted(v[0] for v in c.snapshot().values()) for c in caps[:2]]
assert got == [["c0", "c1", "c2"]] * 2, got
assert len(set(v[0] for v in caps[2].snapshot().values())) == 3
assert list(caps[3].snapshot().values()) == [(("a",),)]
try:
    classification.load_digits_sample(50)
except ImportError as e:
    print("DIGITS", e)
prof.stop_device_capture()
prof.stop()
install_profiler(None)
fams = prof.family_stats()
assert fams["knn_search"]["dispatches"] >= 1, fams
assert os.listdir(out_dir), out_dir
print("LOADED", sorted(m for m, mod in sys.modules.items()
                      if mod is not None and m.split(".")[0] in BLOCKED))
"""


def test_ml_and_profiler_run_without_jax_networkx_sklearn_or_pandas():
    """``pw.stdlib.ml`` (the bucketed and exact classifiers, LSH clustering
    with its k-means, HMM decoding on a duck-typed graph, the fuzzy join)
    and the profiler (sampler, dispatch records, a torch.profiler capture)
    run on the CPU in a process where importing jax, pathway_tpu,
    networkx, sklearn or pandas raises, and none of them is loaded; the
    digits loader fails in its own call, naming scikit-learn."""
    proc = subprocess.run([sys.executable, "-c", _ML_AND_PROFILER],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "DIGITS load_digits_sample needs scikit-learn" in proc.stdout, \
        proc.stdout
    assert "LOADED []" in proc.stdout, proc.stdout


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


def _in_functions(tree) -> set[int]:
    """ids of the nodes inside a function body: imported at call time,
    not when the module is."""
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for stmt in node.body:
                inside |= {id(n) for n in ast.walk(stmt)}
    return inside


def _imports(path):
    """(module, guarded by ``except ImportError``, inside a function) for
    every absolute import of the file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    guarded, lazy = _guarded_imports(tree), _in_functions(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            yield n, id(node) in guarded, id(node) in lazy


def test_no_forbidden_import_in_port_sources():
    offenders = [(path, n) for path in _port_files()
                 for n, _guarded, _lazy in _imports(path)
                 if _is_forbidden(n)]
    assert not offenders


def test_port_imports_only_what_the_chip_machine_has():
    """Every import of the port and of chip_smoke.py is of the standard
    library or of a package the chip machine has, unless the module runs
    without it (an import guarded by ``except ImportError``, or one of
    LAZY_PACKAGES inside a function)."""
    offenders = []
    for path in _port_files():
        for n, guarded, lazy in _imports(path):
            top = n.split(".")[0]
            if top in sys.stdlib_module_names or top in CHIP_PACKAGES:
                continue
            if not guarded and not (lazy and top in LAZY_PACKAGES):
                offenders.append((os.path.relpath(path, REPO), n))
    assert not offenders


def test_the_isolation_checks_catch_an_offender(tmp_path):
    """The two checks above on a file that imports aiohttp and yaml at the
    top, pandas under ``except ImportError``, and optax and PIL inside a
    function."""
    bad = tmp_path / "bad.py"
    bad.write_text("import aiohttp\nfrom yaml import safe_dump\n"
                   "try:\n    import pandas\nexcept ImportError:\n"
                   "    pandas = None\n"
                   "def f():\n    import optax\n    from PIL import Image\n")
    got = sorted(_imports(str(bad)))
    assert got == [("PIL", False, True), ("aiohttp", False, False),
                   ("optax", False, True), ("pandas", True, False),
                   ("yaml", False, False)]
    assert [n for n, _, _ in got if _is_forbidden(n)] == ["aiohttp",
                                                          "optax"]


_BLOCKED = """
import importlib
import importlib.abc
import pkgutil
import sys

attempts = []


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("optax", "PIL"):
            attempts.append(name)
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import pathway_tpu_torch

names = [m.name for m in pkgutil.walk_packages(pathway_tpu_torch.__path__,
                                               "pathway_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from pathway_tpu_torch.models import clip

try:
    clip.load_image(b"not an image", config=clip.ClipConfig.tiny())
except ImportError as e:
    print("LOAD_IMAGE", e)
print("MODULES", len(names), "ATTEMPTS", attempts)
"""


def test_port_modules_import_with_optax_and_pil_blocked():
    """Every module of the port imports in a process where importing
    optax or PIL raises (the chip machine has neither); load_image fails
    in its own call, naming PIL."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOAD_IMAGE PIL is blocked" in proc.stdout, proc.stdout
    assert "ATTEMPTS ['PIL']" in proc.stdout, proc.stdout


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from pathway_tpu_torch.engine.profiler import Profiler
    from pathway_tpu_torch.models import clip, train
    from pathway_tpu_torch.models.encoder import (Encoder, EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.stdlib.ml.classifiers import kmeans_labels
    from pathway_tpu_torch.xpacks.llm.embedders import (ClipEmbedder,
                                                        EncoderEmbedder)
    from pathway_tpu_torch.xpacks.llm.llms import HFPipelineChat

    cfg = EncoderConfig.tiny()
    ccfg = clip.ClipConfig.tiny()
    params = init_params_host(0, cfg)
    calls = [
        lambda: EncoderEmbedder(config=cfg),
        lambda: BruteForceKnnIndex(8),
        lambda: BruteForceKnnIndex(8, paged=False),
        lambda: Encoder.from_params(params, cfg),
        lambda: Encoder.from_params(params, cfg, trainable=True),
        lambda: train.init_train_state(0, cfg),
        lambda: train.train_state_from_jax(
            {"params": params, "opt_state": (), "step": 0}, cfg),
        lambda: clip.ClipModel.from_params(clip.init_clip_params(0, ccfg),
                                           ccfg),
        lambda: ClipEmbedder(config=ccfg),
        lambda: kmeans_labels([[0.0, 1.0]] * 4, [1.0] * 4, 2),
        lambda: Profiler(),
        lambda: HFPipelineChat(model="a-local-model"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the classic KNNIndex: its index is built when the graph is lowered
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.stdlib.ml import KNNIndex

    G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(v=np.ndarray),
                                 [(np.ones(4),)])
    out = KNNIndex(t.v, t, n_dimensions=4).get_nearest_items(t.v, k=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphRunner().capture(out)
    G.clear()


def test_cuda_device_carries_its_index(monkeypatch):
    """"cuda" resolves to "cuda:<current>", the device of the tensors made
    on it, so the index's device checks accept the encoder's output."""
    from pathway_tpu_torch._device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
