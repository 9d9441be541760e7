"""The two served graphs of chip_smoke.py's serving phase, at a small size
on the CPU, in the port and in the JAX package: each package's graph
under its own ``pw.run`` on a thread, documents streaming in while HTTP
queries arrive, then the stream paused and held queries answered by both.

(a) bench.py's ``bench_serving`` graph: an ``IngestSubject`` pushes
    vectors (here 2,000 of dim 64, f32) in chunks, then a fixed trickle,
    into ``default_brute_force_knn_document_index(data.v, data, ...)``
    (``device="cpu"`` in the port); POSTs to a ``rest_connector`` route
    ``/query`` go through ``query_as_of_now``. The held replies' match
    ids equal the JAX package's exactly (f32). The rows carry their index
    as a primary key so both packages key them alike.
(b) ``VectorStoreServer(...).run_server(threaded=True)`` over documents
    from a ``ConnectorSubject`` (schema ``data: str``) with the tiny
    encoder, f32 and bf16 indexes: held ``/v1/retrieve`` replies (k = 3
    and k = 80, past K_MAX) equal the JAX package's within the tolerance
    of tests/test_torch_vector_store.py; ``/v1/statistics`` counts the
    documents pushed (and, asked before the first document, the left
    join's empty row, as the JAX package answers); ``VectorStoreClient``
    returns the raw POST's reply.

Every request has a deadline, every run ``stop_all()`` in a finally and
a ``join`` whose timeout fails the test. The JAX side runs with
``PATHWAY_AUTO_JIT=0`` and ``PATHWAY_RESULT_CACHE=0``.
"""

import importlib
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

DEADLINE_S = 60.0
ATOL = 1e-4  # tests/test_torch_vector_store.py's tolerance for this encoder
N_VECS, DIM, CHUNK, TRICKLE = 2000, 64, 512, (3, 64)
N_DOCS, DOC_CHUNK = 300, 64


@pytest.fixture(autouse=True)
def _reference_options(monkeypatch, tmp_path):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER", "1")
    # run_server's default disk cache writes under ./Cache, and it is the
    # process-wide default of every UDF prepared after it: both packages'
    # defaults go back to none after the test
    monkeypatch.chdir(tmp_path)
    for pkg in ("pathway_tpu", "pathway_tpu_torch"):
        udfs = importlib.import_module(f"{pkg}.internals.udfs")
        monkeypatch.setattr(udfs, "_DEFAULT_CACHE", None)


def _side(name: str):
    """(pw, engine.streaming, the parse graph G) of one package."""
    pkg = "pathway_tpu" if name == "jax" else "pathway_tpu_torch"
    return (importlib.import_module(pkg),
            importlib.import_module(f"{pkg}.engine.streaming"),
            importlib.import_module(f"{pkg}.internals.parse_graph").G)


def _mod(pw, path: str):
    return importlib.import_module(f"{pw.__name__}.{path}")


def _post(url: str, payload) -> tuple[int, object]:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=DEADLINE_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, what: str, errors: list) -> None:
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert not errors, errors
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.01)


def _ingested(streaming, name: str) -> int:
    """Rows the runtime has pushed through the source named ``name`` (the
    scheduler's per-node stats, bench.py's serving_ingested_rows)."""
    total = 0
    for rt in list(streaming._ACTIVE_RUNTIMES):
        for nid, st in rt.scheduler.stats.items():
            if rt.runner.graph.nodes[nid].name == name:
                total += st.get("insertions", 0)
    return total


class _Served:
    """Start ``pw.run`` of the current graph on a thread; ``close()``
    stops it and fails if the thread outlives the join."""

    def __init__(self, pw, streaming, G, start=None):
        self.streaming, self.G = streaming, G
        self.errors: list = []

        def run():
            try:
                if start is None:
                    pw.run()
                else:
                    start().join()
            except Exception as e:  # re-raised by the test's asserts
                self.errors.append(e)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def close(self) -> None:
        try:
            self.streaming.stop_all()
            self.thread.join(DEADLINE_S)
        finally:
            self.G.clear()
        assert not self.thread.is_alive(), "the run outlived stop_all()"
        assert not self.errors, self.errors


# -- (a) bench_serving's graph ----------------------------------------------

def _graph_a(name: str, queries: np.ndarray) -> dict:
    pw, streaming, G = _side(name)
    loaded, paused = threading.Event(), threading.Event()

    class IngestSubject(pw.io.python.ConnectorSubject):
        """bench.py's subject at a small size; its trickle is a fixed
        number of bursts, after which it holds (the stream paused)."""

        def run(self):
            rng = np.random.default_rng(1)
            pushed = 0
            while pushed < N_VECS:
                m = min(CHUNK, N_VECS - pushed)
                for v in rng.random((m, DIM), np.float32) * 2.0 - 1.0:
                    self.next(i=pushed, v=v)
                    pushed += 1
                if not self._session.sleep(0.002):
                    return
            loaded.set()
            for _ in range(TRICKLE[0]):
                for v in rng.random((TRICKLE[1], DIM), np.float32) * 2 - 1:
                    self.next(i=pushed, v=v)
                    pushed += 1
                if not self._session.sleep(0.02):
                    return
            paused.set()
            self._session.stopping.wait()

    class Vec(pw.Schema):
        i: int = pw.column_definition(primary_key=True)
        v: np.ndarray

    G.clear()
    data = pw.io.python.read(IngestSubject(), schema=Vec,
                             autocommit_duration_ms=10, name="serving_ingest")
    kw = {"device": "cpu"} if name == "torch" else {}
    index = _mod(pw, "stdlib.indexing").default_brute_force_knn_document_index(
        data.v, data, dimensions=DIM, reserved_space=N_VECS + 1024,
        dtype="float32", **kw)
    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=0)
    qs, writer = pw.io.http.rest_connector(
        webserver=ws, route="/query",
        schema=pw.schema_from_types(vec=_mod(pw, "internals.dtype").ANY,
                                    k=int),
        methods=("POST",), delete_completed_queries=True,
        autocommit_duration_ms=5)
    qv = qs.select(qv=pw.apply(lambda v: np.asarray(v, dtype=np.float32),
                               qs.vec), k=qs.k)
    res = index.query_as_of_now(qv.qv, number_of_matches=qv.k)
    writer(res.select(
        n_matches=pw.apply(len, res._pw_index_reply_id),
        ids=pw.apply(lambda ids: [str(i) for i in ids],
                     res._pw_index_reply_id)))
    served = _Served(pw, streaming, G)
    out = {"live": [], "held": []}
    try:
        _wait(lambda: ws._started.is_set() and ws.port, "the webserver",
              served.errors)
        url = f"http://127.0.0.1:{ws.port}/query"
        _wait(loaded.is_set, "the bulk load", served.errors)
        for q in queries[:4]:  # answered under live ingest
            out["live"].append(_post(url, {"vec": q.tolist(), "k": 10}))
        total = N_VECS + TRICKLE[0] * TRICKLE[1]
        _wait(lambda: paused.is_set()
              and _ingested(streaming, "serving_ingest") >= total,
              "the paused stream's last tick", served.errors)
        out["ingested"] = _ingested(streaming, "serving_ingest")
        for q in queries[4:]:
            out["held"].append(_post(url, {"vec": q.tolist(), "k": 10}))
        rt = next(iter(streaming._ACTIVE_RUNTIMES))
        out["spans"] = rt.recorder.requests.trace_spans()
    finally:
        served.close()
    return out


def test_bench_serving_graph_equals_reference():
    queries = np.random.default_rng(2).random((12, DIM), np.float32) * 2 - 1
    jax = _graph_a("jax", queries)
    port = _graph_a("torch", queries)
    total = N_VECS + TRICKLE[0] * TRICKLE[1]
    assert port["ingested"] == jax["ingested"] == total
    for status, reply in port["live"] + port["held"]:
        assert status == 200 and reply["n_matches"] == 10
    assert port["held"] == jax["held"]  # ids exact in f32
    spans = port["spans"]
    assert len(spans) == 12
    for r in spans:
        assert sum(r["stages"].values()) == pytest.approx(r["e2e_ms"],
                                                          abs=0.01)
        assert r["tick"] is not None and r["stages"]["admission_wait"] < 5


# -- (b) the live RAG server ------------------------------------------------

DOCS = None


def _docs():
    global DOCS
    if DOCS is None:
        rng = np.random.default_rng(0)
        vocab = [f"word{i}" for i in range(512)]
        DOCS = [" ".join(vocab[j] for j in rng.integers(0, 512, size=m))
                for m in rng.integers(4, 40, size=N_DOCS + 3 * 16)]
    return DOCS


def _embedder(name: str, params):
    if name == "jax":
        import jax.numpy as jnp

        from pathway_tpu.models.encoder import EncoderConfig as JConfig
        from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder

        return JaxEncoderEmbedder(
            config=JConfig.tiny(compute_dtype=jnp.float32, pooling="mean"),
            params=params)
    import torch

    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    return EncoderEmbedder(
        config=EncoderConfig.tiny(compute_dtype=torch.float32,
                                  pooling="mean"),
        params=params, device="cpu")


def _graph_b(name: str, params, dtype: str, texts: list) -> dict:
    pw, streaming, G = _side(name)
    docs = _docs()
    go, loaded, paused = threading.Event(), threading.Event(), \
        threading.Event()

    class DocSubject(pw.io.python.ConnectorSubject):
        def run(self):
            # no document before the empty statistics are asked for
            while not go.wait(0.05):
                if self._session.stopping.is_set():
                    return
            for b in range(0, N_DOCS, DOC_CHUNK):
                for d in docs[b:min(b + DOC_CHUNK, N_DOCS)]:
                    self.next(data=d)
                if not self._session.sleep(0.002):
                    return
            loaded.set()
            for b in range(N_DOCS, len(docs), 16):
                for d in docs[b:b + 16]:
                    self.next(data=d)
                if not self._session.sleep(0.02):
                    return
            paused.set()
            self._session.stopping.wait()

    mod = _mod(pw, "xpacks.llm.vector_store")
    idx = _mod(pw, "stdlib.indexing")
    G.clear()
    source = pw.io.python.read(DocSubject(),
                               schema=pw.schema_from_types(data=str),
                               autocommit_duration_ms=10, name="docs")
    emb = _embedder(name, params)
    store = mod.VectorStoreServer(
        source, embedder=emb,
        index_builder=lambda chunks: idx.default_brute_force_knn_document_index(
            chunks.text, chunks, embedder=emb, dimensions=64,
            reserved_space=len(docs) + 64, dtype=dtype))
    port = _free_port()
    os.makedirs(name, exist_ok=True)
    os.chdir(name)  # each package's disk cache in a directory of its own
    served = _Served(pw, streaming, G, start=lambda: store.run_server(
        host="127.0.0.1", port=port, threaded=True))
    base = f"http://127.0.0.1:{port}"
    out = {"live": [], "held": []}
    try:
        def up():
            try:
                with socket.create_connection(("127.0.0.1", port), 1):
                    return True
            except OSError:
                return False

        _wait(up, "the webserver", served.errors)
        ask = {"metadata_filter": None, "filepath_globpattern": None}
        # before the first document: the left join's row without a match
        # (the JAX package's webserver accepts connections before its
        # routes are added: 404 until then)
        def stats_routed():
            out["stats_empty"] = _post(base + "/v1/statistics", {})
            return out["stats_empty"][0] != 404

        _wait(stats_routed, "the statistics route", served.errors)
        out["inputs_empty"] = _post(base + "/v1/inputs", ask)
        go.set()
        _wait(loaded.is_set, "the bulk load", served.errors)
        for t in texts[:2]:
            out["live"].append(_post(base + "/v1/retrieve",
                                     {"query": t, "k": 3, **ask}))
        _wait(lambda: paused.is_set()
              and _ingested(streaming, "docs") >= len(docs),
              "the paused stream's last tick", served.errors)
        for t in texts[2:]:
            out["held"].append(_post(base + "/v1/retrieve",
                                     {"query": t, "k": 3, **ask}))
        out["held"].append(_post(base + "/v1/retrieve",
                                 {"query": texts[2], "k": 80, **ask}))
        out["two_keys"] = _post(base + "/v1/retrieve",
                                {"query": texts[2], "k": 3})
        out["stats"] = _post(base + "/v1/statistics", {})
        out["inputs"] = _post(base + "/v1/inputs", ask)
        if name == "torch":
            # the index embeds its text itself: the embedder is never a
            # column UDF here, so the default cache never wraps it
            assert emb.cache_strategy is None and emb._prepared is None
            client = mod.VectorStoreClient(url=base, timeout=DEADLINE_S)
            out["client"] = (client.query(texts[2], k=3),
                             client.get_vectorstore_statistics(),
                             client.get_input_files())
    finally:
        os.chdir("..")
        served.close()
    out["cache_files"] = sorted(os.listdir(os.path.join(
        name, "Cache", "udf_cache", "default")))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vector_store_server_equals_reference(dtype):
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)

    params = init_params_host(0, EncoderConfig.tiny())
    docs = _docs()
    texts = [docs[7], docs[N_DOCS + 5], docs[3], docs[N_DOCS + 40],
             "word1 word2 word3", docs[150]]
    jax = _graph_b("jax", params, dtype, texts)
    port = _graph_b("torch", params, dtype, texts)
    for status, reply in port["live"]:
        assert status == 200 and len(reply) == 3
    assert len(port["held"]) == len(jax["held"]) == 5
    for (js, jrep), (ts, trep) in zip(jax["held"], port["held"]):
        assert js == ts == 200 and len(trep) == len(jrep)
        jd = [m["dist"] for m in jrep]
        td = [m["dist"] for m in trep]
        # bf16 rows are the same bf16 values on both sides: the scores
        # differ by the f32 summation order, as in test_torch_vector_store
        np.testing.assert_allclose(td, jd, rtol=0, atol=ATOL)
        for r, (jm, tm) in enumerate(zip(jrep, trep)):
            near = [s for s in (r - 1, r + 1) if 0 <= s < len(jd)
                    and abs(jd[s] - jd[r]) <= ATOL]
            if not near:
                assert tm["text"] == jm["text"]
        assert sorted(m["text"] for m in trep) == \
            sorted(m["text"] for m in jrep)
    # copies of ingested documents find themselves first
    for text, (_, rep) in zip(texts[2:] + [texts[2]], port["held"]):
        if text in docs:
            assert rep[0]["text"] == text
    assert len(port["held"][-1][1]) == 80
    # the reference's schema has no defaults for the two filters: a POST
    # without them is a 400 in both packages
    assert port["two_keys"] == jax["two_keys"]
    assert port["two_keys"][0] == 400
    # /v1/statistics and /v1/inputs go through join_left in both packages
    assert port["stats_empty"] == jax["stats_empty"]
    assert port["stats_empty"] == (200, {"file_count": None,
                                         "last_modified": None})
    assert port["inputs_empty"] == jax["inputs_empty"] == (200, [])
    assert port["stats"] == jax["stats"]
    assert port["stats"][1]["file_count"] == len(docs)
    assert port["inputs"] == jax["inputs"]
    held_reply, stats, inputs = port["client"]
    assert held_reply == port["held"][0][1]
    assert stats == port["stats"][1] and inputs == port["inputs"][1]
    # the default disk cache took the response formatters, as the JAX
    # package's did; no embedder is a column UDF in this graph
    assert port["cache_files"] and jax["cache_files"]


def test_disk_cache_and_the_default_cache(monkeypatch, tmp_path):
    """``DiskCache`` keys and stores as the JAX package's does (the same
    file for the same call), under PATHWAY_PERSISTENT_STORAGE; once set
    as the default, a batch device UDF prepared after it returns what it
    returns uncached."""
    import torch

    from pathway_tpu.internals import udfs as judfs
    from pathway_tpu_torch.internals import udfs as tudfs
    from pathway_tpu_torch.internals.runner import GraphRunner
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    calls = []

    def area(w, h):
        calls.append((w, h))
        return w * h

    for side, mod in (("jax", judfs), ("torch", tudfs)):
        monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", str(tmp_path / side))
        cached = mod.DiskCache("t").wrap_sync(area)
        assert [cached(2, 3), cached(2, 3), cached(4, 5)] == [6, 6, 20]
    assert calls == [(2, 3), (4, 5)] * 2
    assert sorted(os.listdir(tmp_path / "jax" / "udf_cache" / "t")) == \
        sorted(os.listdir(tmp_path / "torch" / "udf_cache" / "t"))
    monkeypatch.delenv("PATHWAY_PERSISTENT_STORAGE")

    pw, _, G = _side("torch")
    texts = _docs()[:40]
    cfg = EncoderConfig.tiny(compute_dtype=torch.float32)
    emb = EncoderEmbedder(config=cfg, params=init_params_host(0, cfg),
                          device="cpu")
    want = emb.embed_batch(texts)
    tudfs.set_default_cache(tudfs.DefaultCache())  # ./Cache, tmp_path
    out = []
    for _ in range(2):  # the second run reads the cache
        G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(data=str),
                                     [(d, 0, 1) for d in texts])
        runner = GraphRunner()
        cap = runner.capture(t.select(e=emb(t.data)))
        runner.run_batch()
        out.append({row[0].tobytes() for _, row, _, _ in cap.events})
    G.clear()
    assert isinstance(emb.cache_strategy, tudfs.DiskCache)
    assert os.listdir(tmp_path / "Cache" / "udf_cache" / "default")
    assert out[0] == out[1] == {np.asarray(v).tobytes() for v in want}
