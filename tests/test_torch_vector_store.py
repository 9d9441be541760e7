"""The port's ``VectorStoreServer`` against the JAX package's: the same
streamed documents and queries, the same encoder weights, each package's
``retrieve_query`` / ``statistics_query`` / ``inputs_query`` captured
under its own ``GraphRunner.run_batch(n_workers=1)``.

The index is bench.py's ``bench_embed_framework`` graph at a small size:
``index_builder=lambda chunks: default_brute_force_knn_document_index(
chunks.text, chunks, embedder=emb, ...)``, so the index takes raw text and
embeds it on the device itself (DeviceEmbeddingKnnIndex). Three
configurations: the padded embedder into a float32 and into a bfloat16
index, the ragged embedder into an int8 index (cos); the identity graph
and a parser + splitter graph (two flattens). Queries arrive before,
during and after the ingest.

Checked: keys, times and diffs exact; in each reply the match texts and
metadata exact, and in rank order wherever consecutive scores differ by
more than ``ATOL = 1e-4`` (the tolerance of tests/test_torch_slice.py for
this encoder: f32 sums in a different order on each side); scores
(``dist``) within ``ATOL``. The JAX side runs with ``PATHWAY_AUTO_JIT=0``,
``PATHWAY_DEVICE_INFLIGHT=1`` and ``PATHWAY_RESULT_CACHE=0``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu.models.encoder import EncoderConfig as JConfig
from pathway_tpu.stdlib.indexing import \
    default_brute_force_knn_document_index as jdefault_index
from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder
from pathway_tpu.xpacks.llm.vector_store import \
    VectorStoreServer as JVectorStoreServer
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner
from pathway_tpu_torch.models.encoder import EncoderConfig, init_params_host
from pathway_tpu_torch.stdlib.indexing import \
    default_brute_force_knn_document_index as tdefault_index
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder
from pathway_tpu_torch.xpacks.llm.vector_store import \
    VectorStoreServer as TVectorStoreServer

N_DOCS, PER_TICK = 72, 16  # 5 ticks at times 2, 4, ..., 10; the last short
ATOL = 1e-4
SIDES = {"jax": (jpw, JRunner, JVectorStoreServer, jdefault_index),
         "torch": (tpw, TRunner, TVectorStoreServer, tdefault_index)}
CONFIGS = [(False, "float32"), (False, "bfloat16"), (True, "int8")]


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")


def make_docs(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(512)]
    lens = rng.integers(4, 40, size=n)
    return [" ".join(vocab[j] for j in rng.integers(0, 512, size=m))
            for m in lens]


DOCS = make_docs(N_DOCS, seed=0)
FRESH = make_docs(4, seed=1)


@pytest.fixture(scope="module")
def params():
    return init_params_host(0, EncoderConfig.tiny())


def _embedder(side: str, params, ragged: bool):
    if side == "jax":
        return JaxEncoderEmbedder(
            config=JConfig.tiny(compute_dtype=jnp.float32, pooling="mean"),
            params=params, ragged=ragged)
    return EncoderEmbedder(
        config=EncoderConfig.tiny(compute_dtype=torch.float32,
                                  pooling="mean"),
        params=params, ragged=ragged, device="cpu")


def _docs_table(pw):
    rows = [(doc, pw.Json({"path": f"/d{i}.txt", "modified_at": 100 + i}),
             2 * (1 + i // PER_TICK), 1) for i, doc in enumerate(DOCS)]
    return pw.debug.table_from_rows(
        pw.schema_from_types(data=str, _metadata=pw.Json), rows,
        is_stream=True)


def _queries_table(pw):
    """Before the first document (time 0), between ticks (5), at a tick's
    own time (6: its documents are indexed first) and after the last
    (12): copies of ingested and of later documents, fresh texts."""
    spec = [(0, DOCS[0], 3), (0, FRESH[0], 2),
            (5, DOCS[3], 3), (5, DOCS[40], 3), (5, FRESH[1], 4),
            (6, DOCS[40], 2), (6, DOCS[47], 5),
            (12, DOCS[70], 3), (12, DOCS[5], 1), (12, FRESH[2], 5),
            (12, FRESH[3], N_DOCS + 10)]
    rows = [(text, k, None, None, t, 1) for t, text, k in spec]
    return pw.debug.table_from_rows(
        pw.schema_from_types(query=str, k=int, metadata_filter=str | None,
                             filepath_globpattern=str | None),
        rows, is_stream=True)


def _split_halves(text: str) -> list[tuple[str, dict]]:
    words = text.split(" ")
    mid = max(1, len(words) // 2)
    return [(" ".join(words[:mid]), {"part": 0}),
            (" ".join(words[mid:]) or "empty", {"part": 1})]


def _server(side: str, params, ragged: bool, dtype: str, parsed: bool):
    pw, _, Server, default_index = SIDES[side]
    emb = _embedder(side, params, ragged)
    kw = {}
    if parsed:
        kw = dict(parser=lambda data: [(data, {"parsed": True})],
                  splitter=_split_halves)
    return pw, Server(
        _docs_table(pw), embedder=emb,
        index_builder=lambda chunks: default_index(
            chunks.text, chunks, embedder=emb, dimensions=64,
            reserved_space=2 * N_DOCS + 64, dtype=dtype), **kw)


def _capture(side: str, build):
    _, Runner, _, _ = SIDES[side]
    runner = Runner()
    cap = runner.capture(build())
    runner.run_batch(n_workers=1)
    return sorted(((time, int(key), diff, row[0].value)
                   for key, row, time, diff in cap.events),
                  key=lambda e: e[:3])


def _hold_replies(jev, tev):
    assert [e[:3] for e in tev] == [e[:3] for e in jev]
    for (_, _, _, jrep), (_, _, _, trep) in zip(jev, tev):
        assert len(trep) == len(jrep)
        jd = [m["dist"] for m in jrep]
        td = [m["dist"] for m in trep]
        assert all(type(d) is float for d in td)
        np.testing.assert_allclose(td, jd, rtol=0, atol=ATOL)
        # ranks whose scores sit within ATOL of a neighbour may swap
        for r, (jm, tm) in enumerate(zip(jrep, trep)):
            near = [s for s in (r - 1, r + 1) if 0 <= s < len(jd)
                    and abs(jd[s] - jd[r]) <= ATOL]
            if not near:
                assert (tm["text"], tm["metadata"]) == \
                    (jm["text"], jm["metadata"])
        assert sorted(m["text"] for m in trep) == \
            sorted(m["text"] for m in jrep)


@pytest.mark.parametrize("parsed", [False, True], ids=["identity", "parsed"])
@pytest.mark.parametrize("ragged,dtype", CONFIGS,
                         ids=[f"{'ragged' if r else 'padded'}-{d}"
                              for r, d in CONFIGS])
def test_retrieve_query_equals_reference(params, ragged, dtype, parsed):
    out = {}
    for side in SIDES:
        pw, store = _server(side, params, ragged, dtype, parsed)
        out[side] = _capture(side, lambda: store.retrieve_query(
            _queries_table(pw)))
    jev, tev = out["jax"], out["torch"]
    assert len(tev) == 11 and all(d == 1 for _, _, d, _ in tev)
    _hold_replies(jev, tev)
    by_time = {}
    for t, _, _, rep in tev:
        by_time.setdefault(t, []).append(rep)
    assert by_time[0] == [[], []]  # nothing is indexed before time 2
    assert {t for t in by_time} == {0, 5, 6, 12}
    # a copy of an ingested document finds it first (its whole text when
    # the graph indexes whole documents), never a document of a later tick
    for t, _, _, rep in tev:
        for m in rep:
            i = int(m["metadata"]["path"][2:-4])
            assert 2 * (1 + i // PER_TICK) <= t
    if not parsed:
        first = {(t, rep[0]["text"]) for t, _, _, rep in tev if rep}
        for t, doc in ((5, DOCS[3]), (6, DOCS[40]), (6, DOCS[47]),
                       (12, DOCS[70]), (12, DOCS[5])):
            assert (t, doc) in first
    else:
        assert any(m["metadata"].get("parsed") and "part" in m["metadata"]
                   for _, _, _, rep in tev for m in rep)


@pytest.mark.parametrize("endpoint", ["statistics_query", "inputs_query"])
def test_statistics_and_inputs_equal_reference(params, endpoint):
    out = {}
    for side in SIDES:
        pw, store = _server(side, params, False, "float32", False)
        rows = [(t, 1) for t in (0, 5, 12)] if endpoint == \
            "statistics_query" else [(None, "/d1*", t, 1) for t in (0, 5, 12)]
        schema = store.StatisticsQuerySchema if endpoint == \
            "statistics_query" else store.InputsQuerySchema
        queries = pw.debug.table_from_rows(schema, rows, is_stream=True)
        out[side] = _capture(side, lambda: getattr(store, endpoint)(queries))
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) >= 3


@pytest.mark.parametrize("endpoint", ["statistics_query", "inputs_query"])
def test_statistics_and_inputs_lower_to_join_left(params, endpoint):
    """Both packages answer statistics and inputs through
    ``queries.join_left(stats, id=queries.id)``: the same operators in the
    same order, a left join keyed by the query id (its per-group recompute
    path) where the port once had an ``ix``, and the statistics groupby
    the row operator in both."""
    graphs = {}
    for side in SIDES:
        pw, Runner, _, _ = SIDES[side]
        pw, store = _server(side, params, False, "float32", False)
        schema = store.StatisticsQuerySchema if endpoint == \
            "statistics_query" else store.InputsQuerySchema
        queries = pw.debug.table_from_rows(schema, [], is_stream=True)
        runner = Runner()
        runner.capture(getattr(store, endpoint)(queries))
        graphs[side] = runner.graph.nodes
    types = {side: [type(n.op).__name__ for n in nodes]
             for side, nodes in graphs.items()}
    assert types["torch"] == types["jax"]
    joins = [n for n in graphs["torch"] if n.name == "join:left"]
    assert len(joins) == 1
    assert joins[0].op.mode == "left" and not joins[0].op._bilinear
    assert not any(n.name == "ix" for n in graphs["torch"])
    assert types["torch"].count("GroupByOperator") == 1
    assert "ColumnarGroupByOperator" not in types["torch"]


def test_unported_parts_raise_naming_their_item(params):
    """The default usearch index and USearchKnn raise, naming ROADMAP queue
    1, step 6; they never fall back to another index or to the CPU.
    Tenant quotas are the JAX package's: the factory's engine index tags
    its pages with the tenant and caps them as JAX's does. (The server and
    its client are ported: tests/test_torch_serving.py; the mesh-sharded
    index too: tests/test_torch_sharded_knn.py.)"""
    from pathway_tpu_torch.stdlib.indexing import USearchKnn

    emb = _embedder("torch", params, False)
    with pytest.raises(NotImplementedError, match="step 6"):
        TVectorStoreServer(_docs_table(tpw), embedder=emb)
    pw, store = _server("torch", params, False, "float32", False)
    with pytest.raises(NotImplementedError, match="step 6"):
        USearchKnn(store._graph["chunks"].text, embedder=emb)
    built = {}
    for side in ("jax", "torch"):
        _, store = _server(side, params, False, "float32", False)
        chunks = store._graph["chunks"]
        index = SIDES[side][3](
            chunks.text, chunks, embedder=_embedder(side, params, False),
            dimensions=64, tenant="acme", tenant_quotas={"acme": 1500})
        built[side] = index.inner_index.factory().build().inner
    for idx in built.values():
        idx.add_batch([0], np.ones((1, 64), np.float32))
    j, t = built["jax"], built["torch"]
    assert t._tenant == j._tenant == "acme"
    assert t._pool.allocator.tenant_quota_pages == \
        j._pool.allocator.tenant_quota_pages == {"acme": 2}
    assert t.page_stats()["tenants"] == j.page_stats()["tenants"] \
        == {"acme": 1}