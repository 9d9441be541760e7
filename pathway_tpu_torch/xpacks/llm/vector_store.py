"""VectorStoreServer, the live document-indexing graph — port of
pathway_tpu/xpacks/llm/vector_store.py (reference:
xpacks/llm/vector_store.py:41-745).

Document sources → parser UDF → post-processors → splitter → flatten →
embedder → the device KNN index, with the retrieve, statistics and inputs
queries answered against the live index (``query_as_of_now``). With
``EncoderEmbedder`` and ``default_brute_force_knn_document_index`` the
index takes raw text and embeds it on the device (DeviceEmbeddingKnnIndex):
the graph bench.py's ``bench_embed_framework`` measures.

The statistics and inputs queries look the one statistics row up with
``ix`` (the JAX package cross-joins it with ``join_left``; joins are not
ported). ``run_server`` serves the three queries over HTTP
(``/v1/retrieve``, ``/v1/statistics``, ``/v1/inputs``; io/http's stdlib
webserver) under ``pw.run``, and ``VectorStoreClient`` is its blocking
client. Not ported, each raising ``NotImplementedError`` naming its
ROADMAP item: the default usearch index (no ``index_builder`` /
``index_factory``); the LangChain and LlamaIndex adapters and the slides
server are not in the port.
"""

from __future__ import annotations

import json as _json
from typing import Any, Callable

import numpy as np

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import hash_values
from pathway_tpu_torch.stdlib.indexing import (
    DataIndex,
    default_usearch_knn_document_index,
)
from pathway_tpu_torch.xpacks.llm._utils import _unwrap_udf

# the key groupby().reduce() with no grouping columns gives its one row
_STATS_KEY = hash_values()


class VectorStoreServer:
    """Builds the live indexing graph over one or more document sources
    (reference vector_store.py:41,214-292).

    Sources must have columns ``data`` (bytes/str) and optionally
    ``_metadata`` (Json). ``embedder`` is a UDF str → vector;
    ``parser`` maps raw bytes → list[(text, meta)]; ``splitter`` maps
    text → list[(chunk, meta)].
    """

    def __init__(self, *docs, embedder, parser: Callable | None = None,
                 splitter: Callable | None = None,
                 doc_post_processors: list[Callable] | None = None,
                 index_factory=None, index_builder: Callable | None = None):
        self.docs = list(docs)
        self.embedder = embedder
        self.parser = parser
        self.splitter = splitter
        self.doc_post_processors = doc_post_processors or []
        self.index_factory = index_factory
        self.index_builder = index_builder

        if hasattr(embedder, "get_embedding_dimension"):
            self.embedding_dimension = embedder.get_embedding_dimension()
        else:
            probe = _unwrap_udf(embedder)(".")
            self.embedding_dimension = int(np.asarray(probe).shape[0])

        self._graph = self._build_graph()

    # ------------------------------------------------------------------
    def _build_graph(self) -> dict:
        if not self.docs:
            raise ValueError(
                "Please provide at least one data source, e.g. a table with "
                "a 'data' column")
        docs = self.docs[0]
        if len(self.docs) > 1:
            docs = docs.concat_reindex(*self.docs[1:])
        if "_metadata" not in docs.column_names():
            docs = docs.with_columns(_metadata=Json({}))

        if self.parser is None and self.splitter is None and \
                not self.doc_post_processors:
            # identity pipeline (pre-chunked text, the default config):
            # parse and split are 1:1 passthroughs, so the parse → flatten →
            # split → flatten → project chain collapses to one projection.
            # When the column is exactly str (an Optional[str] column keeps
            # the apply: str(None) == "None" is what the parser path
            # indexes) even the decode apply disappears.
            if docs.schema._dtypes().get("data") == dt.STR:
                text_expr = pw.this.data
            else:
                text_expr = pw.apply_with_type(
                    lambda data: data.decode("utf-8", "replace")
                    if isinstance(data, bytes) else str(data),
                    str, pw.this.data)
            chunks = docs.select(text=text_expr, metadata=pw.this._metadata)
            return self._finish_graph(docs, chunks)

        parser = _unwrap_udf(self.parser) if self.parser is not None \
            else lambda data: [(data.decode("utf-8", "replace")
                                if isinstance(data, bytes) else str(data), {})]

        @pw.udf
        def parse_doc(data, metadata) -> list[Json]:
            base = metadata.value if isinstance(metadata, Json) else \
                (metadata or {})
            out = []
            for text, meta in parser(data):
                m = dict(base)
                m.update(meta or {})
                out.append(Json({"text": text, "metadata": m}))
            return out

        parsed = docs.select(docs=parse_doc(pw.this.data, pw.this._metadata))
        parsed = parsed.flatten(pw.this.docs)

        post_procs = [_unwrap_udf(p) for p in self.doc_post_processors]

        @pw.udf
        def post_proc(doc: Json) -> Json:
            val = doc.value
            text, meta = val["text"], val["metadata"]
            for p in post_procs:
                text, meta = p(text, meta)
            return Json({"text": text, "metadata": meta})

        if post_procs:
            parsed = parsed.select(docs=post_proc(pw.this.docs))

        splitter = _unwrap_udf(self.splitter) if self.splitter is not None \
            else lambda text: [(text, {})]

        @pw.udf
        def split_doc(doc: Json) -> list[Json]:
            val = doc.value
            out = []
            for chunk, meta in splitter(val["text"]):
                m = dict(val["metadata"])
                m.update(meta or {})
                out.append(Json({"text": chunk, "metadata": m}))
            return out

        chunks = parsed.select(chunks=split_doc(pw.this.docs))
        chunks = chunks.flatten(pw.this.chunks)
        chunks = chunks.select(
            text=pw.apply_with_type(
                lambda j: str(j.value["text"]), str, pw.this.chunks),
            metadata=pw.apply_with_type(
                lambda j: Json(j.value["metadata"]), Json, pw.this.chunks),
        )
        return self._finish_graph(docs, chunks)

    def _finish_graph(self, docs, chunks) -> dict:
        if self.index_builder is not None:
            index = self.index_builder(chunks)
        elif self.index_factory is not None:
            index = DataIndex(
                chunks,
                self.index_factory.build_inner(
                    chunks.text, chunks.metadata,
                    embedder=self.embedder,
                    dimensions=self.embedding_dimension))
        else:
            index = default_usearch_knn_document_index(
                chunks.text, chunks, embedder=self.embedder,
                dimensions=self.embedding_dimension,
                metadata_column=chunks.metadata)

        stats = docs.reduce(
            count=pw.reducers.count(),
            last_modified=pw.reducers.max(pw.apply_with_type(
                lambda m: (m.value or {}).get("modified_at", 0)
                if isinstance(m, Json) else 0, int, pw.this._metadata)),
            paths=pw.reducers.tuple(pw.apply_with_type(
                lambda m: str((m.value or {}).get("path", ""))
                if isinstance(m, Json) else "", str, pw.this._metadata)),
        )
        return {"docs": docs, "chunks": chunks, "index": index,
                "stats": stats}

    @property
    def index(self) -> DataIndex:
        return self._graph["index"]

    # ------------------------------------------------------------------
    # query endpoints (reference vector_store.py:294-456)
    # ------------------------------------------------------------------
    class StatisticsQuerySchema(pw.Schema):
        pass

    class QueryResultSchema(pw.Schema):
        result: Any

    class FilterSchema(pw.Schema):
        metadata_filter: str | None
        filepath_globpattern: str | None

    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int
        metadata_filter: str | None
        filepath_globpattern: str | None

    class InputsQuerySchema(pw.Schema):
        metadata_filter: str | None
        filepath_globpattern: str | None

    def _stats_for(self, queries) -> "pw.Table":
        """The statistics row beside each query (all None before the
        first document), keyed by the query."""
        return self._graph["stats"].ix(ex.ConstExpression(_STATS_KEY),
                                       optional=True, context=queries)

    def statistics_query(self, info_queries) -> "pw.Table":
        stats = self._stats_for(info_queries)

        @pw.udf
        def format_stats(count, last_modified) -> Json:
            return Json({"file_count": count,
                         "last_modified": last_modified})

        return stats.select(
            result=format_stats(stats.count, stats.last_modified))

    def inputs_query(self, input_queries) -> "pw.Table":
        stats = self._stats_for(input_queries)

        @pw.udf
        def format_inputs(paths, metadata_filter, filepath_globpattern) -> Json:
            import fnmatch

            out = list(paths or ())
            if filepath_globpattern:
                out = [p for p in out
                       if fnmatch.fnmatch(p, str(filepath_globpattern))]
            return Json(out)

        return stats.select(
            result=format_inputs(stats.paths, input_queries.metadata_filter,
                                 input_queries.filepath_globpattern))

    @staticmethod
    def merge_filters(metadata_filter, filepath_globpattern) -> str | None:
        """Combine a JMESPath filter with a path glob (reference :342)."""
        parts = []
        if metadata_filter:
            parts.append(str(metadata_filter))
        if filepath_globpattern:
            parts.append(f"globmatch(`{filepath_globpattern}`, path)")
        return " && ".join(parts) if parts else None

    def retrieve_query(self, retrieval_queries) -> "pw.Table":
        q = retrieval_queries.with_columns(
            metadata_filter=pw.apply_with_type(
                VectorStoreServer.merge_filters, dt.ANY,
                pw.this.metadata_filter, pw.this.filepath_globpattern))
        res = self.index.query_as_of_now(
            q.query, number_of_matches=q.k, collapse_rows=True,
            metadata_filter=q.metadata_filter)

        @pw.udf
        def format_matches(texts, metadatas, scores) -> Json:
            out = []
            for t, m, s in zip(texts or (), metadatas or (), scores or ()):
                meta = m.value if isinstance(m, Json) else (m or {})
                out.append({"text": t, "metadata": meta,
                            "dist": float(s) if s is not None else None})
            return Json(out)

        return res.select(result=format_matches(
            res.text, res.metadata, res._pw_index_reply_score))

    # ------------------------------------------------------------------
    def run_server(self, host: str = "0.0.0.0", port: int = 8780, *,
                   threaded: bool = False, with_cache: bool = True,
                   cache_backend=None, **run_kwargs):
        """Expose /v1/retrieve, /v1/statistics, /v1/inputs and run
        (reference vector_store.py:461-566). ``with_cache`` memoizes the
        UDFs prepared from here on that did not pick a cache strategy
        (``DiskCache`` under PATHWAY_PERSISTENT_STORAGE or ./Cache, unless
        ``cache_backend`` is a strategy): in this graph the response
        formatters — an index that embeds its text itself calls no
        embedder UDF. ``threaded=True`` runs ``pw.run`` on a daemon thread
        and returns it; the run stops with
        ``engine.streaming.stop_all()``. The webserver is
        ``self.webserver`` (``port=0`` binds a free port, published in
        ``self.webserver.port`` once it serves)."""
        from pathway_tpu_torch.internals import udfs

        if with_cache:
            backend = cache_backend if isinstance(
                cache_backend, udfs.CacheStrategy) else udfs.DefaultCache()
            udfs.set_default_cache(backend)
        webserver = pw.io.http.PathwayWebserver(host=host, port=port)
        self.webserver = webserver

        def serve(route, schema, handler):
            queries, writer = pw.io.http.rest_connector(
                webserver=webserver, route=route, schema=schema,
                methods=("GET", "POST"), delete_completed_queries=True)
            writer(handler(queries))

        serve("/v1/retrieve", self.RetrieveQuerySchema, self.retrieve_query)
        serve("/v1/statistics", self.StatisticsQuerySchema,
              self.statistics_query)
        serve("/v1/inputs", self.InputsQuerySchema, self.inputs_query)

        def run():
            pw.run(**run_kwargs)

        if threaded:
            from pathway_tpu_torch.engine.threads import spawn

            return spawn(run, name="VectorStoreServer")
        run()

    def __repr__(self) -> str:
        return f"VectorStoreServer({self._graph['chunks']!r})"


class VectorStoreClient:
    """Blocking HTTP client for VectorStoreServer (reference :627)."""

    def __init__(self, host: str | None = None, port: int | None = None,
                 url: str | None = None, timeout: int = 15,
                 additional_headers: dict | None = None):
        if url is None:
            if host is None:
                raise ValueError("either url or host must be given")
            url = f"http://{host}:{port or 8780}"
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.additional_headers = additional_headers or {}

    def _post(self, route: str, payload: dict):
        import urllib.request

        req = urllib.request.Request(
            self.url + route, data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     **self.additional_headers})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return _json.loads(resp.read())

    def query(self, query: str, k: int = 3, metadata_filter: str | None = None,
              filepath_globpattern: str | None = None) -> list[dict]:
        return self._post("/v1/retrieve", {
            "query": query, "k": k, "metadata_filter": metadata_filter,
            "filepath_globpattern": filepath_globpattern})

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(self, metadata_filter: str | None = None,
                        filepath_globpattern: str | None = None):
        return self._post("/v1/inputs", {
            "metadata_filter": metadata_filter,
            "filepath_globpattern": filepath_globpattern})
