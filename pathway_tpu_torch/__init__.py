"""pathway_tpu_torch — the PyTorch/CUDA port of pathway_tpu for one NVIDIA
H100: the live-RAG device path (tokenize -> encoder -> paged KNN ingest ->
query embed -> top-k) and, above it, the engine's batch path (Table DSL,
expression compiler, GraphRunner), where ``EncoderEmbedder`` is a batch
device UDF::

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.debug import table_from_rows
    from pathway_tpu_torch.internals.runner import GraphRunner

    docs = table_from_rows(pw.schema_from_types(data=str), rows,
                           is_stream=True)
    out = docs.select(embedding=emb(pw.this.data))
    runner = GraphRunner(); cap = runner.capture(out); runner.run_batch()

and the index path: groupby/reduce, joins (``join*``, ``pw.join*``),
``restrict`` / ``intersect`` / ``difference`` / ``having``, ``ix``,
``update_cells``, the as-of-now
external index operator, ``DataIndex.query_as_of_now``
(pathway_tpu_torch.stdlib.indexing) and ``VectorStoreServer``
(pathway_tpu_torch.xpacks.llm.vector_store), whose ``retrieve_query`` runs
the KNN kernels under the same ``run_batch``. The served path:
``pw.run()`` runs a graph with streaming sources (``pw.io.python.read``,
``pw.io.http.rest_connector``) under the streaming runtime
(engine/streaming.py), and ``VectorStoreServer.run_server`` serves
``/v1/retrieve``, ``/v1/statistics`` and ``/v1/inputs`` over HTTP.
The temporal layer: ``pw.temporal`` (alias ``pw.window``: windows,
behaviors, as-of-now / as-of / interval / window joins), ``Table.sort``,
``pw.stdlib.ordered.diff`` and ``pw.stdlib.statistical.interpolate``.
Files come in through ``pw.io.fs`` (and ``pw.io.csv``,
``pw.io.plaintext``, ``pw.io.jsonlines``), static or streaming; the
classic ``pw.stdlib.ml.KNNIndex`` and the Adaptive-RAG template
(``xpacks.llm.question_answering.AdaptiveRAGQuestionAnswerer`` with its
splitter, chats, rerankers and REST server) run BASELINE.md's configs 1
and 3. The rest of ``pw.ml`` runs too: the kNN and LSH classifiers,
``clustering_via_lsh`` with its k-means on the card, HMM decoding and
the fuzzy joins.
``pw.warmup(embedder, index=...)`` walks the serving shapes before the
first tick and, under ``PATHWAY_DEVICE_SANITIZER``, declares the steady
state that engine/device_sanitizer.py guards.

Module paths and public names mirror ``pathway_tpu`` so each port module
sits where its JAX counterpart does. The port imports torch and numpy,
never jax and nothing of ``pathway_tpu``: what it needs from there is
copied into this package. Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; see :func:`pathway_tpu_torch._device.resolve_device`.

The top-level names below load on first use, so importing a kernel module
does not import the engine.
"""

from __future__ import annotations

import importlib

# public name -> (module, attribute); attribute None = the module itself
_LAZY = {
    "Table": ("pathway_tpu_torch.internals.table", "Table"),
    "Schema": ("pathway_tpu_torch.internals.schema", "Schema"),
    "ColumnDefinition": ("pathway_tpu_torch.internals.schema",
                         "ColumnDefinition"),
    "column_definition": ("pathway_tpu_torch.internals.schema",
                          "column_definition"),
    "schema_builder": ("pathway_tpu_torch.internals.schema",
                       "schema_builder"),
    "schema_from_dict": ("pathway_tpu_torch.internals.schema",
                         "schema_from_dict"),
    "schema_from_types": ("pathway_tpu_torch.internals.schema",
                          "schema_from_types"),
    "JoinMode": ("pathway_tpu_torch.internals.joins", "JoinMode"),
    "JoinResult": ("pathway_tpu_torch.internals.joins", "JoinResult"),
    **{name: ("pathway_tpu_torch.internals.compat", name) for name in (
        "join", "join_inner", "join_left", "join_right", "join_outer")},
    "this": ("pathway_tpu_torch.internals.thisclass", "this"),
    "left": ("pathway_tpu_torch.internals.thisclass", "left"),
    "right": ("pathway_tpu_torch.internals.thisclass", "right"),
    "udf": ("pathway_tpu_torch.internals.udfs", "udf"),
    "UDF": ("pathway_tpu_torch.internals.udfs", "UDF"),
    "udfs": ("pathway_tpu_torch.internals.udfs", None),
    "reducers": ("pathway_tpu_torch.internals.reducers_frontend", None),
    "BaseCustomAccumulator": ("pathway_tpu_torch.internals.reducers_frontend",
                              "BaseCustomAccumulator"),
    "Json": ("pathway_tpu_torch.internals.json", "Json"),
    "Pointer": ("pathway_tpu_torch.internals.keys", "Pointer"),
    "DType": ("pathway_tpu_torch.internals.dtype", "DType"),
    "global_error_log": ("pathway_tpu_torch.internals.error",
                         "global_error_log"),
    "debug": ("pathway_tpu_torch.debug", None),
    "stdlib": ("pathway_tpu_torch.stdlib", None),
    "ml": ("pathway_tpu_torch.stdlib.ml", None),
    "temporal": ("pathway_tpu_torch.stdlib.temporal", None),
    "window": ("pathway_tpu_torch.stdlib.temporal", None),
    "io": ("pathway_tpu_torch.io", None),
    "run": ("pathway_tpu_torch.internals.run", "run"),
    "warmup": ("pathway_tpu_torch.warmup", "warmup"),
    "enable_compilation_cache": ("pathway_tpu_torch.warmup",
                                 "enable_compilation_cache"),
    "MonitoringLevel": ("pathway_tpu_torch.internals.monitoring",
                        "MonitoringLevel"),
    **{name: ("pathway_tpu_torch.internals.expression", name) for name in (
        "ColumnExpression", "ColumnReference", "apply", "apply_async",
        "apply_with_type", "cast", "coalesce", "declare_type", "fill_error",
        "if_else", "make_tuple", "require", "unwrap")},
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    spec = _LAZY.get(name)
    if spec is None:
        raise AttributeError(
            f"module 'pathway_tpu_torch' has no attribute {name!r}")
    module = importlib.import_module(spec[0])
    value = module if spec[1] is None else getattr(module, spec[1])
    globals()[name] = value
    return value
