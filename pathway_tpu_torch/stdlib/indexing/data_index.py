"""DataIndex, the index-query API — port of
pathway_tpu/stdlib/indexing/data_index.py (reference:
stdlib/indexing/data_index.py:142,214).

An InnerIndex wraps an engine external index (the device brute-force KNN);
DataIndex.query_as_of_now answers a query stream against the live index
and repacks the matches into data columns (tuples when collapse_rows=True):
the external index operator's reply is flattened, each match looked up in
the data table with ``ix``, and the matches of a query gathered again by
``groupby(id=query id)`` with ``sorted_tuple`` by rank.
"""

from __future__ import annotations

from abc import ABC
from dataclasses import dataclass

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.table import Table


class InnerIndex(ABC):
    """Specifies which columns are indexed and how (reference :142)."""

    def __init__(self, data_column: ex.ColumnReference,
                 metadata_column: ex.ColumnExpression | None = None):
        self.data_column = data_column
        self.metadata_column = metadata_column

    def factory(self):
        raise NotImplementedError

    @property
    def query_embedder(self):
        return None

    @property
    def embeds_internally(self) -> bool:
        """True when the engine-side index takes raw text and embeds it on
        the device itself (ops/knn.py DeviceEmbeddingKnnIndex): the planner
        then feeds text straight through instead of building UDF embedding
        columns for data and queries."""
        return False


@dataclass
class _PreparedQueryCols:
    vec: ex.ColumnExpression
    limit: ex.ColumnExpression | None
    filter: ex.ColumnExpression | None


class DataIndex:
    def __init__(self, data_table: Table, inner_index: InnerIndex,
                 embedder=None):
        self.data_table = data_table
        self.inner_index = inner_index
        # optional query embedder OVERRIDE (reference: DataIndex(...,
        # embedder=...) — applied to the query column; vector indexes
        # usually carry their own via inner.query_embedder instead)
        self.embedder = embedder
        self._data_prepared: Table | None = None

    def _embeds_internally(self) -> bool:
        """The engine index embeds text on-device itself — unless a
        DataIndex-level query-embedder override is present, which the
        internal path could not honor (it would silently embed queries
        with the DOCUMENT embedder); the override forces the classic
        UDF-column path for both sides."""
        return self.inner_index.embeds_internally and self.embedder is None

    def _prepare_data(self) -> Table:
        """Embed + project the corpus ONCE per DataIndex: every query stream
        reuses the same plan node, so the encoder forward over the corpus
        runs once even when several endpoints query the same index."""
        if self._data_prepared is None:
            inner = self.inner_index
            data_vec = inner.data_column
            if inner.query_embedder is not None and \
                    not self._embeds_internally():
                # "embedder inside index" (reference vector_store.py:214-292):
                # both the indexed column and the query column are embedded
                data_vec = inner.query_embedder(data_vec)
            self._data_prepared = self.data_table.select(
                _pw_vec=data_vec,
                _pw_meta=inner.metadata_column
                if inner.metadata_column is not None else None,
            )
        return self._data_prepared

    # ------------------------------------------------------------------
    def query_as_of_now(self, query_column: ex.ColumnExpression, *,
                        number_of_matches: ex.ColumnExpression | int = 3,
                        collapse_rows: bool = True,
                        metadata_filter: ex.ColumnExpression | None = None,
                        globbing_metadata_filter=None) -> Table:
        return self._query(query_column, number_of_matches, collapse_rows,
                           metadata_filter, as_of_now=True)

    def query(self, query_column: ex.ColumnExpression, *,
              number_of_matches: ex.ColumnExpression | int = 3,
              collapse_rows: bool = True,
              metadata_filter: ex.ColumnExpression | None = None) -> Table:
        # Full semantics: standing queries are re-answered whenever the
        # indexed data changes (engine/index_ops.py revise=True path).
        return self._query(query_column, number_of_matches, collapse_rows,
                           metadata_filter, as_of_now=False)

    # ------------------------------------------------------------------
    def _query(self, query_column, number_of_matches, collapse_rows,
               metadata_filter, as_of_now: bool) -> Table:
        query_table: Table = query_column.table
        data = self.data_table
        inner = self.inner_index

        embedder = self.embedder or inner.query_embedder
        data_prepared = self._prepare_data()

        qvec = query_column
        if embedder is not None and not self._embeds_internally():
            qvec = embedder(query_column)
        query_prepared = query_table.select(
            _pw_q=qvec,
            _pw_k=number_of_matches,
            _pw_filter=metadata_filter,
        )

        factory = inner.factory()
        if inner.embeds_internally and not self._embeds_internally():
            # query-embedder override in play: the engine must take
            # vectors, not text (see _embeds_internally)
            factory.fuse = False
        reply = data_prepared._external_index_as_of_now(
            query_prepared,
            index_factory=factory,
            query_responses_limit_column=query_prepared._pw_k,
            query_filter_column=query_prepared._pw_filter,
            index_filter_data_column=data_prepared._pw_meta,
            revise=not as_of_now,
        )

        # reply: key=query key, column _pw_index_reply = ((match_key, score),...)
        def with_rank(r):
            return tuple((k, s, i) for i, (k, s) in enumerate(r))

        ranked = reply.select(
            _pw_matches=ex.ApplyExpression(with_rank, None,
                                           reply._pw_index_reply))
        flat = ranked.flatten(ranked._pw_matches, origin_id="_pw_query_id")
        flat = flat.select(
            _pw_query_id=flat._pw_query_id,
            _pw_match_id=flat._pw_matches[0],
            _pw_score=flat._pw_matches[1],
            _pw_rank=flat._pw_matches[2],
        )
        matched = data.ix(flat._pw_match_id, context=flat)

        data_cols = {
            name: matched[name] for name in data.column_names()
        }
        if not collapse_rows:
            out = flat.select(
                query_id=flat._pw_query_id,
                _pw_index_reply_score=flat._pw_score,
                _pw_index_reply_id=flat._pw_match_id,
                **data_cols,
            )
            return out

        # collapse into per-query tuples ordered by rank
        import pathway_tpu_torch.internals.reducers_frontend as reducers

        per_match = flat.select(
            flat._pw_query_id, flat._pw_rank, flat._pw_score,
            flat._pw_match_id, **data_cols)
        agg = {
            "_pw_index_reply_score": reducers.sorted_tuple(
                ex.MakeTupleExpression(per_match._pw_rank, per_match._pw_score)),
            "_pw_index_reply_id": reducers.sorted_tuple(
                ex.MakeTupleExpression(per_match._pw_rank, per_match._pw_match_id)),
        }
        for name in data.column_names():
            agg[name] = reducers.sorted_tuple(
                ex.MakeTupleExpression(per_match._pw_rank, per_match[name]))
        grouped = per_match.groupby(id=per_match._pw_query_id).reduce(**agg)

        def strip(t):
            return tuple(v for _, v in t)

        final_cols = {}
        for name in list(agg.keys()):
            final_cols[name] = ex.ApplyExpression(strip, None, grouped[name])
        result = grouped.select(**final_cols)
        # queries with zero matches: give empty tuples (left outer against queries)
        padded = query_table.select(
            **{name: () for name in final_cols}
        ).update_cells(result.promise_universe_is_subset_of(query_table))
        return padded
