"""REST servers wiring QA handlers to routes — port of
pathway_tpu/xpacks/llm/servers.py (reference: xpacks/llm/servers.py —
BaseRestServer.serve:22, QARestServer:81, QASummaryRestServer:134).

Each route → (schema, handler): io/http's ``rest_connector`` turns
requests into a query table, the handler builds the result table, and
the response writer resolves the awaiting HTTP request. Every request
gets an id at the webserver's ingress, echoed in the
``X-Pathway-Request-Id`` response header. ``port=0`` binds a free port,
published in ``webserver.port`` once it serves.
"""

from __future__ import annotations

import pathway_tpu_torch as pw


class BaseRestServer:
    def __init__(self, host: str, port: int, **rest_kwargs):
        self.host = host
        self.port = port
        self.webserver = pw.io.http.PathwayWebserver(host=host, port=port)
        self.rest_kwargs = rest_kwargs

    def serve(self, route: str, schema: type[pw.Schema], handler,
              **additional_kwargs) -> None:
        queries, writer = pw.io.http.rest_connector(
            webserver=self.webserver, route=route, schema=schema,
            methods=("GET", "POST"), delete_completed_queries=True,
            **additional_kwargs)
        writer(handler(queries))

    def run(self, *, threaded: bool = False, with_cache: bool = True,
            cache_backend=None, terminate_on_error: bool = True, **kwargs):
        """Start the pipeline (blocking, or on a daemon thread).

        with_cache=True memoizes LLM/embedder UDF calls that did not pick
        their own cache_strategy: ``cache_backend`` may be a
        udfs.CacheStrategy (DiskCache persists across restarts, the
        default, matching the reference's UdfCaching persistence mode)."""
        from pathway_tpu_torch.internals import udfs

        if with_cache:
            backend = cache_backend if isinstance(
                cache_backend, udfs.CacheStrategy) else udfs.DefaultCache()
            udfs.set_default_cache(backend)

        def run():
            pw.run(terminate_on_error=terminate_on_error, **kwargs)

        if threaded:
            from pathway_tpu_torch.engine.threads import spawn

            return spawn(run, name=type(self).__name__)
        run()


class QARestServer(BaseRestServer):
    """Routes for answer/retrieve/statistics/list_documents
    (reference servers.py:81)."""

    def __init__(self, host: str, port: int, rag_question_answerer,
                 **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.serve("/v1/pw_ai_answer",
                   rag_question_answerer.AnswerQuerySchema,
                   rag_question_answerer.answer_query)
        self.serve("/v1/retrieve",
                   rag_question_answerer.RetrieveQuerySchema,
                   rag_question_answerer.retrieve)
        self.serve("/v1/statistics",
                   rag_question_answerer.StatisticsQuerySchema,
                   rag_question_answerer.statistics)
        self.serve("/v1/pw_list_documents",
                   rag_question_answerer.indexer.InputsQuerySchema,
                   rag_question_answerer.indexer.inputs_query)


class QASummaryRestServer(QARestServer):
    """QARestServer + summarization route (reference servers.py:134)."""

    def __init__(self, host: str, port: int, rag_question_answerer,
                 **rest_kwargs):
        super().__init__(host, port, rag_question_answerer, **rest_kwargs)
        self.serve("/v1/pw_ai_summary",
                   rag_question_answerer.SummarizeQuerySchema,
                   rag_question_answerer.summarize_query)
