"""RAG question answering, standard and adaptive strategies — port of
pathway_tpu/xpacks/llm/question_answering.py (reference:
xpacks/llm/question_answering.py — BaseRAGQuestionAnswerer:280,
AdaptiveRAGQuestionAnswerer:478, geometric escalation
answer_with_geometric_rag_strategy(_from_index):88,153, RAGClient:645).

The adaptive strategy is the cost-saving loop: ask with n docs; if the
model answers the "No information found" sentinel, re-ask with n*factor
docs (prompts.prompt_qa_geometric_rag makes the sentinel reliable). The
index is the ``VectorStoreServer``'s: over ``EncoderEmbedder`` and a bf16
``default_brute_force_knn_document_index`` a question is embedded on the
card (K1) and searched by K2. ``DeckRetriever`` waits for the slides
server and raises ``NotImplementedError`` naming its ROADMAP step.
"""

from __future__ import annotations

import json as _json
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.xpacks.llm import llms, prompts
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer


async def answer_with_geometric_rag_strategy(
        questions: list[str], documents: list[list[str]],
        llm_chat_model: llms.BaseChat, n_starting_documents: int,
        factor: int, max_iterations: int,
        strict_prompt: bool = False) -> list[str]:
    """Per-question geometric escalation over already-retrieved docs
    (reference question_answering.py:88)."""
    chat = llm_chat_model.prepared_async() \
        if isinstance(llm_chat_model, udfs.UDF) \
        else udfs.coerce_async(llm_chat_model)
    answers: list[str] = []
    for question, docs in zip(questions, documents):
        n = n_starting_documents
        answer = prompts.NO_INFO_ANSWER
        for _ in range(max_iterations):
            context = docs[:n]
            prompt = prompts.prompt_qa_geometric_rag(
                context, question, strict_prompt=strict_prompt)
            result = await chat([{"role": "user", "content": prompt}])
            if result and prompts.NO_INFO_ANSWER.lower() not in \
                    str(result).lower():
                answer = str(result)
                break
            if n >= len(docs):
                break
            n *= factor
        answers.append(answer)
    return answers


def answer_with_geometric_rag_strategy_from_index(
        questions, index, documents_column,
        llm_chat_model: llms.BaseChat, n_starting_documents: int,
        factor: int, max_iterations: int,
        metadata_filter=None, strict_prompt: bool = False):
    """Retrieval + escalation in one expression (reference :153).

    ``questions`` is a column of question strings; the index is queried
    ONCE for the maximum document count the escalation could need
    (n_starting_documents * factor^(max_iterations-1)), and the geometric
    loop then runs locally over that retrieved list — each extra iteration
    costs an LLM call but no retrieval. Returns an answer column; a
    question with no answer yields None."""
    from pathway_tpu_torch.internals import expression as ex

    max_documents = n_starting_documents * factor ** (max_iterations - 1)
    if isinstance(documents_column, ex.ColumnReference):
        documents_column_name = documents_column.name
    else:
        documents_column_name = documents_column

    retrieved = index.query_as_of_now(
        questions, number_of_matches=max_documents, collapse_rows=True,
        metadata_filter=metadata_filter)
    docs = retrieved.select(
        _pw_documents=pw.coalesce(pw.this[documents_column_name], ()))

    @pw.udf
    async def escalate(question, documents) -> str | None:
        doc_list = [str(d) for d in (documents or ())]
        answers = await answer_with_geometric_rag_strategy(
            [str(question)], [doc_list], llm_chat_model,
            n_starting_documents, factor, max_iterations,
            strict_prompt=strict_prompt)
        answer = answers[0]
        return None if answer == prompts.NO_INFO_ANSWER else answer

    question_view = questions.table.ix(pw.this.id, context=docs)
    result = docs.select(
        answer=escalate(getattr(question_view, questions.name),
                        pw.this._pw_documents))
    return result.answer


class BaseRAGQuestionAnswerer:
    """Standard RAG: retrieve k docs, build prompt, one LLM call; REST
    endpoints answer/retrieve/statistics/summarize
    (reference question_answering.py:280)."""

    def __init__(self, llm: llms.BaseChat, indexer: VectorStoreServer, *,
                 default_llm_name: str | None = None,
                 short_prompt_template=prompts.prompt_short_qa,
                 long_prompt_template=prompts.prompt_qa,
                 summarize_template=prompts.prompt_summarize,
                 search_topk: int = 6):
        self.llm = llm
        self.indexer = indexer
        self.default_llm_name = default_llm_name
        self.short_prompt_template = short_prompt_template
        self.long_prompt_template = long_prompt_template
        self.summarize_template = summarize_template
        self.search_topk = search_topk
        self.server = None
        self._pending_endpoints: list[tuple] = []

    # -- schemas (reference :300-340 — optional fields carry defaults so
    # a minimal POST body works, e.g. just {"prompt": ...}) --------------
    class AnswerQuerySchema(pw.Schema):
        prompt: str
        filters: str | None = pw.column_definition(default_value=None)
        model: str | None = pw.column_definition(default_value=None)
        response_type: str = pw.column_definition(default_value="short")

    class SummarizeQuerySchema(pw.Schema):
        text_list: Any
        model: str | None = pw.column_definition(default_value=None)

    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int = pw.column_definition(default_value=3)
        metadata_filter: str | None = pw.column_definition(
            default_value=None)
        filepath_globpattern: str | None = pw.column_definition(
            default_value=None)

    class StatisticsQuerySchema(pw.Schema):
        pass

    # -- endpoint logic ------------------------------------------------
    def answer_query(self, queries: "pw.Table") -> "pw.Table":
        retrieved = self.indexer.index.query_as_of_now(
            queries.prompt, number_of_matches=self.search_topk,
            collapse_rows=True, metadata_filter=queries.filters)
        short_t, long_t = self.short_prompt_template, self.long_prompt_template

        @pw.udf
        def build_prompt(texts, prompt, response_type) -> str:
            docs = list(texts or ())
            if response_type == "short":
                return short_t(docs, prompt)
            return long_t(docs, prompt)

        with_prompt = retrieved.select(
            rag_prompt=build_prompt(pw.this.text, queries.ix(
                pw.this.id, context=retrieved).prompt, queries.ix(
                pw.this.id, context=retrieved).response_type))
        return with_prompt.select(
            result=self.llm(llms.prompt_chat_single_qa(pw.this.rag_prompt)))

    def summarize_query(self, summarize_queries: "pw.Table") -> "pw.Table":
        template = self.summarize_template

        @pw.udf
        def build(text_list) -> str:
            items = text_list.value if isinstance(text_list, Json) \
                else text_list
            return template([str(t) for t in (items or [])])

        q = summarize_queries.select(prompt=build(pw.this.text_list))
        return q.select(
            result=self.llm(llms.prompt_chat_single_qa(pw.this.prompt)))

    def retrieve(self, queries: "pw.Table") -> "pw.Table":
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries: "pw.Table") -> "pw.Table":
        return self.indexer.statistics_query(queries)

    # -- serving (reference :462-476) ----------------------------------
    def build_server(self, host: str, port: int, **rest_kwargs) -> None:
        from pathway_tpu_torch.xpacks.llm.servers import QASummaryRestServer

        self.server = QASummaryRestServer(host, port, self, **rest_kwargs)

    def run_server(self, host: str = "0.0.0.0", port: int = 8000, *,
                   threaded: bool = False, with_cache: bool = True,
                   **kwargs):
        if self.server is None:
            self.build_server(host, port)
        return self.server.run(threaded=threaded, with_cache=with_cache,
                               **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Geometric doc-count escalation (reference :478): start with
    n_starting_documents, multiply by factor on the no-info sentinel."""

    def __init__(self, llm: llms.BaseChat, indexer: VectorStoreServer, *,
                 n_starting_documents: int = 2, factor: int = 2,
                 max_iterations: int = 4, strict_prompt: bool = False,
                 **kwargs):
        max_docs = n_starting_documents * factor ** (max_iterations - 1)
        kwargs.setdefault("search_topk", max_docs)
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, queries: "pw.Table") -> "pw.Table":
        retrieved = self.indexer.index.query_as_of_now(
            queries.prompt, number_of_matches=self.search_topk,
            collapse_rows=True, metadata_filter=queries.filters)
        llm_model = self.llm
        n0, factor, max_iter = (self.n_starting_documents, self.factor,
                                self.max_iterations)
        strict = self.strict_prompt

        @pw.udf
        async def adaptive_answer(texts, prompt) -> str:
            docs = [str(t) for t in (texts or ())]
            answers = await answer_with_geometric_rag_strategy(
                [str(prompt)], [docs], llm_model, n0, factor, max_iter,
                strict_prompt=strict)
            return answers[0]

        return retrieved.select(
            result=adaptive_answer(pw.this.text, queries.ix(
                pw.this.id, context=retrieved).prompt))


class DeckRetriever(BaseRAGQuestionAnswerer):
    """Slide-deck retrieval server (reference :598). Not ported: it serves
    the slides server's index."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DeckRetriever is not ported to pathway_tpu_torch yet "
            "(ROADMAP queue 1, step 10 (item 8): the slides server and "
            "DeckRetriever)")


class RAGClient:
    """HTTP client for the QA REST servers (reference :645)."""

    def __init__(self, host: str | None = None, port: int | None = None,
                 url: str | None = None, timeout: int = 90,
                 additional_headers: dict | None = None):
        if url is None:
            if host is None:
                raise ValueError("either url or host must be given")
            url = f"http://{host}:{port or 8000}"
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
            body = resp.read()
            # a route whose result is a string replies with text/plain
            # (io/http); the JAX package's client json-decodes it and
            # raises (ROADMAP queue 3, item 12)
            if resp.headers.get_content_type() == "application/json":
                return _json.loads(body)
            return body.decode("utf-8")

    def answer(self, prompt: str, filters: str | None = None,
               model: str | None = None, response_type: str = "long"):
        return self._post("/v1/pw_ai_answer", {
            "prompt": prompt, "filters": filters, "model": model,
            "response_type": response_type})

    pw_ai_answer = answer

    def summarize(self, text_list: list[str], model: str | None = None):
        return self._post("/v1/pw_ai_summary", {
            "text_list": text_list, "model": model})

    pw_ai_summary = summarize

    def retrieve(self, query: str, k: int = 6,
                 metadata_filter: str | None = None,
                 filepath_globpattern: str | None = None):
        return self._post("/v1/retrieve", {
            "query": query, "k": k, "metadata_filter": metadata_filter,
            "filepath_globpattern": filepath_globpattern})

    def statistics(self):
        return self._post("/v1/statistics", {})

    def list_documents(self, metadata_filter: str | None = None,
                       filepath_globpattern: str | None = None):
        return self._post("/v1/pw_list_documents", {
            "metadata_filter": metadata_filter,
            "filepath_globpattern": filepath_globpattern})
