"""The port's RAG question answering (xpacks/llm/question_answering.py and
servers.py) against the JAX package's: the same documents, questions and
offline chat (``FakeChat``, in the manner of tests/test_llm_xpack.py:37)
and a deterministic bag-of-words embedder, in each package.

- ``answer_with_geometric_rag_strategy`` and its ``_from_index`` form
  (under run_batch): the same answers and the same chat calls (documents
  in each prompt).
- ``BaseRAGQuestionAnswerer`` and ``AdaptiveRAGQuestionAnswerer``:
  ``answer_query`` (short and long prompts), ``summarize_query``,
  ``retrieve`` and ``statistics`` under run_batch, equal exactly, with
  the chat's calls.
- ``QASummaryRestServer`` with ``RAGClient`` over a real socket (port 0,
  every wait 30 s at most): each route's raw reply equal to the JAX
  package's. A string answer comes back as text/plain in both packages;
  the JAX package's client json-decodes it and raises, the port's
  returns the text (ROADMAP queue 3, item 12).

The embedder hashes words with md5, so both packages' indexes (the
brute-force document index, float32, cosine; the port's on the CPU) hold
the same vectors and every score is exact up to f32 sums. The JAX side runs
with ``PATHWAY_AUTO_JIT=0``, ``PATHWAY_DEVICE_INFLIGHT=1`` and
``PATHWAY_RESULT_CACHE=0``."""

import asyncio
import hashlib
import json
import time
import types
import urllib.request

import numpy as np
import pytest

DEADLINE_S = 30.0
SIDES = ("jax", "torch")
DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "systolic arrays multiply matrices fast",
    "ring attention rotates blocks around the interconnect",
    "the fox den lies under the old oak",
    "matrices of floats fill the accelerator memory",
    "a lazy afternoon by the river bank",
]


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")


def _side(side: str):
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
        from pathway_tpu.internals.parse_graph import G
        from pathway_tpu.internals.runner import GraphRunner
        from pathway_tpu.xpacks.llm import llms, prompts, question_answering
        from pathway_tpu.xpacks.llm.vector_store import VectorStoreServer
        from pathway_tpu.stdlib.indexing import \
            default_brute_force_knn_document_index as default_index
        kw = {}
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.internals.runner import GraphRunner
        from pathway_tpu_torch.xpacks.llm import (llms, prompts,
                                                  question_answering)
        from pathway_tpu_torch.xpacks.llm.vector_store import \
            VectorStoreServer
        from pathway_tpu_torch.stdlib.indexing import \
            default_brute_force_knn_document_index as default_index
        kw = {"device": "cpu"}
    return types.SimpleNamespace(pw=pw, streaming=streaming, G=G,
                                 GraphRunner=GraphRunner, llms=llms,
                                 prompts=prompts, qa=question_answering,
                                 VectorStoreServer=VectorStoreServer,
                                 default_index=default_index, kw=kw)


def _embedder(m):
    @m.pw.udf
    def bow(text: str) -> np.ndarray:
        vec = np.zeros(16)
        for w in str(text).lower().split():
            vec[int(hashlib.md5(w.encode()).hexdigest(), 16) % 16] += 1.0
        n = np.linalg.norm(vec)
        return vec / n if n else vec

    return bow


def _fake_chat(m, min_docs: int = 1):
    class FakeChat(m.llms.BaseChat):
        """Answers with the number of documents in the prompt once there
        are ``min_docs``, else the no-information answer."""

        def __init__(self):
            super().__init__()
            self.calls = []

        async def __wrapped__(self, messages, **kwargs):
            prompt = self._as_messages(messages)[-1]["content"]
            n_docs = prompt.count("[doc ")
            self.calls.append(n_docs)
            if "Summarize" in prompt:
                return f"summary of {prompt.count(chr(10))} lines"
            if n_docs >= min_docs:
                return f"answer from {n_docs} docs"
            return m.prompts.NO_INFO_ANSWER

    return FakeChat()


def _store(m):
    rows = [(d, m.pw.Json({"path": f"/d{i}.txt", "modified_at": 100 + i}))
            for i, d in enumerate(DOCS)]
    docs = m.pw.debug.table_from_rows(
        m.pw.schema_from_types(data=str, _metadata=m.pw.Json), rows)
    emb = _embedder(m)
    return m.VectorStoreServer(
        docs, embedder=emb, index_builder=lambda chunks: m.default_index(
            chunks.text, chunks, embedder=emb, dimensions=16, **m.kw))


def _run_batch(m, table):
    runner = m.GraphRunner()
    cap = runner.capture(table)
    runner.run_batch(n_workers=1)
    return sorted((int(k), _plain(row), t, d) for k, row, t, d in cap.events)


def _plain(v):
    if type(v).__name__ == "Json":
        return ("json", _plain(v.value))
    if isinstance(v, dict):
        return tuple(sorted((k, _plain(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, float):
        return round(v, 5)
    return v


# ---------------------------------------------------------------------------
# the geometric strategy
# ---------------------------------------------------------------------------

GEOMETRIC = [(1, 1, 2, 5), (4, 1, 2, 5), (100, 1, 2, 3), (3, 2, 3, 3),
             (2, 2, 2, 1)]


@pytest.mark.parametrize("min_docs,n0,factor,iters", GEOMETRIC)
def test_geometric_strategy_equals_reference(min_docs, n0, factor, iters):
    questions = ["q1", "q2 longer", "q3"]
    documents = [[f"doc{i}" for i in range(8)], ["only"], []]
    got = {}
    for side in SIDES:
        m = _side(side)
        chat = _fake_chat(m, min_docs)
        answers = asyncio.run(m.qa.answer_with_geometric_rag_strategy(
            questions, documents, chat, n_starting_documents=n0,
            factor=factor, max_iterations=iters))
        # a plain coroutine function as the chat: coerce_async
        plain = asyncio.run(m.qa.answer_with_geometric_rag_strategy(
            questions[:1], documents[:1], lambda msgs: "yes", n0, factor,
            iters, strict_prompt=True))
        got[side] = (answers, chat.calls, plain)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("min_docs", [1, 3, 100])
def test_geometric_strategy_from_index_equals_reference(min_docs):
    questions = ["quick fox", "matrices", "nothing relevant here"]
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()
        store = _store(m)
        chat = _fake_chat(m, min_docs)
        qs = m.pw.debug.table_from_rows(m.pw.schema_from_types(q=str),
                                        [(q,) for q in questions])
        answer = m.qa.answer_with_geometric_rag_strategy_from_index(
            qs.q, store.index, "text", chat, n_starting_documents=1,
            factor=2, max_iterations=3)
        got[side] = (_run_batch(m, answer.table.select(a=answer)),
                     sorted(chat.calls))
        m.G.clear()
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == len(questions)


# ---------------------------------------------------------------------------
# the answerers under run_batch
# ---------------------------------------------------------------------------

def _answerer(m, kind: str, chat):
    store = _store(m)
    if kind == "base":
        return m.qa.BaseRAGQuestionAnswerer(chat, store, search_topk=2)
    return m.qa.AdaptiveRAGQuestionAnswerer(
        chat, store, n_starting_documents=1, factor=2, max_iterations=3)


ENDPOINTS = ["answer_short", "answer_long", "summarize", "retrieve",
             "statistics"]


@pytest.mark.parametrize("endpoint", ENDPOINTS)
@pytest.mark.parametrize("kind,min_docs", [("base", 1), ("adaptive", 2),
                                           ("adaptive", 4),
                                           ("adaptive", 100)])
def test_answerer_endpoints_equal_reference(kind, min_docs, endpoint):
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()
        chat = _fake_chat(m, min_docs)
        rag = _answerer(m, kind, chat)
        pw = m.pw
        if endpoint.startswith("answer"):
            rtype = endpoint.split("_")[1]
            qs = pw.debug.table_from_rows(
                pw.schema_from_types(prompt=str, filters=str | None,
                                     model=str | None, response_type=str),
                [("quick brown fox", None, None, rtype),
                 ("systolic matrices", None, None, rtype)])
            out = rag.answer_query(qs)
        elif endpoint == "summarize":
            qs = pw.debug.table_from_rows(
                pw.schema_from_types(text_list=pw.Json, model=str | None),
                [(pw.Json(["a", "b", "c"]), None), (pw.Json(DOCS), None)])
            out = rag.summarize_query(qs)
        elif endpoint == "retrieve":
            qs = pw.debug.table_from_rows(
                pw.schema_from_types(query=str, k=int,
                                     metadata_filter=str | None,
                                     filepath_globpattern=str | None),
                [("lazy fox", 2, None, None), ("matrices", 3, None, None)])
            out = rag.retrieve(qs)
        else:
            qs = pw.debug.table_from_rows(pw.schema_from_types(x=int),
                                          [(1,)])
            out = rag.statistics(qs.select())
        got[side] = (_run_batch(m, out), sorted(chat.calls))
        m.G.clear()
    assert got["torch"] == got["jax"]
    assert got["torch"][0]


# ---------------------------------------------------------------------------
# the REST server over a socket
# ---------------------------------------------------------------------------

def _post(port: int, route: str, payload: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as resp:
        return resp.status, resp.headers.get_content_type(), resp.read()


ROUTES = [
    ("/v1/pw_ai_answer", {"prompt": "quick brown fox"}),
    ("/v1/pw_ai_answer", {"prompt": "rotates blocks", "response_type":
                          "long"}),
    ("/v1/retrieve", {"query": "lazy dog", "k": 2, "metadata_filter": None,
                      "filepath_globpattern": None}),
    ("/v1/statistics", {}),
    ("/v1/pw_list_documents", {"metadata_filter": None,
                               "filepath_globpattern": None}),
    ("/v1/pw_ai_summary", {"text_list": ["one", "two"]}),
]


def _serve(side: str):
    """The adaptive answerer behind ``run_server(threaded=True)`` on a
    free port: every route's raw reply, then the client's."""
    m = _side(side)
    m.G.clear()
    chat = _fake_chat(m, 2)
    rag = _answerer(m, "adaptive", chat)
    rag.build_server("127.0.0.1", 0)
    th = rag.run_server(threaded=True, with_cache=False)
    ws = rag.server.webserver
    try:
        deadline = time.monotonic() + DEADLINE_S
        while not (getattr(ws, "_started", None) is None
                   or ws._started.is_set()) or not ws.port:
            assert time.monotonic() < deadline, f"{side} never served"
            time.sleep(0.02)
        # each rest_connector registers its route from its own reader
        # thread, and the first one starts the server: wait for them all
        deadline = time.monotonic() + DEADLINE_S
        while not all(("POST", route) in ws._routes for route, _ in ROUTES):
            assert time.monotonic() < deadline, f"{side} never routed"
            time.sleep(0.02)
        # a tick for the documents before the first question
        deadline = time.monotonic() + DEADLINE_S
        while _post(ws.port, "/v1/statistics", {})[2] in (
                b'{"file_count": null, "last_modified": null}',
                b"[]", b"null"):
            assert time.monotonic() < deadline, f"{side} never indexed"
            time.sleep(0.05)
        raw = [_post(ws.port, route, payload) for route, payload in ROUTES]
        client = m.qa.RAGClient("127.0.0.1", ws.port, timeout=DEADLINE_S)
        via = {}
        for name, call in (
                ("retrieve", lambda: client.retrieve("lazy dog", k=2)),
                ("statistics", client.statistics),
                ("summarize", lambda: client.summarize(["one", "two"])),
                ("answer", lambda: client.answer("quick brown fox"))):
            try:
                via[name] = ("ok", call())
            except json.JSONDecodeError:
                via[name] = ("JSONDecodeError", None)
        return raw, via, sorted(chat.calls)
    finally:
        m.streaming.stop_all()
        th.join(DEADLINE_S)
        m.G.clear()
        assert not th.is_alive(), f"{side} server outlived stop_all()"


def test_rest_server_and_client_equal_reference():
    jraw, jvia, jcalls = _serve("jax")
    traw, tvia, tcalls = _serve("torch")
    assert [(s, c) for s, c, _ in traw] == [(s, c) for s, c, _ in jraw]
    for (_, ctype, jbody), (_, _, tbody) in zip(jraw, traw):
        if ctype == "application/json":
            assert _plain(json.loads(tbody)) == _plain(json.loads(jbody))
        else:
            assert tbody == jbody
    assert tcalls == jcalls
    for name in ("retrieve", "statistics"):
        assert _plain(tvia[name]) == _plain(jvia[name]), name
        assert tvia[name][0] == "ok"
    # the answer and summary routes reply text/plain in both packages:
    # the JAX package's client cannot decode it, the port's returns it
    for name, raw in (("answer", traw[0]), ("summarize", traw[5])):
        assert raw[1] == "text/plain"
        assert jvia[name] == ("JSONDecodeError", None)
        assert tvia[name] == ("ok", raw[2].decode())
    assert _plain(tvia["retrieve"][1]) == _plain(json.loads(traw[2][2]))


def test_deck_retriever_raises_naming_its_step():
    m = _side("torch")
    with pytest.raises(NotImplementedError, match="step 10"):
        m.qa.DeckRetriever(_fake_chat(m), None)
