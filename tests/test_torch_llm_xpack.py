"""The port's LLM xpack pieces (xpacks/llm prompts, splitters, parsers,
llms, rerankers; internals/udfs's async helpers) against the JAX
package's: the same inputs, numpy draws of one seed, through each
package's function, UDF or ``GraphRunner.run_batch``.

Exact: prompts, the splitter's chunks, ``ParseUtf8``, ``BaseChat``'s
messages and an offline chat's replies under run_batch, the async
helpers' results (and their timeouts and retries), async UDFs under
``run_batch`` and ``pw.run``, ``rerank_topk_filter``, ``LLMReranker``.
``EncoderReranker`` over ``EncoderConfig.tiny()`` (f32, mean pooling;
the same weights on both sides): scores within 1e-5 (f32 sums in another
order). The JAX side runs with ``PATHWAY_AUTO_JIT=0`` and
``PATHWAY_DEVICE_INFLIGHT=1``."""

import asyncio
import importlib
import itertools
import threading
import types

import numpy as np
import pytest

DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _side(side: str):
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.engine import streaming
        from pathway_tpu.internals import udfs
        from pathway_tpu.internals.parse_graph import G
        from pathway_tpu.internals.runner import GraphRunner
        from pathway_tpu.xpacks.llm import (llms, parsers, prompts,
                                            rerankers, splitters)
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine import streaming
        from pathway_tpu_torch.internals import udfs
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.internals.runner import GraphRunner
        from pathway_tpu_torch.xpacks.llm import (llms, parsers, prompts,
                                                  rerankers, splitters)
    return types.SimpleNamespace(
        pw=pw, streaming=streaming, udfs=udfs, G=G, GraphRunner=GraphRunner,
        llms=llms, parsers=parsers, prompts=prompts, rerankers=rerankers,
        splitters=splitters)


SIDES = ("jax", "torch")


def _texts(seed: int, n: int, words: int = 40) -> list[str]:
    """Sentences of random words with ., !, ? and newlines between."""
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(300)] + ["ÄÖ", "x-y", "don't"]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 8))):
            m = int(rng.integers(1, words))
            parts.append(" ".join(vocab[j] for j in rng.integers(
                0, len(vocab), m)) + str(rng.choice([".", "!", "?", "\n"])))
        out.append(" ".join(parts))
    return out


def _run_batch(m, table):
    runner = m.GraphRunner()
    cap = runner.capture(table)
    runner.run_batch(n_workers=1)
    m.G.clear()
    return sorted((int(k), row, t, d) for k, row, t, d in cap.events)


def _plain(v):
    if type(v).__name__ == "Json":
        return ("json", _plain(v.value))
    if isinstance(v, dict):
        return tuple(sorted((k, _plain(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    return v


# ---------------------------------------------------------------------------
# prompts
# ---------------------------------------------------------------------------

PROMPTS = {
    "prompt_short_qa": lambda p, docs: p.prompt_short_qa(
        docs, "what is tok3?", additional_rules=" Be brief."),
    "prompt_qa": lambda p, docs: p.prompt_qa(docs, "q?"),
    "prompt_qa_custom_no_info": lambda p, docs: p.prompt_qa(
        docs, "q?", information_not_found_response="nothing"),
    "prompt_qa_geometric_rag": lambda p, docs: p.prompt_qa_geometric_rag(
        docs, "q?"),
    "prompt_qa_geometric_rag_strict": lambda p, docs:
        p.prompt_qa_geometric_rag(docs, "q?", strict_prompt=True),
    "prompt_summarize": lambda p, docs: p.prompt_summarize(docs),
    "prompt_rerank": lambda p, docs: p.prompt_rerank(docs[0], "q?"),
}


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_prompts_equal_reference(name):
    docs = _texts(1, 3) + [{"text": "from a dict", "metadata": {}}]
    got = {side: PROMPTS[name](_side(side).prompts, docs) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert _side("torch").prompts.NO_INFO_ANSWER == \
        _side("jax").prompts.NO_INFO_ANSWER == "No information found."


# ---------------------------------------------------------------------------
# splitter and parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_tokens,max_tokens",
                         [(1, 8), (5, 20), (50, 120), (50, 500)])
def test_token_count_splitter_equals_reference(min_tokens, max_tokens):
    texts = _texts(min_tokens + max_tokens, 12, words=60) + ["", "   ",
                                                            "one"]
    got = {}
    for side in SIDES:
        s = _side(side).splitters.TokenCountSplitter(min_tokens=min_tokens,
                                                     max_tokens=max_tokens)
        got[side] = [s.chunk(t, {"src": i}) for i, t in enumerate(texts)]
    assert got["torch"] == got["jax"]
    # the three blank or one-word texts: no chunk, no chunk, one chunk
    assert [len(c) for c in got["torch"][-3:]] == [0, 0, 1]
    if max_tokens <= 20:
        assert sum(len(c) for c in got["torch"]) > len(texts)


def test_splitter_and_parser_under_run_batch_equal_reference():
    """``ParseUtf8`` then ``TokenCountSplitter`` as column UDFs and a
    flatten, under run_batch; ``null_splitter`` directly."""
    texts = _texts(7, 10, words=30)
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()
        t = m.pw.debug.table_from_rows(
            m.pw.schema_from_types(data=bytes),
            [(x.encode(),) for x in texts])
        parse = m.parsers.ParseUtf8()
        split = m.splitters.TokenCountSplitter(min_tokens=3, max_tokens=12)
        parsed = t.select(p=parse(m.pw.this.data))
        chunks = parsed.select(c=split(m.pw.apply(
            lambda p: p[0][0], m.pw.this.p))).flatten(m.pw.this.c)
        got[side] = ([_plain(r) for _, r, _, _ in _run_batch(m, chunks)],
                     m.splitters.null_splitter("abc"))
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) > len(texts)


def test_unported_parsers_raise_naming_their_step():
    t = _side("torch")
    for cls in (t.parsers.ParseUnstructured, t.parsers.ParseOpenParse):
        with pytest.raises(NotImplementedError, match="step 10"):
            cls()


# ---------------------------------------------------------------------------
# chats
# ---------------------------------------------------------------------------

def _fake_chat(m):
    class FakeChat(m.llms.BaseChat):
        """Echoes the prompt's length and its number of documents."""

        def __init__(self):
            super().__init__(model="fake")
            self.calls = []

        async def __wrapped__(self, messages, **kwargs):
            msgs = self._as_messages(messages)
            self.calls.append(len(msgs))
            prompt = msgs[-1]["content"]
            return f"{len(prompt)}:{prompt.count('[doc ')}:{kwargs}"

    return FakeChat()


MESSAGES = ["plain prompt", [{"role": "user", "content": "hi"}],
            ("tuple", [{"role": "system", "content": "s"},
                       {"role": "user", "content": "u"}]), ("json", "x")]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_basechat_messages_equal_reference(i):
    got = {}
    for side in SIDES:
        m = _side(side)
        msg = MESSAGES[i]
        if isinstance(msg, tuple) and msg[0] == "json":
            msg = m.pw.Json(msg[1])
        elif isinstance(msg, tuple):
            msg = tuple(msg[1])
        chat = _fake_chat(m)
        got[side] = (chat._as_messages(msg), chat.kwargs,
                     asyncio.run(chat.prepared_async()(msg, temperature=0)))
    assert got["torch"] == got["jax"]
    with pytest.raises(TypeError):
        _fake_chat(_side("torch"))._as_messages(3)


def test_chat_column_under_run_batch_equals_reference():
    """``chat(prompt_chat_single_qa(q))`` over a column: an async UDF."""
    qs = [f"question {i} " + "w " * i for i in range(9)]
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()
        t = m.pw.debug.table_from_rows(m.pw.schema_from_types(q=str),
                                       [(q,) for q in qs])
        chat = _fake_chat(m)
        out = t.select(r=chat(m.llms.prompt_chat_single_qa(m.pw.this.q)))
        got[side] = (_run_batch(m, out), sorted(chat.calls))
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == len(qs)


# ---------------------------------------------------------------------------
# the async helpers
# ---------------------------------------------------------------------------

def _helpers(m):
    """name -> (wrapped callable, args): each helper applied to a sync or
    async function, run by asyncio."""
    udfs = m.udfs
    attempts = []

    async def flaky(x):
        attempts.append(x)
        if len(attempts) % 3:
            raise ValueError("flaky")
        return x * 10

    def double(x):
        return 2 * x

    async def slow(x):
        await asyncio.sleep(0.5)
        return x

    retry = m.udfs.FixedDelayRetryStrategy(max_retries=3, delay_ms=1)
    return {
        "coerce_async": (udfs.coerce_async(double), 4),
        "async_options": (udfs.async_options(capacity=2)(double), 5),
        "with_capacity": (udfs.with_capacity(double, 1), 6),
        "with_timeout_ok": (udfs.with_timeout(double, 5.0), 7),
        "with_timeout_expires": (udfs.with_timeout(slow, 0.01), 8),
        "with_retry_strategy": (udfs.with_retry_strategy(flaky, retry), 9),
        "with_cache_strategy": (udfs.with_cache_strategy(
            double, udfs.InMemoryCache()), 10),
    }


@pytest.mark.parametrize("name", ["coerce_async", "async_options",
                                  "with_capacity", "with_timeout_ok",
                                  "with_timeout_expires",
                                  "with_retry_strategy",
                                  "with_cache_strategy"])
def test_async_helpers_equal_reference(name):
    got = {}
    for side in SIDES:
        fn, arg = _helpers(_side(side))[name]

        async def go():
            try:
                return ("ok", await fn(arg), await fn(arg))
            except Exception as e:  # the same error type on both sides
                return ("error", type(e).__name__)

        got[side] = asyncio.run(go())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("error" if name == "with_timeout_expires"
                               else "ok")


def test_udf_async_and_deprecated_classes():
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()

        @m.udfs.udf_async(capacity=2, timeout=5.0)
        async def plus(x: int) -> int:
            await asyncio.sleep(0)
            return x + 1

        class Sync(m.udfs.UDFSync):
            def __wrapped__(self, x: int) -> int:
                return 3 * x

        class Async(m.udfs.UDFAsync):
            async def __wrapped__(self, x: int) -> int:
                return 5 * x

        t = m.pw.debug.table_from_rows(m.pw.schema_from_types(x=int),
                                       [(i,) for i in range(6)])
        out = t.select(a=plus(m.pw.this.x), b=Sync()(m.pw.this.x),
                       c=Async()(m.pw.this.x))
        got[side] = _run_batch(m, out)
    assert got["torch"] == got["jax"]
    assert sorted(row for _, row, _, _ in got["torch"]) == sorted(
        (i + 1, 3 * i, 5 * i) for i in range(6))


def _async_stream(side: str, values: list[int], monkeypatch):
    """An ``async def`` wrapped in ``@pw.udf`` under ``pw.run`` over a
    python connector; returns the subscribed (key, row, diff). Both
    packages number their sources from a module counter: reset here."""
    m = _side(side)
    m.G.clear()
    datasource = importlib.import_module(
        ("pathway_tpu" if side == "jax" else "pathway_tpu_torch")
        + ".io._datasource")
    monkeypatch.setattr(datasource, "_source_counter", itertools.count(5))

    @m.pw.udf
    async def square(x: int) -> int:
        await asyncio.sleep(0.001)
        return x * x

    class Subject(m.pw.io.python.ConnectorSubject):
        def run(self):
            for v in values:
                self.next(x=v)

    t = m.pw.io.python.read(Subject(), schema=m.pw.schema_from_types(x=int),
                            autocommit_duration_ms=5)
    events: list = []
    m.pw.io.subscribe(t.select(y=square(m.pw.this.x)),
                      lambda key, row, time, is_addition: events.append(
                          (int(key), row["y"], 1 if is_addition else -1)))
    errors = []

    def run():
        try:
            m.pw.run()
        except Exception as e:  # re-raised by the caller's assert
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        th.join(DEADLINE_S)
    finally:
        m.streaming.stop_all()
        th.join(DEADLINE_S)
        m.G.clear()
    assert not th.is_alive() and not errors, (side, errors)
    return sorted(events)


def test_async_udf_under_pw_run_equals_reference(monkeypatch):
    values = list(range(-5, 20))
    got = {side: _async_stream(side, values, monkeypatch) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert sorted(y for _, y, _ in got["torch"]) == sorted(
        v * v for v in values)


# ---------------------------------------------------------------------------
# rerankers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
def test_rerank_topk_filter_equals_reference(k):
    rng = np.random.default_rng(k)
    rows = [(tuple(f"d{i}" for i in range(6)),
             tuple(float(x) for x in rng.normal(size=6)), k)
            for _ in range(5)]
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()
        t = m.pw.debug.table_from_rows(
            m.pw.schema_from_types(docs=tuple, scores=tuple, k=int), rows)
        out = t.select(r=m.rerankers.rerank_topk_filter(
            m.pw.this.docs, m.pw.this.scores, m.pw.this.k))
        got[side] = (_plain([r for _, r, _, _ in _run_batch(m, out)]),
                     m.rerankers.rerank_topk_filter.func(
                         list(rows[0][0]), list(rows[0][1]), k))
    assert got["torch"] == got["jax"]
    assert len(got["torch"][1][0]) == min(k, 6)


def test_llm_reranker_equals_reference():
    docs = _texts(3, 6)
    docs[2] = "relevant-doc " + docs[2]
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()

        class ScoreChat(m.llms.BaseChat):
            async def __wrapped__(self, messages, **kwargs):
                prompt = self._as_messages(messages)[-1]["content"]
                return "5" if "relevant-doc" in prompt else "score: 2"

        rr = m.rerankers.LLMReranker(ScoreChat())
        t = m.pw.debug.table_from_rows(
            m.pw.schema_from_types(doc=str, q=str), [(d, "q") for d in docs])
        got[side] = _run_batch(m, t.select(s=rr(m.pw.this.doc,
                                                m.pw.this.q)))
    assert got["torch"] == got["jax"]
    assert sorted(r[0] for _, r, _, _ in got["torch"]) == [2.0] * 5 + [5.0]


@pytest.fixture(scope="module")
def tiny_params():
    from pathway_tpu_torch.models.encoder import (EncoderConfig,
                                                  init_params_host)

    return init_params_host(0, EncoderConfig.tiny())


def _embedder(side: str, params):
    import jax.numpy as jnp
    import torch

    if side == "jax":
        from pathway_tpu.models.encoder import EncoderConfig
        from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder

        return JaxEncoderEmbedder(
            config=EncoderConfig.tiny(compute_dtype=jnp.float32,
                                      pooling="mean"), params=params)
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    return EncoderEmbedder(
        config=EncoderConfig.tiny(compute_dtype=torch.float32,
                                  pooling="mean"),
        params=params, device="cpu")


def test_encoder_reranker_equals_reference(tiny_params):
    """``EncoderReranker`` over the tiny encoder, directly (one batched
    forward of documents and queries) and as a batch UDF under
    run_batch: scores within 1e-5."""
    docs = _texts(4, 10, words=20)
    queries = [d.split(".")[0] for d in docs[::-1]]
    got = {}
    for side in SIDES:
        m = _side(side)
        m.G.clear()
        rr = m.rerankers.EncoderReranker(_embedder(side, tiny_params))
        direct = rr.func(docs, queries)
        t = m.pw.debug.table_from_rows(
            m.pw.schema_from_types(doc=str, q=str), list(zip(docs, queries)))
        engine = _run_batch(m, t.select(s=rr(m.pw.this.doc, m.pw.this.q)))
        got[side] = (np.array(direct), [(k, tm, d) for k, _, tm, d in engine],
                     np.array([r[0] for _, r, _, _ in engine]))
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=0,
                               atol=1e-5)
    assert got["torch"][1] == got["jax"][1]
    np.testing.assert_allclose(got["torch"][2], got["jax"][2], rtol=0,
                               atol=1e-5)
    assert np.all(np.abs(got["torch"][0]) <= 1 + 1e-6)


def test_hf_pipeline_chat_runs_on_the_card_by_default():
    """``HFPipelineChat`` follows the port's rule for entry points: the
    card unless the caller asks for the CPU, and a raise without a card
    (before transformers is imported)."""
    import inspect

    import torch

    from pathway_tpu_torch.xpacks.llm.llms import HFPipelineChat

    sig = inspect.signature(HFPipelineChat.__init__)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HFPipelineChat(model="a-local-model")
