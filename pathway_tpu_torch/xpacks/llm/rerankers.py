"""Rerankers, scoring (doc, query) pairs for retrieval refinement — port of
pathway_tpu/xpacks/llm/rerankers.py (reference: xpacks/llm/rerankers.py —
rerank_topk_filter:15, LLMReranker:54, CrossEncoderReranker:182,
EncoderReranker:247, FlashRankReranker:315).

``EncoderReranker`` composes with any embedder UDF. Over the port's
``EncoderEmbedder`` it calls ``embed_batch``: one batched encoder forward
of the engine batch's documents and queries on the embedder's device (K1
in every layer on the card), then the cosine of each pair on the host.
``CrossEncoderReranker`` and ``FlashRankReranker`` import their packages
when built, and raise ``ImportError`` where they are absent.
"""

from __future__ import annotations

import re

import numpy as np

from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.xpacks.llm import llms, prompts
from pathway_tpu_torch.xpacks.llm._utils import _import_or_raise


@udfs.udf
def rerank_topk_filter(docs: list, scores: list[float],
                       k: int = 5) -> tuple[list, list[float]]:
    """Keep the k best-scored docs (reference rerankers.py:15)."""
    order = np.argsort(scores)[::-1][:k]
    return ([docs[i] for i in order], [float(scores[i]) for i in order])


class LLMReranker(udfs.UDF):
    """LLM-as-judge 1-5 relevance score (reference rerankers.py:54)."""

    def __init__(self, llm: llms.BaseChat, *,
                 retry_strategy: udfs.AsyncRetryStrategy | None = None,
                 cache_strategy: udfs.CacheStrategy | None = None,
                 use_logit_bias: bool | None = None, **kwargs):
        executor = udfs.async_executor(retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy,
                         **kwargs)
        self.llm = llm

    async def __wrapped__(self, doc: str, query: str, **kwargs) -> float:
        if isinstance(doc, Json):
            doc = str(doc.value.get("text", doc.value)) \
                if isinstance(doc.value, dict) else str(doc.value)
        prompt = prompts.prompt_rerank(str(doc), str(query))
        answer = await self.llm.prepared_async()(
            [{"role": "user", "content": prompt}], **kwargs)
        match = re.search(r"[1-5]", str(answer))
        if match is None:
            raise ValueError(f"reranker got unparsable score: {answer!r}")
        return float(match.group())


class EncoderReranker(udfs.UDF):
    """Bi-encoder cosine similarity reranker (reference rerankers.py:247).
    ``embedder`` is any embedder UDF; ``EncoderEmbedder`` embeds the batch
    in one forward on its device."""

    def __init__(self, embedder, **kwargs):
        kwargs.setdefault("batch", True)
        super().__init__(**kwargs)
        self.embedder = embedder

    def _embed(self, texts: list[str]) -> np.ndarray:
        if hasattr(self.embedder, "embed_batch"):
            return np.asarray(self.embedder.embed_batch(texts))
        from pathway_tpu_torch.xpacks.llm._utils import _unwrap_udf

        f = _unwrap_udf(self.embedder)
        return np.stack([np.asarray(f(t)) for t in texts])

    def __wrapped__(self, docs: list, queries: list, **kwargs) -> list[float]:
        texts = []
        for d in docs:
            if isinstance(d, Json):
                d = d.value.get("text", d.value) \
                    if isinstance(d.value, dict) else d.value
            texts.append(str(d))
        emb = self._embed(texts + [str(q) for q in queries])
        doc_emb, q_emb = emb[:len(texts)], emb[len(texts):]

        def norm(x):
            return x / np.maximum(
                np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

        return [float(s) for s in np.sum(
            norm(doc_emb) * norm(q_emb), axis=-1)]


class CrossEncoderReranker(udfs.UDF):
    """sentence-transformers CrossEncoder (reference rerankers.py:182)."""

    def __init__(self, model_name: str, *,
                 cache_strategy: udfs.CacheStrategy | None = None, **kwargs):
        kwargs.setdefault("batch", True)
        super().__init__(cache_strategy=cache_strategy, **kwargs)
        st = _import_or_raise("sentence_transformers", "CrossEncoderReranker")
        self.model = st.CrossEncoder(model_name)

    def __wrapped__(self, docs: list, queries: list, **kwargs) -> list[float]:
        pairs = [[str(q), str(d.value.get("text", d.value)
                              if isinstance(d, Json) and isinstance(d.value, dict)
                              else d)]
                 for d, q in zip(docs, queries)]
        return [float(s) for s in self.model.predict(pairs)]


class FlashRankReranker(udfs.UDF):
    """flashrank listwise reranker (reference rerankers.py:315)."""

    def __init__(self, model_name: str = "ms-marco-TinyBERT-L-2-v2",
                 **kwargs):
        super().__init__(**kwargs)
        flashrank = _import_or_raise("flashrank", "FlashRankReranker")
        self.ranker = flashrank.Ranker(model_name=model_name)
        self._flashrank = flashrank

    def __wrapped__(self, doc: str, query: str, **kwargs) -> float:
        if isinstance(doc, Json):
            doc = doc.value.get("text", doc.value) \
                if isinstance(doc.value, dict) else doc.value
        req = self._flashrank.RerankRequest(
            query=str(query), passages=[{"text": str(doc)}])
        return float(self.ranker.rerank(req)[0]["score"])
