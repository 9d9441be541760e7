"""Prompt templates for RAG question answering — port of
pathway_tpu/xpacks/llm/prompts.py.

Implementations of the prompt-building roles in the reference
(xpacks/llm/prompts.py / question_answering.py:88-152): short/long QA
prompts over retrieved context, citation-style answers and summaries. The
"No information found" sentinel is load-bearing: the adaptive RAG loop
re-asks with more documents when the model emits it
(question_answering.py:88-153).
"""

from __future__ import annotations

from typing import Iterable

NO_INFO_ANSWER = "No information found."


def _join_docs(docs: Iterable) -> str:
    texts = []
    for d in docs:
        if isinstance(d, dict):
            texts.append(str(d.get("text", d)))
        else:
            texts.append(str(d))
    return "\n\n".join(f"[doc {i + 1}]\n{t}" for i, t in enumerate(texts))


def prompt_short_qa(context_docs, query: str,
                    additional_rules: str = "") -> str:
    return (
        "Answer the question based only on the documents below. Reply with "
        f'a short answer (a few words). If the documents do not contain the '
        f'answer, reply exactly "{NO_INFO_ANSWER}".'
        f"{additional_rules}\n\nDocuments:\n{_join_docs(context_docs)}\n\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_qa(context_docs, query: str,
              information_not_found_response: str = NO_INFO_ANSWER,
              additional_rules: str = "") -> str:
    return (
        "You are answering a question using only the documents provided "
        "below. Quote the relevant parts when helpful. If the documents do "
        "not contain the answer, reply exactly "
        f'"{information_not_found_response}".'
        f"{additional_rules}\n\nDocuments:\n{_join_docs(context_docs)}\n\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_qa_geometric_rag(context_docs, query: str,
                            information_not_found_response: str = NO_INFO_ANSWER,
                            additional_rules: str = "",
                            strict_prompt: bool = False) -> str:
    """Strict variant used by the adaptive strategy: the model must not
    guess, so escalation on the sentinel is sound. ``strict_prompt``
    tightens the output contract further for small open-source models
    (reference: prompts.prompt_qa_geometric_rag's strict mode)."""
    if strict_prompt:
        additional_rules += (
            " Respond with the answer text alone — no preamble, no "
            "explanation, no quotation marks around the whole answer.")
    return (
        "Use ONLY the documents below to answer. Do not use prior "
        "knowledge. If the answer is not contained in the documents, reply "
        f'exactly "{information_not_found_response}" and nothing else.'
        f"{additional_rules}\n\nDocuments:\n{_join_docs(context_docs)}\n\n"
        f"Question: {query}\nAnswer:"
    )


def prompt_summarize(texts: Iterable[str]) -> str:
    joined = "\n\n".join(str(t) for t in texts)
    return (
        "Summarize the following texts into a single concise summary that "
        f"keeps the key facts.\n\nTexts:\n{joined}\n\nSummary:"
    )


def prompt_rerank(doc: str, query: str) -> str:
    return (
        "Rate how relevant the document is to the query on a scale of 1 to "
        "5, where 5 means highly relevant. Reply with ONLY the number.\n\n"
        f"Document:\n{doc}\n\nQuery: {query}\nScore:"
    )
