"""LLM chat wrappers, UDFs mapping prompt columns to completions — port of
pathway_tpu/xpacks/llm/llms.py (reference: xpacks/llm/llms.py — BaseChat:27,
OpenAIChat:84, LiteLLMChat:310, HFPipelineChat:438, CohereChat:541).

All are async UDFs with capacity, retry and cache, so a whole engine batch
of prompts is in flight at once; ``prepared_async()`` gives the same
wrapped call outside the engine (the adaptive RAG loop). The provider
clients (openai, litellm, cohere, transformers) are imported when a model
is built or called, and raise ``ImportError`` where the package is absent.
"""

from __future__ import annotations

import asyncio
from typing import Any

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.xpacks.llm._utils import _import_or_raise


class BaseChat(udfs.UDF):
    """Chat model base (reference llms.py:27). Input is either a plain
    prompt string or a list of {role, content} messages."""

    def __init__(self, *, capacity: int | None = None,
                 retry_strategy: udfs.AsyncRetryStrategy | None = None,
                 cache_strategy: udfs.CacheStrategy | None = None,
                 model: str | None = None, **call_kwargs):
        executor = udfs.async_executor(capacity=capacity,
                                       retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        call_kwargs["model"] = model
        self.kwargs = {k: v for k, v in call_kwargs.items() if v is not None}

    @staticmethod
    def _as_messages(prompt) -> list[dict]:
        if isinstance(prompt, Json):
            prompt = prompt.value
        if isinstance(prompt, str):
            return [{"role": "user", "content": prompt}]
        if isinstance(prompt, (list, tuple)):
            return [m.value if isinstance(m, Json) else m for m in prompt]
        raise TypeError(f"prompt must be str or messages, got {type(prompt)}")


class OpenAIChat(BaseChat):
    """OpenAI chat completions (reference llms.py:84)."""

    def __init__(self, model: str | None = "gpt-3.5-turbo",
                 api_key: str | None = None, base_url: str | None = None,
                 **kwargs):
        super().__init__(model=model, **kwargs)
        self._client_kwargs = {"api_key": api_key, "base_url": base_url}
        self._client = None

    def _get_client(self):
        if self._client is None:
            openai = _import_or_raise("openai", "OpenAIChat")
            kw = {k: v for k, v in self._client_kwargs.items()
                  if v is not None}
            self._client = openai.AsyncOpenAI(**kw)
        return self._client

    async def __wrapped__(self, messages, **kwargs) -> str | None:
        resp = await self._get_client().chat.completions.create(
            messages=self._as_messages(messages), **{**self.kwargs, **kwargs})
        return resp.choices[0].message.content


class LiteLLMChat(BaseChat):
    """Any provider through litellm (reference llms.py:310)."""

    async def __wrapped__(self, messages, **kwargs) -> str | None:
        litellm = _import_or_raise("litellm", "LiteLLMChat")
        resp = await litellm.acompletion(
            messages=self._as_messages(messages), **{**self.kwargs, **kwargs})
        return resp.choices[0].message.content


class CohereChat(BaseChat):
    """Cohere chat with RAG citations (reference llms.py:541): returns
    (response_text, cited_documents)."""

    def __init__(self, model: str | None = "command", **kwargs):
        super().__init__(model=model, **kwargs)

    async def __wrapped__(self, messages, documents=None, **kwargs) -> tuple:
        cohere = _import_or_raise("cohere", "CohereChat")
        msgs = self._as_messages(messages)
        docs = [d.value if isinstance(d, Json) else dict(d)
                for d in (documents or [])]
        client = cohere.AsyncClient()
        resp = await client.chat(
            message=msgs[-1]["content"],
            chat_history=msgs[:-1],
            documents=docs or None,
            **{**self.kwargs, **kwargs})
        cited = [dict(d) for d in (resp.documents or [])] \
            if getattr(resp, "documents", None) else []
        return resp.text, cited


class HFPipelineChat(BaseChat):
    """Local HuggingFace transformers pipeline (reference llms.py:438);
    batches serialize through one pipeline. It runs on the card unless the
    caller asks for the CPU (``device="cpu"``), and raises without one."""

    def __init__(self, model: str | None = None, device: str = "cuda",
                 call_kwargs: dict = {}, **kwargs):
        super().__init__(model=None, **kwargs)
        device = resolve_device(device)
        transformers = _import_or_raise("transformers", "HFPipelineChat")
        self.pipeline = transformers.pipeline(
            "text-generation", model=model, device=device)
        self.tokenizer = self.pipeline.tokenizer
        self.call_kwargs = dict(call_kwargs)

    def crop_to_max_length(self, input_string: str,
                           max_prompt_length: int = 500) -> str:
        tokens = self.tokenizer.tokenize(input_string)
        if len(tokens) > max_prompt_length:
            tokens = tokens[-max_prompt_length:]
            return self.tokenizer.convert_tokens_to_string(tokens)
        return input_string

    async def __wrapped__(self, messages, **kwargs) -> str | None:
        msgs = self._as_messages(messages)
        call_kwargs = {**self.call_kwargs, **kwargs}
        call_kwargs.setdefault("return_full_text", False)
        prompt: Any = msgs
        if getattr(self.tokenizer, "chat_template", None) is None:
            prompt = "\n".join(m["content"] for m in msgs)
        out = await asyncio.to_thread(self.pipeline, prompt, **call_kwargs)
        first = out[0] if isinstance(out, list) else out
        text = first.get("generated_text")
        if isinstance(text, list):  # chat-format output
            text = text[-1].get("content")
        return text


@udfs.udf
def prompt_chat_single_qa(question: str) -> Json:
    """Column UDF wrapping a plain question into a single-turn message list
    (reference llms.py prompt_chat_single_qa)."""
    return Json([{"role": "user", "content": str(question)}])
