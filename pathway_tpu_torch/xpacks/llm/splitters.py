"""Text splitters — port of pathway_tpu/xpacks/llm/splitters.py (reference:
xpacks/llm/splitters.py — null_splitter, TokenCountSplitter with tiktoken).

Splitters are UDFs: ``str → list[tuple[str, dict]]`` (chunk, metadata), so
``table.select(chunks=splitter(pw.this.text))`` followed by ``flatten``
fans chunks out into rows.
"""

from __future__ import annotations

import re
import unicodedata

from pathway_tpu_torch.internals import udfs


def null_splitter(txt: str) -> list[tuple[str, dict]]:
    """No-op splitter: one chunk per document (reference :?null_splitter)."""
    return [(txt, {})]


def _default_tokenizer(text: str) -> list[str]:
    # whitespace+punct tokenization approximating a BPE token count;
    # tiktoken (absent here) would give ~0.75 words/token for English
    return re.findall(r"\w+|[^\w\s]", text)


class TokenCountSplitter(udfs.UDF):
    """Split text into chunks of [min_tokens, max_tokens] tokens, preferring
    sentence/punctuation boundaries (reference TokenCountSplitter uses
    tiktoken token ids; here token = word-level unit from a pluggable
    tokenizer, e.g. models.tokenizer.HashTokenizer.encode)."""

    CHARS_PER_TOKEN = 5  # only used for encoding-less length estimates

    def __init__(self, min_tokens: int = 50, max_tokens: int = 500,
                 encoding_name: str = "cl100k_base", tokenize=None, **kwargs):
        super().__init__(**kwargs)
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        self._tokenize = tokenize or _default_tokenizer

    def chunk(self, txt: str, metadata: dict | None = None) -> list[tuple[str, dict]]:
        text = unicodedata.normalize("NFKC", txt or "")
        metadata = metadata or {}
        if not text.strip():
            return []
        # split into sentences, then greedily pack into chunks
        sentences = re.split(r"(?<=[.!?\n])\s+", text)
        chunks: list[str] = []
        cur: list[str] = []
        cur_tokens = 0
        for sent in sentences:
            n = len(self._tokenize(sent))
            if n > self.max_tokens:
                # hard-split an oversized sentence by tokens
                words = self._tokenize(sent)
                if cur:
                    chunks.append(" ".join(cur))
                    cur, cur_tokens = [], 0
                for i in range(0, len(words), self.max_tokens):
                    chunks.append(" ".join(words[i:i + self.max_tokens]))
                continue
            if cur and cur_tokens + n > self.max_tokens:
                # flush even below min_tokens: an undersized chunk beats an
                # oversized one (which the embedder would silently truncate)
                chunks.append(" ".join(cur))
                cur, cur_tokens = [], 0
            cur.append(sent)
            cur_tokens += n
        if cur:
            tail = " ".join(cur)
            if chunks and cur_tokens < self.min_tokens:
                chunks[-1] = chunks[-1] + " " + tail
            else:
                chunks.append(tail)
        return [(c, dict(metadata)) for c in chunks if c.strip()]

    def __wrapped__(self, txt: str, **kwargs) -> list[tuple[str, dict]]:
        return self.chunk(txt, kwargs.get("metadata"))
