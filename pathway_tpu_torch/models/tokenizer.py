"""Tokenizers for the encoder — port of pathway_tpu/models/tokenizer.py.

``HashTokenizer`` (the embedder's default) is a dependency-free
deterministic tokenizer (word -> stable md5 hash mod vocab): the same text
gives the same ids here and in the JAX package. ``WordPieceTokenizer`` is
the reference's BERT WordPiece, with its two engines: the batch C++ engine
(``native/wordpiece.cpp``, built on first use) and the pure-Python one.
``make_synthetic_vocab`` is the reference's vocabulary for benches and
tests when no checkpoint vocabulary is on disk.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]")

CLS_ID = 101
SEP_ID = 102
PAD_ID = 0
_RESERVED = 1000  # ids below this are reserved for specials


class HashTokenizer:
    """Deterministic, vocabulary-free tokenizer: token ids are stable
    across processes (md5-based, not Python ``hash``)."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 512,
                 add_special_tokens: bool = True):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.add_special_tokens = add_special_tokens
        self._cache: dict[str, int] = {}

    def _word_id(self, word: str) -> int:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        h = hashlib.md5(word.lower().encode()).digest()
        span = self.vocab_size - _RESERVED
        wid = _RESERVED + int.from_bytes(h[:8], "little") % span
        if len(self._cache) < 1 << 20:
            self._cache[word] = wid
        return wid

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        max_len = max_len or self.max_len
        ids = [self._word_id(w) for w in _WORD_RE.findall(text)]
        if self.add_special_tokens:
            ids = [CLS_ID] + ids[: max_len - 2] + [SEP_ID]
        else:
            ids = ids[:max_len]
        return ids

    def batch(self, texts: list[str], max_len: int | None = None,
              pad_to: int | None = None):
        """→ (token_ids, attention_mask) int32/bool arrays, padded to the
        longest sequence (or ``pad_to``) — static-shape friendly: callers
        should bucket ``pad_to`` to a few sizes to bound recompilation."""
        max_len = max_len or self.max_len
        encoded = [self.encode(t, max_len) for t in texts]
        width = pad_to or max(1, max(len(e) for e in encoded))
        ids = np.full((len(texts), width), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), width), dtype=bool)
        for i, e in enumerate(encoded):
            e = e[:width]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = True
        return ids, mask


# ---------------------------------------------------------------------------
# WordPiece — the real BERT/BGE tokenizer
# ---------------------------------------------------------------------------

_PUNCT = set(
    [chr(c) for c in range(33, 48)] + [chr(c) for c in range(58, 65)]
    + [chr(c) for c in range(91, 97)] + [chr(c) for c in range(123, 127)])


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFADF)


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece with BERT basic tokenization
    (lowercase, whitespace/punctuation/CJK split) — the real tokenizer the
    reference uses through HF `tokenizers` inside
    SentenceTransformerEmbedder (xpacks/llm/embedders.py:268-326).

    Two engines with identical output: the batch C++ engine
    (``native/wordpiece.cpp``), taken when ``prefer_native`` and the
    library builds, and the pure-Python implementation. ``native`` says
    which one runs; ``native_error`` holds why the C++ engine was not
    taken (None when it was, or was not asked for).

    Known simplification vs HF BertTokenizer: no unicode accent stripping
    (NFD) and no in-text special-token passthrough.
    """

    def __init__(self, vocab: list[str] | dict[str, int], *,
                 do_lower: bool = True, max_len: int = 512,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 prefer_native: bool = True):
        if isinstance(vocab, dict):
            items = sorted(vocab.items(), key=lambda kv: kv[1])
            vocab = [tok for tok, _ in items]
        self.vocab_list = list(vocab)
        self.vocab = {tok: i for i, tok in enumerate(self.vocab_list)}
        self.vocab_size = len(self.vocab_list)
        self.do_lower = do_lower
        self.max_len = max_len
        self.unk_id = self.vocab[unk_token]
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self._cont = {tok[2:]: i for tok, i in self.vocab.items()
                      if tok.startswith("##")}
        self._full = {tok: i for tok, i in self.vocab.items()
                      if not tok.startswith("##")}
        self._native = None
        self.native_error: Exception | None = None
        if prefer_native:
            from pathway_tpu_torch.native import NativeWordPiece

            try:
                self._native = NativeWordPiece(self.vocab_list,
                                               do_lower=do_lower)
            except Exception as e:  # no toolchain: the Python engine runs
                self.native_error = e

    @property
    def native(self) -> bool:
        """True when the C++ engine tokenizes."""
        return self._native is not None

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        """Load a HuggingFace ``vocab.txt`` (one piece per line, id=line)."""
        with open(path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n").rstrip("\r") for line in f]
        while vocab and vocab[-1] == "":
            vocab.pop()
        return cls(vocab, **kw)

    # -- pure-Python reference implementation ---------------------------
    def _basic_tokenize(self, text: str) -> list[str]:
        """HF BasicTokenizer character classes (tokenization_bert.py):
        whitespace = " \\t\\n\\r" + category Zs; control chars (category
        C*) are DROPPED, not treated as spaces; ASCII punctuation and CJK
        codepoints split as their own tokens."""
        import unicodedata

        if self.do_lower:
            text = "".join(
                c.lower() if ord(c) < 128 else c for c in text)
        out: list[str] = []
        word: list[str] = []

        def flush():
            if word:
                out.append("".join(word))
                word.clear()

        for ch in text:
            cp = ord(ch)
            if ch in " \t\n\r":
                flush()
                continue
            if cp >= 0x80 or cp < 0x20 or cp == 0x7F:
                cat = unicodedata.category(ch)
                if cat in ("Zs", "Zl", "Zp"):
                    # Zl/Zp: HF's whitespace_tokenize is str.split(),
                    # which splits on line/paragraph separators too
                    flush()
                    continue
                if cat.startswith("C"):
                    continue  # control/format chars vanish (HF clean_text)
            if ch in _PUNCT or _is_cjk(cp):
                flush()
                out.append(ch)
            else:
                word.append(ch)
        flush()
        return out

    def _wordpiece(self, word: str) -> list[int]:
        if len(word.encode("utf-8")) > 100:
            return [self.unk_id]
        pieces: list[int] = []
        start = 0
        while start < len(word):
            table = self._full if start == 0 else self._cont
            end = len(word)
            found = None
            while end > start:
                piece = word[start:end]
                wid = table.get(piece)
                if wid is not None:
                    found = wid
                    break
                end -= 1
            if found is None:
                return [self.unk_id]
            pieces.append(found)
            start = end
        return pieces

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        max_len = max_len or self.max_len
        ids = [self.cls_id]
        for word in self._basic_tokenize(text):
            if len(ids) >= max_len - 1:
                break
            ids.extend(self._wordpiece(word))
        ids = ids[: max_len - 1]
        ids.append(self.sep_id)
        return ids

    # -- batch API (same contract as HashTokenizer.batch) ----------------
    def batch(self, texts: list[str], max_len: int | None = None,
              pad_to: int | None = None):
        max_len = max_len or self.max_len
        width = pad_to or max_len
        if self._native is not None:
            raw = [t.encode("utf-8") for t in texts]
            ids, lens = self._native.encode_batch(
                raw, width, self.cls_id, self.sep_id, self.unk_id,
                self.pad_id)
            mask = np.arange(width)[None, :] < lens[:, None]
            if pad_to is None:
                w = max(1, int(lens.max()) if len(texts) else 1)
                ids, mask = ids[:, :w], mask[:, :w]
            return ids, mask
        encoded = [self.encode(t, width) for t in texts]
        if pad_to is None:
            width = max(1, max(len(e) for e in encoded)) if encoded else 1
        ids = np.full((len(texts), width), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), width), dtype=bool)
        for i, e in enumerate(encoded):
            e = e[:width]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = True
        return ids, mask


def make_synthetic_vocab(words: list[str], vocab_size: int = 30522,
                         seed: int = 0) -> list[str]:
    """A deterministic vocab.txt-shaped vocabulary for benches and tests
    when no checkpoint vocabulary is on disk: specials first (BERT layout),
    then whole words, then 2-4 char pieces (and their ## continuations) so
    out-of-vocab words still split instead of collapsing to [UNK]. The
    same list as the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    seen = set(vocab)
    for w in words:
        if w not in seen:
            vocab.append(w)
            seen.add(w)
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
    for ch in alphabet:
        for tok in (ch, "##" + ch):
            if tok not in seen:
                vocab.append(tok)
                seen.add(tok)
    while len(vocab) < vocab_size:
        n = int(rng.integers(2, 5))
        piece = "".join(rng.choice(list(alphabet), size=n))
        tok = piece if rng.random() < 0.3 else "##" + piece
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
    return vocab[:vocab_size]
