"""The port's WordPiece tokenizer (pathway_tpu_torch/models/tokenizer.py and
its native engine, pathway_tpu_torch/native/) against the JAX package's.

The same vocabularies and texts go through four engines: the port's C++
engine (built from ``pathway_tpu_torch/native/wordpiece.cpp`` into
``pathway_tpu_torch/_build/``), the port's pure-Python engine, and the
JAX package's two. Ids and masks must be equal, exactly, for ``batch``
with and without ``pad_to``; ``make_synthetic_vocab`` must give the same
list. This machine has ``g++``, so the native engine must be the one
running.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from pathway_tpu.models import tokenizer as jax_tok
from pathway_tpu_torch.models import tokenizer as port_tok
from pathway_tpu_torch.native import build, wordpiece_available

from test_wordpiece import CASES, VOCAB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_WORDS = [f"word{i}" for i in range(4096)]


def make_docs(n: int, seed: int = 0) -> list[str]:
    """bench.py's make_docs: n documents of 90 words drawn from a 4096-word
    vocabulary."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(BENCH_WORDS), size=(n, 90))
    return [" ".join(BENCH_WORDS[j] for j in row) for row in idx]


def _engines(vocab, **kw):
    """(name, tokenizer) for the port's native and Python engines and the
    JAX package's two."""
    out = []
    for mod, pkg in ((port_tok, "port"), (jax_tok, "jax")):
        for native in (True, False):
            tok = mod.WordPieceTokenizer(vocab, prefer_native=native, **kw)
            assert (tok._native is not None) == native, (pkg, native)
            out.append((f"{pkg} {'native' if native else 'python'}", tok))
    return out


def _assert_same(engines, texts, **kw):
    ref_ids, ref_mask = engines[0][1].batch(texts, **kw)
    for name, tok in engines[1:]:
        ids, mask = tok.batch(texts, **kw)
        assert ids.dtype == ref_ids.dtype and mask.dtype == ref_mask.dtype
        np.testing.assert_array_equal(ids, ref_ids, err_msg=name)
        np.testing.assert_array_equal(mask, ref_mask, err_msg=name)
    return ref_ids, ref_mask


def test_synthetic_vocab_equals_jax_package():
    for words, size, seed in ((BENCH_WORDS, 30522, 0), (BENCH_WORDS[:500],
                                                        4096, 3)):
        got = port_tok.make_synthetic_vocab(words, vocab_size=size,
                                            seed=seed)
        assert got == jax_tok.make_synthetic_vocab(words, vocab_size=size,
                                                   seed=seed)
        assert len(got) == size and len(set(got)) == size


def test_native_engine_active():
    assert wordpiece_available()
    tok = port_tok.WordPieceTokenizer(VOCAB)
    assert tok.native and tok.native_error is None
    off = port_tok.WordPieceTokenizer(VOCAB, prefer_native=False)
    assert not off.native and off.native_error is None


@pytest.mark.parametrize("pad_to", [None, 64])
def test_reference_cases_equal(pad_to):
    engines = _engines(VOCAB)
    for case in CASES:
        _assert_same(engines, [case], pad_to=pad_to)
    # one batched call over every case equals the per-case calls
    ids, mask = _assert_same(engines, CASES, pad_to=pad_to)
    assert ids.shape[0] == len(CASES)


@pytest.mark.parametrize("pad_to", [None, 128])
def test_bench_docs_equal(pad_to):
    """2048 of bench's documents (plus out-of-vocabulary text) over bench's
    synthetic vocabulary, at bench's max_len 128."""
    vocab = port_tok.make_synthetic_vocab(BENCH_WORDS, vocab_size=30522)
    engines = _engines(vocab, max_len=128)
    docs = make_docs(2048) + ["zq9k mixed OOV text, word12!", ""] + CASES
    ids, mask = _assert_same(engines, docs, pad_to=pad_to)
    # each bench word is one whole-word piece: 90 words + CLS + SEP
    assert (mask[:2048].sum(1) == 92).all()
    assert ids.shape[1] == (pad_to or 92)


def test_builds_into_port_build_dir():
    path = build.ensure_built("wordpiece")
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "pathway_tpu_torch",
                                                 "_build")
    assert os.path.commonpath([path, os.path.join(REPO, "pathway_tpu")]) \
        != os.path.join(REPO, "pathway_tpu")
    assert build._SRC_DIR == os.path.join(REPO, "pathway_tpu_torch",
                                          "native")


def test_source_edit_changes_library_name(tmp_path, monkeypatch):
    src = os.path.join(build._SRC_DIR, "wordpiece.cpp")
    with open(src) as f:
        text = f.read()
    before = os.path.basename(build.library_path("wordpiece"))
    (tmp_path / "wordpiece.cpp").write_text(text + "\n// edited\n")
    monkeypatch.setattr(build, "_SRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path / "_build"))
    after = build.library_path("wordpiece")
    assert os.path.basename(after) != before
    assert build.ensure_built("wordpiece") == after and os.path.exists(after)
