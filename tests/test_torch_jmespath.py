"""The port's metadata-filter evaluator (pathway_tpu_torch/internals/
jmespath_lite.py, a copy) against the JAX package's, and string filters
through the port's index and ``VectorStoreServer``.

- Every expression of the subset — dot paths, the three kinds of literal
  (backquoted, quoted string, number), the comparisons, ``&&`` / ``||`` /
  ``!``, parentheses, ``contains`` and ``globmatch`` — parses to the same
  tree and evaluates alike over the same metadata, fixed cases and
  hypothesis-drawn ones; malformed input raises the same exception type.
- A retrieve with ``metadata_filter`` and one with ``filepath_globpattern``
  (the string filters ``VectorStoreServer.merge_filters`` builds) answer
  as the JAX server's do: the same keys, times and diffs, match texts and
  metadata exact, distances within ``ATOL`` (tests/test_torch_vector_store
  .py's tolerance for this encoder).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import jmespath_lite as jjm
from pathway_tpu.internals.json import Json as JJson
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu.models.encoder import EncoderConfig as JConfig
from pathway_tpu.stdlib.indexing import \
    default_brute_force_knn_document_index as jdefault_index
from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder
from pathway_tpu.xpacks.llm.vector_store import \
    VectorStoreServer as JVectorStoreServer
from pathway_tpu_torch.internals import jmespath_lite as tjm
from pathway_tpu_torch.internals.json import Json as TJson
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner
from pathway_tpu_torch.models.encoder import EncoderConfig, init_params_host
from pathway_tpu_torch.stdlib.indexing import \
    default_brute_force_knn_document_index as tdefault_index
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder
from pathway_tpu_torch.xpacks.llm.vector_store import \
    VectorStoreServer as TVectorStoreServer

ATOL = 1e-4
DATA = [
    {"path": "docs/a/report.pdf", "modified_at": 1700000000, "owner": "ann",
     "tags": ["x", "y"], "meta": {"lang": "en", "pages": 12}},
    {"path": "docs/b/notes.txt", "modified_at": 1600000000, "owner": "bob",
     "tags": [], "meta": {"lang": "de", "pages": 3}},
    {"path": "top.md", "modified_at": 1.5, "owner": None, "meta": None},
    {},
    None,
]
EXPRESSIONS = [
    "owner == 'ann'", 'owner == "bob"', "owner != `ann`", "owner == `null`",
    "modified_at >= `1700000000`", "modified_at < 1650000000",
    "modified_at > -1", "modified_at <= 1.5", "meta.lang == 'en'",
    "meta.pages > `5` && meta.lang != 'de'", "!(meta.pages > `5`)",
    "owner == 'ann' || owner == 'bob'", "!owner", "(owner)",
    "contains(path, 'docs')", "contains(tags, 'x')", "contains(nope, 'x')",
    "globmatch('docs/**/*.pdf', path)", "globmatch('docs/*', path)",
    "globmatch('**', path)", "globmatch('*.md', path)",
    "globmatch('docs/?/notes.txt', path)",
    "contains(path, 'a') && (modified_at > `1` || !meta.lang)",
    "", "missing.deep.path == `1`",
]
MALFORMED = ["owner ==", "(owner == 'ann'", "owner == 'ann')", "@x", "&&",
             "contains(path 'x')", "owner = 'ann'", "1 2"]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_subset_evaluates_alike(expr):
    if expr:
        assert tjm.compile_filter(expr) == jjm.compile_filter(expr)
    for data in DATA:
        want = jjm.evaluate_filter(expr, data)
        assert tjm.evaluate_filter(expr, data) is want
        # a Json payload is unwrapped alike at every level
        assert tjm.evaluate_filter(expr, TJson(data)) is \
            jjm.evaluate_filter(expr, JJson(data))


@pytest.mark.parametrize("expr", MALFORMED)
def test_malformed_raises_the_same_type(expr):
    with pytest.raises(Exception) as jerr:
        jjm.compile_filter(expr)
    with pytest.raises(Exception) as terr:
        tjm.compile_filter(expr)
    assert type(terr.value) is type(jerr.value) is ValueError
    # the filter predicate itself fails closed on both
    assert tjm.evaluate_filter(expr, DATA[0]) is \
        jjm.evaluate_filter(expr, DATA[0]) is False


_paths = st.sampled_from(["owner", "modified_at", "meta.lang", "meta.pages",
                          "path", "tags", "nope"])
_literals = st.one_of(
    st.integers(-5, 1700000005).map(lambda v: f"`{v}`"),
    st.sampled_from(["'ann'", '"bob"', "`en`", "12", "-3", "1.5"]))
_atoms = st.one_of(
    st.tuples(_paths, st.sampled_from(["==", "!=", "<", "<=", ">", ">="]),
              _literals).map(" ".join),
    st.tuples(_paths, st.sampled_from(["'a'", "'x'", "'docs'"])).map(
        lambda t: f"contains({t[0]}, {t[1]})"),
    st.sampled_from(["'docs/**'", "'*.md'", "'docs/?/*'"]).map(
        lambda g: f"globmatch({g}, path)"),
    _paths)
_exprs = st.recursive(_atoms, lambda inner: st.one_of(
    st.tuples(inner, st.sampled_from(["&&", "||"]), inner).map(" ".join),
    inner.map(lambda e: f"!({e})"), inner.map(lambda e: f"({e})")),
    max_leaves=6)


@settings(max_examples=60, deadline=None)
@given(expr=_exprs, data=st.sampled_from(DATA))
def test_drawn_expressions_evaluate_alike(expr, data):
    assert tjm.compile_filter(expr) == jjm.compile_filter(expr)
    assert tjm.evaluate_filter(expr, data) is jjm.evaluate_filter(expr, data)


# ---------------------------------------------------------------------------
# filtered retrieves through VectorStoreServer, both packages
# ---------------------------------------------------------------------------

N_DOCS = 48
SIDES = {"jax": (jpw, JRunner, JVectorStoreServer, jdefault_index),
         "torch": (tpw, TRunner, TVectorStoreServer, tdefault_index)}


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def _docs():
    rng = np.random.default_rng(3)
    vocab = [f"word{i}" for i in range(256)]
    return [" ".join(vocab[j] for j in rng.integers(0, 256, size=m))
            for m in rng.integers(4, 30, size=N_DOCS)]


def _server(side: str, params):
    pw, _, Server, default_index = SIDES[side]
    if side == "jax":
        emb = JaxEncoderEmbedder(
            config=JConfig.tiny(compute_dtype=jnp.float32, pooling="mean"),
            params=params)
    else:
        emb = EncoderEmbedder(
            config=EncoderConfig.tiny(compute_dtype=torch.float32,
                                      pooling="mean"),
            params=params, device="cpu")
    rows = [(doc, pw.Json({"path": f"/dir{i % 3}/d{i}.txt",
                           "modified_at": 100 + i}), 2, 1)
            for i, doc in enumerate(_docs())]
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=str, _metadata=pw.Json), rows,
        is_stream=True)
    return pw, Server(docs, embedder=emb, index_builder=lambda chunks:
                      default_index(chunks.text, chunks, embedder=emb,
                                    dimensions=64, dtype="float32",
                                    metadata_column=chunks.metadata))


def test_filtered_retrieve_equals_reference():
    params = init_params_host(0, EncoderConfig.tiny())
    docs = _docs()
    spec = [(docs[4], 5, "modified_at >= `130`", None),
            (docs[30], 4, None, "/dir1/*"),
            (docs[7], 3, "modified_at < `120`", "**/d1*.txt"),
            (docs[9], 2, "contains(path, 'dir2')", None)]
    out = {}
    for side in SIDES:
        pw, store = _server(side, params)
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(query=str, k=int, metadata_filter=str | None,
                                 filepath_globpattern=str | None),
            [(*s, 4, 1) for s in spec], is_stream=True)
        _, Runner, _, _ = SIDES[side]
        runner = Runner()
        cap = runner.capture(store.retrieve_query(queries))
        runner.run_batch(n_workers=1)
        out[side] = sorted(((t, int(k), d, row[0].value)
                            for k, row, t, d in cap.events),
                           key=lambda e: e[:3])
    jev, tev = out["jax"], out["torch"]
    assert [e[:3] for e in tev] == [e[:3] for e in jev] and len(tev) == 4
    for (_, _, _, jrep), (_, _, _, trep) in zip(jev, tev):
        assert [(m["text"], m["metadata"]) for m in trep] == \
            [(m["text"], m["metadata"]) for m in jrep]
        np.testing.assert_allclose([m["dist"] for m in trep],
                                   [m["dist"] for m in jrep],
                                   rtol=0, atol=ATOL)
    # each query asks for its own k: a reply is known by its length
    replies = {len(rep): [m["metadata"] for m in rep] for *_, rep in tev}
    assert sorted(replies) == [2, 3, 4, 5]
    assert all(m["modified_at"] >= 130 for m in replies[5])
    assert all(m["path"].startswith("/dir1/") for m in replies[4])
    assert all(m["modified_at"] < 120 and "/d1" in m["path"]
               for m in replies[3])
    assert all("dir2" in m["path"] for m in replies[2])
