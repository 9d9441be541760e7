"""The port's ``pw.warmup`` (pathway_tpu_torch/warmup.py) against the JAX
package's on the same numpy weights: for a tiny config, padded (the bare
embedder, the fused ingest, the fused ingest with ``ks``) and ragged (bare
and fused into an int8 index), the ``compiled`` lists of (kind, shape)
entries are equal, the index holds no scratch key afterwards, both indexes
hand out the same slots, and the index still answers. Exact comparisons
throughout: lists, key maps and result keys. The JAX side runs with
``PATHWAY_AUTO_JIT=0``, and its auto-jit entries, which other tests'
programs can leave behind, are dropped before comparing."""

import numpy as np
import pytest

import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

MAX_LEN = 64
BATCH = 8
SCRATCH0 = 1 << 62


@pytest.fixture(autouse=True)
def _no_autojit(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.delenv("PATHWAY_DEVICE_SANITIZER", raising=False)


def _docs(n, start=0):
    return [f"doc{i} " + " ".join(f"w{(i * 5 + j) % 61}"
                                  for j in range(3 + i % 11))
            for i in range(start, start + n)]


def _pair(ragged: bool):
    from pathway_tpu.models import encoder as jenc
    from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder

    params = tenc.init_params_host(5, tenc.EncoderConfig.tiny())
    j = JaxEncoderEmbedder(config=jenc.EncoderConfig.tiny(), params=params,
                           ragged=ragged, max_len=MAX_LEN,
                           max_batch_size=BATCH)
    t = EncoderEmbedder(config=tenc.EncoderConfig.tiny(), params=params,
                        ragged=ragged, max_len=MAX_LEN,
                        max_batch_size=BATCH, device="cpu")
    return j, t


def _indexes(j, t, dtype: str, n_docs: int):
    from pathway_tpu.internals.keys import Pointer as JPointer
    from pathway_tpu.ops import knn as jknn

    jidx = jknn.DeviceEmbeddingKnnIndex(j, jknn.BruteForceKnnIndex(
        64, reserved_space=256, metric=jknn.KnnMetric.COS, dtype=dtype))
    tidx = tknn.DeviceEmbeddingKnnIndex(t, tknn.BruteForceKnnIndex(
        64, reserved_space=256, metric="cos", dtype=dtype, device="cpu"))
    if n_docs:
        docs = _docs(n_docs)
        jidx.add_batch([JPointer(i) for i in range(n_docs)], docs)
        tidx.add_batch([Pointer(i) for i in range(n_docs)], docs)
    return jidx, tidx


def _compiled(out):
    return [(kind, tuple(shape)) for kind, shape in out["compiled"]
            if kind != "autojit"]


def _warm_both(j, t, **kw):
    import pathway_tpu as jpw

    jkw = dict(kw)
    if "index" in kw:
        jkw["index"], kw["index"] = kw["index"]
    jout = jpw.warmup(j, cache=False, **jkw)
    tout = tpw.warmup(t, **kw)
    assert set(tout) == set(jout) == {"cache_dir", "compiled", "seconds"}
    assert tout["cache_dir"] is None
    return _compiled(jout), _compiled(tout)


def _key_values(keys) -> list[int]:
    return sorted(int(k) for k in keys)


@pytest.mark.parametrize("ragged", [False, True])
def test_bare_embedder_ladder_equals_jax(ragged):
    j, t = _pair(ragged)
    jc, tc = _warm_both(j, t)
    kind = "ragged_encode" if ragged else "encode"
    assert tc == jc
    assert {k for k, _ in tc} == {kind} and len(tc) == (
        len(t.ragged_buckets()) if ragged else len(t.bucket_widths()))


@pytest.mark.parametrize("ks,n_docs", [((), 0), ((), 12), ((3,), 12),
                                       ((3, 5), 12)])
def test_padded_fused_ladder_equals_jax(ks, n_docs):
    j, t = _pair(False)
    jidx, tidx = _indexes(j, t, "bfloat16", n_docs)
    jc, tc = _warm_both(j, t, index=(jidx, tidx), ks=ks)
    assert tc == jc
    kinds = ["fused_ingest"] + (["encode"] if ks else [])
    want = [(kind, (BATCH, w)) for w in t.bucket_widths() for kind in kinds]
    if n_docs:
        want += [("search", (k,)) for k in ks]
    assert tc == want
    # no scratch key left, and both packages hand out the same slots
    assert _key_values(tidx.inner._key_to_slot) == list(range(n_docs))
    assert {int(k): s for k, s in tidx.inner._key_to_slot.items()} == {
        int(k): s for k, s in jidx.inner._key_to_slot.items()}
    if n_docs:
        docs = _docs(n_docs)
        res = tidx.search([(Pointer(10 ** 6), docs[4], 3, None)])
        assert res[0][0][0] == Pointer(4)


@pytest.mark.parametrize("ks", [(), (3,)])
def test_ragged_fused_ladder_equals_jax(ks):
    j, t = _pair(True)
    jidx, tidx = _indexes(j, t, "int8", 12)
    jc, tc = _warm_both(j, t, index=(jidx, tidx), ks=ks)
    assert tc == jc
    W = MAX_LEN
    want = [e for b in t.ragged_buckets()
            for e in [("ragged_fused_ingest", (b, W))]
            + ([("ragged_encode", (b, W))] if ks else [])]
    want += [("search", (k,)) for k in ks]
    assert tc == want
    assert _key_values(tidx.inner._key_to_slot) == list(range(12))
    assert not any(int(k) >= SCRATCH0 for k in tidx.inner._key_to_slot)
    # the step's graphs would be captured on the card; here it runs eagerly
    assert tidx._fused.step.captures == 0


def test_index_alone_and_batch_size():
    """No embedder: an index warms its searches only; ``batch_size`` sets
    the ladder's rows."""
    import pathway_tpu as jpw
    from pathway_tpu.internals.keys import Pointer as JPointer
    from pathway_tpu.ops import knn as jknn

    vecs = np.random.default_rng(2).normal(size=(30, 16)).astype(np.float32)
    jidx = jknn.BruteForceKnnIndex(16, metric=jknn.KnnMetric.COS)
    tidx = tknn.BruteForceKnnIndex(16, metric="cos", device="cpu")
    jidx.add_batch([JPointer(i) for i in range(30)], vecs)
    tidx.add_batch([Pointer(i) for i in range(30)], vecs)
    jout = jpw.warmup(index=jidx, ks=(3, 7), cache=False)
    tout = tpw.warmup(index=tidx, ks=(3, 7))
    assert _compiled(tout) == _compiled(jout) == [("search", (3,)),
                                                  ("search", (7,))]
    assert len(tidx) == 30
    j, t = _pair(False)
    jc, tc = _warm_both(j, t, batch_size=4)
    assert tc == jc == [("encode", (4, w)) for w in t.bucket_widths()]


def test_no_persistent_compilation_cache():
    import importlib

    # the package's ``warmup`` attribute is the function, as in the JAX
    # package: the module is reached by its name
    twarm = importlib.import_module("pathway_tpu_torch.warmup")

    assert tpw.enable_compilation_cache() is None
    assert twarm.maybe_enable_compilation_cache() is None
    out = tpw.warmup()
    assert out["cache_dir"] is None and out["compiled"] == []
    assert twarm.WARMED_ENTRY_POINTS == frozenset({"encode_jit"})
