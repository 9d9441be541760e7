"""The int8 fused-ingest step of the ragged path (ops/knn.py
``GraphedIngestStep``: pinned staging, one CUDA graph per chunk shape and
extent) and K4's body (ops/csrc/knn_i8.cu).

On the CPU the step stages its arrays and runs its body eagerly, with the
plain versions inside; it is held exactly against the JAX package's ragged
fused ingest (``step_i8``, one donated dispatch per chunk) and against the
port's eager per-chunk path: slots, int8 codes, scales, ``vsq``, validity,
the host bookkeeping and the top-k order. To compare codes bit for bit
across the two packages both index the same producer, a gather of a numpy
table by each document's first token (exact in both); the encoder's own
agreement with JAX is tests/test_torch_ragged.py's. A fake graph checks the
step's graph keys and counts. The tests marked ``cuda`` run only on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_ingest_step.py

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests also run where JAX is not installed. Tolerances: everything
is exact except search distances against JAX (rtol = atol = 1e-5: the same
f32 products summed in another order) and, on the card, the embeddings a
graph wrote against the eager ragged forward (row cosine >= 0.999, the
ragged path's tolerance, through the int8 codes)."""

import numpy as np
import pytest
import torch

from pathway_tpu_torch._device import PinnedStaging
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.ops import knn as tknn
from pathway_tpu_torch.ops.knn_kernels import (QUANTIZE_SCATTER,
                                               quantize_scatter,
                                               quantize_scatter_reference)
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

VOCAB = 30522  # BGE's: few first-token collisions among the test texts
TOL = dict(rtol=1e-5, atol=1e-5)


def _texts(n, start=0, tag="a"):
    """Documents of 3 to ~30 words whose first word is unique."""
    return [f"first{i}{tag} " + " ".join(f"w{(i * 7 + j) % 97}"
                                         for j in range(2 + i % 29))
            for i in range(start, start + n)]


def _table(dim=64, seed=4):
    return np.random.default_rng(seed).normal(
        size=(VOCAB, dim)).astype(np.float32)


class _TGather(EncoderEmbedder):
    """The port's ragged embedder whose device half is a gather: row =
    table[first token of the document] (exact on every backend)."""

    def __init__(self, table, **kw):
        cfg = tenc.EncoderConfig.tiny(vocab_size=VOCAB)
        super().__init__(config=cfg, ragged=True, max_len=64, **kw)
        self.table = torch.from_numpy(table).to(self.device)

    def ragged_device_forward(self, model, ids, doc_map, pos_ids, doc_seq,
                              doc_off):
        self.dispatches += 1
        return self.table[ids[doc_seq.long(), doc_off.long() + 1].long()]


def _jax_gather_embedder(table):
    """The same producer on the JAX package's ragged embedder."""
    import jax.numpy as jnp

    from pathway_tpu.models import encoder as jenc
    from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder

    class JGather(JaxEncoderEmbedder):
        def ragged_device_producer(self, params, ids, doc_map, pos_ids,
                                   doc_seq, doc_off):
            return params[ids[doc_seq, doc_off + 1]]

        def encode_batch_device(self, texts):
            outs = [self.ragged_device_producer(
                self.params, *(jnp.asarray(a) for a in args))[:n]
                for args, n, _ in self.pack_ragged(texts)]
            return jnp.concatenate(outs, axis=0)

    cfg = jenc.EncoderConfig.tiny(vocab_size=VOCAB)
    j = JGather(config=cfg, params=tenc.init_params_host(
        0, tenc.EncoderConfig.tiny(vocab_size=VOCAB)), ragged=True,
        max_len=64)
    j.params = jnp.asarray(table)
    return j


def _pair(table, **kw):
    """(JAX index, port index), int8 cos, each behind the gather embedder."""
    from pathway_tpu.ops import knn as jknn

    j = jknn.DeviceEmbeddingKnnIndex(
        _jax_gather_embedder(table), jknn.BruteForceKnnIndex(
            table.shape[1], metric=jknn.KnnMetric.COS, dtype="int8",
            paged=True, **kw))
    t = tknn.DeviceEmbeddingKnnIndex(
        _TGather(table, device="cpu"), tknn.BruteForceKnnIndex(
            table.shape[1], metric="cos", dtype="int8", device="cpu", **kw))
    return j, t


def _add(idx, pointer, keys, texts):
    idx.add_batch([pointer(k) for k in keys], texts)


def _same_state(a, b, b_numpy=False):
    """Slots, extents (codes, scales, vsq, validity) bit for bit, and the
    host bookkeeping (``_host_valid``, ``_stale``, ``_dirty``)."""
    assert {int(k): s for k, s in a._key_to_slot.items()} == \
        {int(k): s for k, s in b._key_to_slot.items()}
    assert [(e.base, e.rows, e.established) for e in a._pool.extents] == \
        [(e.base, e.rows, e.established) for e in b._pool.extents]
    for ea, eb in zip(a._pool.extents, b._pool.extents):
        if not ea.established:
            continue
        for name in ("vectors", "scales", "vsq", "valid"):
            want = getattr(eb, name)
            want = np.asarray(want) if b_numpy else want.cpu().numpy()
            np.testing.assert_array_equal(getattr(ea, name).cpu().numpy(),
                                          want, err_msg=name)
    np.testing.assert_array_equal(np.asarray(a._host_valid),
                                  np.asarray(b._host_valid))
    assert a._stale == b._stale and a._dirty == b._dirty


def _same_results(ra, rb):
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert [int(k) for k, _ in x] == [int(k) for k, _ in y]
        np.testing.assert_allclose([d for _, d in x], [d for _, d in y],
                                   **TOL)


# batches that grow the index to a second extent and update rows already
# written in both: (keys, texts)
_BATCHES = [
    (range(0, 600), _texts(600)),
    (range(600, 1200), _texts(600, 600)),
    (list(range(0, 100)) + list(range(1200, 1300)),
     _texts(100, tag="b") + _texts(100, 1200)),
    (range(700, 760), _texts(60, 700, tag="c")),
]
# batches of which no chunk falls back to the two-step path: every chunk is
# one step
_STEPPED = _BATCHES[:2] + [(range(0, 100), _texts(100, tag="b"))]


def test_staged_step_matches_jax_ragged_fused_ingest():
    """The staged int8 step against the JAX package's ragged fused ingest,
    over batches that grow a second extent and rewrite keys in both: the
    same slots, codes, scales, vsq, validity and bookkeeping, bit for bit,
    and the same top-k order."""
    from pathway_tpu.internals.keys import Pointer as JPointer

    table = _table()
    j, t = _pair(table)
    assert isinstance(t._fused.step, tknn.GraphedIngestStep)
    for keys, texts in _BATCHES:
        _add(j, JPointer, keys, texts)
        _add(t, Pointer, keys, texts)
        _same_state(t.inner, j.inner, b_numpy=True)
    assert t.inner.page_stats()["extents"] == 2
    q = table[[5, 77, 901, 4000]] + 0.1
    _same_results(
        t.inner.search([(Pointer(10**9 + i), v, 10, None)
                        for i, v in enumerate(q)]),
        j.inner.search([(JPointer(10**9 + i), v, 10, None)
                        for i, v in enumerate(q)]))


def _encoder_pair():
    """Two port embedders over the same tiny encoder weights."""
    cfg = tenc.EncoderConfig.tiny(compute_dtype=torch.float32)
    params = tenc.init_params_host(3, cfg)
    return [EncoderEmbedder(config=cfg, params=params, ragged=True,
                            max_len=64, device="cpu") for _ in range(2)]


def test_staged_step_matches_eager_per_chunk_path():
    """The staged step (through the encoder) against the eager per-chunk
    path (``make_fused_ingest`` of ``ragged_device_producer``) and against
    the step's own eager body: identical state and results."""
    a_emb, b_emb = _encoder_pair()
    idx = [tknn.DeviceEmbeddingKnnIndex(e, tknn.BruteForceKnnIndex(
        64, metric="cos", dtype="int8", device="cpu")) for e in (a_emb,
                                                                 b_emb)]
    idx[1]._fused = idx[1].inner.make_fused_ingest(
        b_emb.ragged_device_producer)
    c_emb = _encoder_pair()[0]
    c_inner = tknn.BruteForceKnnIndex(64, metric="cos", dtype="int8",
                                      device="cpu")
    c = tknn.DeviceEmbeddingKnnIndex(c_emb, c_inner)
    c._fused = c_inner._ingest_fn(c._fused.step.eager)
    idx.append(c)
    for keys, texts in _BATCHES:
        for x in idx:
            _add(x, Pointer, keys, texts)
        for x in idx[1:]:
            _same_state(x.inner, idx[0].inner)
    assert a_emb.dispatches == b_emb.dispatches == c_emb.dispatches > 0
    queries = [(Pointer(10**9 + i), q, 8, None)
               for i, q in enumerate(_texts(3, 40) + ["never ingested"])]
    res = [x.search(queries) for x in idx]
    for r in res[1:]:
        _same_results(r, res[0])


def test_batch_spanning_extents_takes_the_two_step_path():
    """A ragged batch whose second chunk updates rows in two extents: the
    first chunk is written by the step, then the batch falls back to the
    two-step path and ends in the JAX package's state."""
    from pathway_tpu.internals.keys import Pointer as JPointer

    table = _table(seed=9)
    j, t = _pair(table)
    for keys, texts in _BATCHES[:2]:
        _add(j, JPointer, keys, texts)
        _add(t, Pointer, keys, texts)
    chunks = t.embedder.pack_ragged(_texts(40, 2000) + ["x a", "y b"])
    assert len(chunks) == 2 and chunks[0][1] < 40  # the last chunk spans
    keys = list(range(2000, 2040)) + [5, 1100]
    texts = _texts(40, 2000) + ["upd five", "upd eleven hundred"]
    steps = t._fused.step.replays, t.embedder.dispatches
    _add(j, JPointer, keys, texts)
    _add(t, Pointer, keys, texts)
    assert t.embedder.dispatches - steps[1] == 1 + 2  # fused + fallback
    _same_state(t.inner, j.inner, b_numpy=True)
    assert t.inner._key_to_slot[Pointer(5)] < 1024 <= \
        t.inner._key_to_slot[Pointer(1100)]
    assert len(t) == len(j) == 1240


class _FakeEvent:
    """A CUDA event stand-in: ``record`` notes the staging buffers' bytes,
    ``synchronize`` checks that nobody rewrote them before it (the copy
    would still be reading them) and marks the copy done."""

    log = []

    def __init__(self):
        self.snapshot = None
        self.done = False

    def record(self):
        self.snapshot = [h.clone() for h in _FakeEvent.current]
        self.buffers = list(_FakeEvent.current)
        _FakeEvent.log.append(("record", id(self)))

    def synchronize(self):
        for h, s in zip(self.buffers, self.snapshot):
            assert torch.equal(h, s), "staging rewritten before its copy"
        self.done = True
        _FakeEvent.log.append(("sync", id(self)))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pinned_staging_waits_for_the_copy_before_a_rewrite(depth,
                                                            monkeypatch):
    """Each host buffer set is rewritten only after the event recorded
    behind its last copy has been waited on, and every upload lands in the
    same device tensors."""
    _FakeEvent.log = []
    st = PinnedStaging(torch.device("cpu"), depth=depth, event=_FakeEvent)
    new_set = st._new_set

    def tracked(arrays):
        s = new_set(arrays)
        orig = s[0]

        class Sets(list):
            def __getitem__(self, i):
                _FakeEvent.current = orig[i]
                return orig[i]

        s[0] = Sets(orig)
        return s

    monkeypatch.setattr(st, "_new_set", tracked)
    rng = np.random.default_rng(0)
    outs, events = [], []
    for n in range(7):
        a = rng.integers(0, 100, (3, 5)).astype(np.int32)
        b = rng.integers(0, 100, (4,)).astype(np.int64)
        dev = st.upload((a, b))
        outs.append(dev)
        np.testing.assert_array_equal(dev[0].numpy(), a)
        np.testing.assert_array_equal(dev[1].numpy(), b)
        events.append(st._sets[next(iter(st._sets))][1][n % depth])
    assert all(o[0] is outs[0][0] for o in outs)
    # upload n waits on upload n - depth's event, before anything else
    for n in range(depth, 7):
        assert events[n - depth].done
    for n in range(7 - depth, 7):
        assert not events[n].done
    syncs = [e for e in _FakeEvent.log if e[0] == "sync"]
    assert len(syncs) == 7 - depth


class _FakeGraphStep(tknn.GraphedIngestStep):
    """The step with the graph machinery replaced by eager calls: a
    "capture" runs the body once (its counts are what a replay adds) and a
    "replay" runs it again with every count frozen, so only the step's
    own bookkeeping counts."""

    @staticmethod
    def _graphed(dev):
        return True

    @staticmethod
    def _warm(body, device):
        body()

    def _record(self, body):
        step = self

        class Graph:
            replays = 0

            def replay(self):
                frozen = step._counts()
                body()
                for obj, attr, v in frozen.values():
                    setattr(obj, attr, v)
                Graph.replays += 1

        body()
        return Graph()


def test_graph_keys_counts_and_new_extent():
    """One capture per (chunk shape, extent): a second extent gets graphs of
    its own; every chunk is one replay; the warm-up and the capture count
    no dispatch; the state equals the eager path's."""
    a_emb, b_emb = _encoder_pair()
    inner = tknn.BruteForceKnnIndex(64, metric="cos", dtype="int8",
                                    device="cpu")
    idx = tknn.DeviceEmbeddingKnnIndex(a_emb, inner)
    step = _FakeGraphStep(a_emb.ragged_device_forward, inner.device,
                          ((a_emb, "dispatches"),))
    idx._fused = inner._ingest_fn(step)
    ref = tknn.DeviceEmbeddingKnnIndex(b_emb, tknn.BruteForceKnnIndex(
        64, metric="cos", dtype="int8", device="cpu"))
    chunks, keys_seen = 0, set()
    for keys, texts in _STEPPED:
        chunks += len(a_emb.pack_ragged(texts))
        _add(idx, Pointer, keys, texts)
        _add(ref, Pointer, keys, texts)
        keys_seen |= set(step.graphs)
    _same_state(inner, ref.inner)
    assert step.replays == chunks == a_emb.dispatches
    assert step.captures == len(step.graphs) == len(keys_seen)
    buckets = {k[0] for k in step.graphs}
    extents = {k[3] for k in step.graphs}
    assert len(extents) == 2 == inner.page_stats()["extents"]
    assert extents == {e.vectors.data_ptr() for e in inner._pool.extents}
    assert step.captures <= len(buckets) * len(extents)
    # each graph records one dispatch per replay, nothing else on the CPU
    assert all(adds == [(a_emb, "dispatches", 1)]
               for _, adds in step.graphs.values())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 and the CUDA graphs run only "
                    "there")
    return torch.device("cuda")


def _k4_rows(n, dim, seed):
    """Normal rows and the quantizer's edge cases: a zero row, a row whose
    max is reached at +m and -m, a row of exact halves (v / scale = k + 0.5:
    round half to even), a row whose max is negative, tiny values."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, dim)).astype(np.float32)
    v[0] = 0.0
    v[1, 0], v[1, dim // 2] = 3.5, -3.5
    s = np.float32(2.0 ** -3)
    m = min(dim - 1, 40)
    v[2] = 0.0
    v[2, 0] = 127 * s
    v[2, 1:1 + m] = (np.arange(m) % 20 + 0.5) * s * np.where(
        np.arange(m) % 2, -1, 1)
    v[3] *= -1e-3
    v[3, 0] = -5.0
    v[4] *= 1e-30
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 100, 384])
@pytest.mark.parametrize("pad", [0, 4, 1])  # row stride dim + pad
@pytest.mark.parametrize("with_valid", [False, True])
def test_k4_body_bit_identical_on_card(dim, pad, with_valid):
    """K4 (vector body at strides that keep rows 16-byte aligned, scalar
    body at dim + 1) against ``quantize_scatter_reference``: codes, scales,
    vsq and validity equal; sentinel and untouched rows unchanged."""
    dev = _card()
    n, R = 300, 512
    full = np.zeros((n, dim + pad), np.float32)
    full[:, :dim] = _k4_rows(n, dim, seed=dim + pad)
    rows = torch.from_numpy(full).to(dev)[:, :dim]
    gen = torch.Generator(device=dev).manual_seed(dim)
    slots = torch.randperm(R, generator=gen, device=dev)[:n]
    slots[5::7] = R + 3  # sentinels
    slots[6::11] = -1
    vv = (torch.rand(n, generator=gen, device=dev) > 0.2) if with_valid \
        else None
    init = (torch.full((R, dim), 7, dtype=torch.int8, device=dev),
            torch.full((R,), 3.0, device=dev),
            torch.full((R,), 5.0, device=dev),
            torch.zeros((R,), dtype=torch.bool, device=dev))
    before = QUANTIZE_SCATTER.launches
    outs = []
    for fn in (quantize_scatter, quantize_scatter_reference):
        bufs = tuple(t.clone() for t in init)
        fn(rows, slots, vv, *bufs)
        outs.append(bufs)
    torch.cuda.synchronize()
    assert QUANTIZE_SCATTER.launches == before + 1
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    hit[slots[(slots >= 0) & (slots < R)]] = True
    for a, b in zip(outs[0], init):
        assert torch.equal(a[~hit], b[~hit])


def _card_embedders(dev):
    cfg = tenc.EncoderConfig.tiny()  # bf16, as BGE-small runs
    params = tenc.init_params_host(5, cfg)
    return [EncoderEmbedder(config=cfg, params=params, ragged=True,
                            max_len=64, device=dev) for _ in range(2)]


@pytest.mark.cuda
def test_graph_replay_equals_eager_step_on_card():
    """Every chunk a replay of a captured graph (K1 with segment ids, K4):
    the index equals, bit for bit, the one the eager body builds; K1 and
    K4 count one launch per layer and chunk; the rows decode close to the
    eager ragged forward."""
    from pathway_tpu_torch.ops.attention import ATTENTION

    dev = _card()
    g_emb, e_emb = _card_embedders(dev)
    g = tknn.DeviceEmbeddingKnnIndex(g_emb, tknn.BruteForceKnnIndex(
        64, metric="cos", dtype="int8", device=dev))
    e_inner = tknn.BruteForceKnnIndex(64, metric="cos", dtype="int8",
                                      device=dev)
    e = tknn.DeviceEmbeddingKnnIndex(e_emb, e_inner)
    e._fused = e_inner._ingest_fn(e._fused.step.eager)
    step = g._fused.step
    k1, k4 = ATTENTION.launches, QUANTIZE_SCATTER.launches
    chunks = 0
    for keys, texts in _STEPPED:
        chunks += len(g_emb.pack_ragged(texts))
        _add(g, Pointer, keys, texts)
    torch.cuda.synchronize()
    assert step.replays == chunks == g_emb.dispatches
    assert ATTENTION.launches - k1 == g_emb.config.layers * chunks
    assert QUANTIZE_SCATTER.launches - k4 == chunks
    for keys, texts in _STEPPED:
        _add(e, Pointer, keys, texts)
    torch.cuda.synchronize()
    _same_state(g.inner, e_inner)
    texts = _texts(16)
    g.inner._sync_mirror()
    got = np.stack([g.inner._host_vectors[g.inner._key_to_slot[Pointer(i)]]
                    .numpy() for i in range(16)]).astype(np.float64)
    want = e_emb.embed_batch(texts).astype(np.float64)
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1)
                                   * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999


@pytest.mark.cuda
def test_new_extent_captures_a_new_graph_on_card():
    """A chunk written into a second extent captures a graph of its own
    and does not replay the first extent's."""
    dev = _card()
    emb = _card_embedders(dev)[0]
    idx = tknn.DeviceEmbeddingKnnIndex(emb, tknn.BruteForceKnnIndex(
        64, metric="cos", dtype="int8", device=dev))
    step = idx._fused.step
    _add(idx, Pointer, *_BATCHES[0])
    first = dict(step.graphs)
    assert {k[3] for k in first} == {idx.inner._pool.extents[0]
                                     .vectors.data_ptr()}
    _add(idx, Pointer, *_BATCHES[1])
    torch.cuda.synchronize()
    assert idx.inner.page_stats()["extents"] == 2
    second = {k: v for k, v in step.graphs.items() if k not in first}
    assert second and {k[3] for k in second} == {
        idx.inner._pool.extents[1].vectors.data_ptr()}
    assert step.captures == len(step.graphs)
    assert idx.inner._pool.extents[1].valid.any()
