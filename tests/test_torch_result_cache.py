"""The port's semantic result cache (pathway_tpu_torch/engine/
result_cache.py, fed by ops/knn.py and used by engine/index_ops.py)
against the JAX package's.

- The unit cases of tests/test_result_cache.py (keying, the beat test, the
  page rules, LRU) run on both packages' ``ResultCache`` from the same
  inputs: every lookup decides alike and ``stats()`` ends equal.
- Its operator cases (the QoS one aside: QoS is not ported) run on the
  port's as-of-now operator and on the JAX operator at its default, the
  cache on: the same deltas, keys exact and distances within ``TOL``.
- A hypothesis property drives seeded insert / delete / grow churn with a
  Zipf query stream through both layouts and two dtypes: the port with its
  cache on emits byte for byte what it emits with it off, and the JAX
  package's cache-on run's keys, with distances within ``TOL`` (the
  tolerances of tests/test_torch_knn.py: f32 sums in another order; bf16
  scores of the same bf16-rounded rows).
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pathway_tpu.engine import result_cache as jrc
from pathway_tpu.engine.delta import Delta as JDelta
from pathway_tpu.engine.index_ops import ExternalIndexOperator as JOp
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.engine import result_cache as trc
from pathway_tpu_torch.engine.delta import Delta as TDelta
from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator as TOp
from pathway_tpu_torch.ops import knn as tknn

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-3, atol=1e-3)}
SIDES = {"jax": (jknn, JOp, JDelta), "torch": (tknn, TOp, TDelta)}


# ---------------------------------------------------------------------------
# unit: the same decisions on both packages' ResultCache
# ---------------------------------------------------------------------------

def _far_near(rc):
    cache = rc.ResultCache(page_rows=8, metric="l2sq")
    q = np.zeros(4, np.float32)
    fp = rc.fingerprint(q, 2)
    cache.fill(fp, ((b"a", 1.0), (b"b", 2.0)), frozenset({0, 1}), 2.0, q)
    cache.on_insert_batch(np.array([3]), [b"z"],
                          np.full((1, 4), 100.0, np.float32))
    out = [cache.lookup(fp)]
    cache.on_insert_batch(np.array([4]), [b"y"], np.zeros((1, 4), np.float32))
    return out + [cache.lookup(fp)], cache


def _uncovered(rc):
    cache = rc.ResultCache(page_rows=8, metric="l2sq")
    q = np.zeros(4, np.float32)
    fp = rc.fingerprint(q, 1)
    cache.fill(fp, ((b"a", 1.0),), frozenset({0}), 1.0, q)
    cache.on_insert_batch(np.array([80]), [b"far"],
                          np.full((1, 4), 50.0, np.float32))
    return [cache.lookup(fp)], cache


def _short_reply(rc):
    cache = rc.ResultCache(page_rows=8, metric="l2sq")
    q = np.zeros(4, np.float32)
    fp = rc.fingerprint(q, 5)
    cache.fill(fp, ((b"a", 1.0),), frozenset({0}), None, q)
    cache.on_insert_batch(np.array([1]), [b"b"],
                          np.full((1, 4), 99.0, np.float32))
    return [cache.lookup(fp)], cache


def _reinsert(rc):
    cache = rc.ResultCache(page_rows=8, metric="l2sq")
    q = np.zeros(4, np.float32)
    fp = rc.fingerprint(q, 1)
    cache.fill(fp, ((b"a", 1.0),), frozenset({0}), 1.0, q)
    cache.on_insert_batch(np.array([2]), [b"a"],
                          np.full((1, 4), 70.0, np.float32))
    return [cache.lookup(fp)], cache


def _delete(rc):
    cache = rc.ResultCache(page_rows=8, metric="l2sq")
    q = np.zeros(4, np.float32)
    fp = rc.fingerprint(q, 1)
    cache.fill(fp, ((b"a", 1.0),), frozenset({0, 1}), 1.0, q)
    cache.on_delete(80, b"other")
    out = [cache.lookup(fp)]
    cache.on_delete(9, b"other")
    return out + [cache.lookup(fp)], cache


def _lru(rc):
    cache = rc.ResultCache(page_rows=8, metric="l2sq", max_entries=4)
    fps = []
    for i in range(10):
        q = np.full(4, float(i), np.float32)
        fps.append(rc.fingerprint(q, 1))
        cache.fill(fps[-1], ((b"k", 0.0),), frozenset({0}), 0.0, q)
    return [cache.lookup(fp) for fp in fps], cache


def _cosine(rc):
    cache = rc.ResultCache(page_rows=8, metric="cos")
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    fp = rc.fingerprint(q, 2)
    cache.fill(fp, ((b"a", 0.1), (b"b", 0.5)), frozenset({0}), 0.5, q)
    cache.on_insert_batch(np.array([1]), [b"c"],
                          np.array([[0.0, 1.0, 0.0, 0.0]], np.float32))
    out = [cache.lookup(fp)]
    cache.on_insert_batch(np.array([2]), [b"d"],
                          np.array([[2.0, 0.0, 0.0, 0.0]], np.float32))
    return out + [cache.lookup(fp)], cache


def _ticks(rc):
    cache = rc.ResultCache(page_rows=8, metric="l2sq")
    q = np.zeros(4, np.float32)
    cache.fill(rc.fingerprint(q, 1), ((b"a", 1.0),), frozenset({0}), 1.0, q)
    cache.note_data_tick()
    cache.invalidate_all()
    cache.note_commit_tick()
    cache.note_commit_tick()
    return [cache.lookup(rc.fingerprint(q, 1))], cache


@pytest.mark.parametrize("case", [_far_near, _uncovered, _short_reply,
                                  _reinsert, _delete, _lru, _cosine, _ticks])
def test_unit_cases_decide_alike(case):
    jout, jcache = case(jrc)
    tout, tcache = case(trc)
    assert tout == jout
    assert tcache.stats() == jcache.stats()


def test_fingerprint_is_the_jax_packages():
    v = np.arange(4, dtype=np.float32)
    w = v.copy()
    w[0] += 1e-6
    for vec, k in ((v, 3), (v, 4), (w, 3)):
        assert trc.fingerprint(vec, k) == jrc.fingerprint(vec, k)
    assert trc.fingerprint(v, 3) != trc.fingerprint(w, 3)


def test_env_knob_and_live_stats(monkeypatch):
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    assert trc.result_cache_enabled() is jrc.result_cache_enabled() is False
    assert tknn.BruteForceKnnIndex(4, device="cpu").result_cache is None
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "1")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE_ENTRIES", "7")
    held = []
    for paged in (True, False):
        t = tknn.BruteForceKnnIndex(4, device="cpu", paged=paged,
                                    dtype="bfloat16")
        held.append(t)
        j = jknn.BruteForceKnnIndex(4, paged=paged, dtype="bfloat16")
        for attr in ("page_rows", "metric", "beat_test", "max_entries"):
            assert getattr(t.result_cache, attr) == \
                getattr(j.result_cache, attr)
        assert t.result_cache.beat_test is False
    assert trc.live_cache_stats()["caches"] >= 2


# ---------------------------------------------------------------------------
# operator cases: the port's operator vs the JAX operator, cache on
# ---------------------------------------------------------------------------

class Both:
    """One as-of-now operator over a fresh index in each package."""

    def __init__(self, dim=4, reserved_space=64, filters=False, **kw):
        self.ops = {}
        for side, (knn, Op, _) in SIDES.items():
            extra = {"device": "cpu"} if side == "torch" else {}
            idx = knn.BruteForceKnnIndex(dim, reserved_space=reserved_space,
                                         **kw, **extra)
            self.ops[side] = Op(idx, data_vec_pos=0,
                                data_filter_pos=1 if filters else None,
                                query_vec_pos=0, query_limit_pos=1,
                                query_filter_pos=2 if filters else None)

    def index(self, side):
        return self.ops[side].index

    def step(self, t, data=(), queries=(), dtype="float32"):
        """Both packages' output deltas, compared; returns the port's as
        sorted (query key, ((match key, distance), ...), diff)."""
        outs = {}
        for side, op in self.ops.items():
            Delta = SIDES[side][2]
            delta = op.step(t, [Delta(list(data)), Delta(list(queries))])
            outs[side] = sorted(
                (int(k), tuple((int(mk), d) for mk, d in row[0]), diff)
                for k, row, diff in delta.entries)
        same_output(outs["jax"], outs["torch"], dtype)
        return outs["torch"]


def same_output(ref, got, dtype):
    assert len(got) == len(ref)
    for (rk, rrep, rd), (gk, grep, gd) in zip(ref, got):
        assert (gk, gd) == (rk, rd)
        assert [m for m, _ in grep] == [m for m, _ in rrep]
        np.testing.assert_allclose([d for _, d in grep],
                                   [d for _, d in rrep], **TOL[dtype])


@pytest.fixture(autouse=True)
def _cache_on(monkeypatch):
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "1")


def test_covering_delta_invalidates_before_next_serve():
    b = Both()
    rng = np.random.default_rng(7)
    base = rng.normal(size=(20, 4)).astype(np.float32) + 10.0
    b.step(0, data=[(i, (base[i],), 1) for i in range(20)])
    q = np.zeros(4, np.float32)
    out1 = b.step(1, queries=[(100, (q, 2), 1)])
    out2 = b.step(2, queries=[(101, (q, 2), 1)])
    for side in SIDES:
        st_ = b.index(side).result_cache.stats()
        assert st_["hits"] == 1 and st_["entries"] == 1
    b.step(3, data=[(999, (q.copy(),), 1)])
    for side in SIDES:
        assert b.index(side).result_cache.stats()["entries"] == 0
    out3 = b.step(4, queries=[(102, (q, 2), 1)])
    assert out3[0][1][0][0] == 999
    assert out1[0][1] == out2[0][1] != out3[0][1]


def test_delete_of_served_row_invalidates_before_next_serve():
    b = Both()
    vecs = np.eye(4, dtype=np.float32)
    b.step(0, data=[(i, (vecs[i],), 1) for i in range(4)])
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    assert b.step(1, queries=[(100, (q, 1), 1)])[0][1][0][0] == 0
    b.step(2, data=[(0, (vecs[0],), -1)])
    assert b.step(3, queries=[(101, (q, 1), 1)])[0][1][0][0] != 0


def test_duplicate_queries_in_one_tick_share_one_miss():
    b = Both()
    b.step(0, data=[(i, (np.full(4, float(i), np.float32),), 1)
                    for i in range(8)])
    q = np.ones(4, np.float32)
    out = b.step(1, queries=[(100, (q, 2), 1), (101, (q, 2), 1),
                             (102, (q, 2), 1)])
    assert out[0][1] == out[1][1] == out[2][1]
    for side in SIDES:
        assert b.index(side).result_cache.fills == 1


def test_data_tick_bumps_version_once():
    b = Both(reserved_space=16)
    v0 = {s: b.index(s).result_cache.version for s in SIDES}
    b.step(0, data=[(0, (np.zeros(4, np.float32),), 1)])
    b.step(1, queries=[(100, (np.zeros(4, np.float32), 1), 1)])
    for side in SIDES:
        assert b.index(side).result_cache.version == v0[side] + 1
    assert trc.live_cache_stats()["version"] >= 1


def test_filtered_queries_bypass_the_cache():
    b = Both(reserved_space=16, filters=True)
    b.step(0, data=[(i, (np.full(4, float(i), np.float32), {"x": "x"}), 1)
                    for i in range(4)])
    q = np.zeros(4, np.float32)
    b.step(1, queries=[(100, (q, 2, "x == `x`"), 1)])
    out = b.step(2, queries=[(101, (q, 2, "x == `x`"), 1)])
    assert [m for m, _ in out[0][1]] == [0, 1]
    for side in SIDES:
        st_ = b.index(side).result_cache.stats()
        assert st_["hits"] == 0 and st_["entries"] == 0


# ---------------------------------------------------------------------------
# property: cache on == cache off, byte for byte, under churn
# ---------------------------------------------------------------------------

def _churn(side, seed, dtype, paged, cache_on, monkeypatch):
    """The outputs of 24 ticks of seeded churn, and the cache's statistics:
    80-159 inserted rows every even tick (past the first 1,024 rows, so the
    store grows), one deletion and one upsert every third tick, and each
    tick 1-4 queries, k = 3: the pool's head vector, then Zipf(1.3) draws
    from the 24-vector pool. The ticks with no data serve hits."""
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "1" if cache_on else "0")
    knn, Op, Delta = SIDES[side]
    extra = {"device": "cpu"} if side == "torch" else {}
    idx = knn.BruteForceKnnIndex(6, reserved_space=32, dtype=dtype,
                                 paged=paged, **extra)
    op = Op(idx, data_vec_pos=0, data_filter_pos=None, query_vec_pos=0,
            query_limit_pos=1, query_filter_pos=None)
    rng = np.random.default_rng(seed)
    qpool = rng.normal(size=(24, 6)).astype(np.float32)
    live, next_key, next_q, outputs = [], 0, 10_000, []
    for t in range(24):
        data = []
        for _ in range(int(rng.integers(80, 160)) if t % 2 == 0 else 0):
            vec = rng.normal(size=6).astype(np.float32)
            data.append((next_key, (vec,), 1))
            live.append((next_key, vec))
            next_key += 1
        if t % 3 == 0 and t:
            key, vec = live.pop(int(rng.integers(0, len(live))))
            data.append((key, (vec,), -1))
            key, _ = live[int(rng.integers(0, len(live)))]
            data.append((key, (rng.normal(size=6).astype(np.float32),), 1))
        queries = [(next_q, (qpool[0], 3), 1)]
        for i in range(int(rng.integers(0, 4))):
            qi = min(int(rng.zipf(1.3)) - 1, len(qpool) - 1)
            queries.append((next_q + 1 + i, (qpool[qi], 3), 1))
        next_q += len(queries)
        delta = op.step(t, [Delta(data), Delta(queries)])
        outputs.append(sorted(
            (int(k), tuple((int(mk), d) for mk, d in row[0]), diff)
            for k, row, diff in delta.entries))
    stats = idx.result_cache.stats() if cache_on else None
    return outputs, stats, idx.capacity


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**16), dtype=st.sampled_from(
    ["float32", "bfloat16"]), paged=st.booleans())
def test_property_cache_on_byte_identical_to_cache_off(seed, dtype, paged):
    with pytest.MonkeyPatch.context() as mp:
        on, st_on, cap = _churn("torch", seed, dtype, paged, True, mp)
        off, _, _ = _churn("torch", seed, dtype, paged, False, mp)
        jon, jst, jcap = _churn("jax", seed, dtype, paged, True, mp)
    assert on == off
    assert cap == jcap > 1024
    for ref, got in zip(jon, on):
        same_output(ref, got, dtype)
    assert st_on["hits"] > 0 and st_on["invalidations"] > 0
    assert st_on == jst
