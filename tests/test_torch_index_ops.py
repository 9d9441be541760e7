"""The port's ``ExternalIndexOperator`` (engine/index_ops.py) against the
JAX package's, each over its own float32 ``BruteForceKnnIndex`` fed the
same seeded vectors, stepped tick by tick with the same data and query
deltas: adds and removals within and across ticks, as-of-now answers that
are never revised, ``revise=True`` re-answers, query retraction and
update, a None-vector query (an empty reply) and k larger than the index.

Checked per tick: the emitted (query key, diff) events and, in each reply,
the match keys and their ranks exactly; scores within ``rtol=atol=1e-5``
(float32 products summed in a different order on each side). The JAX index
runs with ``PATHWAY_RESULT_CACHE=0`` (its semantic result cache, which the
port does not have), and once with the cache on, which the JAX package
states gives the same replies.
"""

import numpy as np
import pytest

from pathway_tpu.engine import delta as jdelta
from pathway_tpu.engine import index_ops as jindex_ops
from pathway_tpu.internals import keys as jkeys
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.engine import delta as tdelta
from pathway_tpu_torch.engine import index_ops as tindex_ops
from pathway_tpu_torch.internals import keys as tkeys
from pathway_tpu_torch.ops import knn as tknn

DIM = 16
RTOL = ATOL = 1e-5
SIDES = {"jax": (jdelta, jindex_ops, jkeys, jknn),
         "torch": (tdelta, tindex_ops, tkeys, tknn)}


@pytest.fixture(autouse=True)
def _no_result_cache(monkeypatch):
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")


def _vectors(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, DIM)).astype(np.float32)


DATA = _vectors(60, seed=1)
QUERIES = _vectors(12, seed=2)
ALT = _vectors(60, seed=3)  # the vectors rows take when re-added


def _script():
    """Ticks of (time, data events, query events). Data: ("+", i) adds row
    i with DATA[i], ("+alt", i) with ALT[i], ("-", i) / ("-alt", i) retract
    it. Queries hold slots (their keys): ("+", slot, q, k) inserts
    QUERIES[q] with limit k, ("none", slot, None, k) a None vector, ("-",
    slot) retracts the row the slot held when the tick began."""
    return [
        (0, [("+", i) for i in range(30)],
         [("+", 0, 0, 3), ("+", 1, 1, 5), ("+", 2, 2, 1), ("+", 3, 3, 4),
          ("none", 4, None, 3), ("+", 5, 5, 100)]),
        # adds, a removal, an add retracted in the same tick, and a row
        # retracted and re-added with a new vector in the same tick; a new
        # query, an update (retract, then insert under the same key) and a
        # retracted query
        (2, [("+", i) for i in range(30, 40)]
         + [("-", 3), ("+", 40), ("-", 40), ("-", 7), ("+alt", 7)],
         [("+", 6, 6, 3), ("-", 0), ("+", 0, 7, 3), ("-", 1)]),
        # a data-only tick: as-of-now answers stay, revise re-answers
        (4, [("-", i) for i in range(10, 20)] + [("+", 41)], []),
        # a new query, and a retracted slot inserted again
        (6, [], [("+", 7, 8, 2), ("+", 1, 9, 60)]),
        # a retraction, and two updates, one arriving insert first
        (8, [("-alt", 7)],
         [("-", 6), ("-", 2), ("+", 2, 10, 3), ("+", 3, 11, 4), ("-", 3)]),
    ]


def _run(side: str, metric: str, revise: bool):
    delta, index_ops, keys, knn = SIDES[side]
    index = knn.BruteForceKnnIndex(DIM, reserved_space=64, metric=metric,
                                   **({"device": "cpu"} if side == "torch"
                                      else {}))
    op = index_ops.ExternalIndexOperator(
        index, data_vec_pos=0, data_filter_pos=None, query_vec_pos=0,
        query_limit_pos=1, query_filter_pos=None, revise=revise)
    dkey = [keys.hash_values("doc", i) for i in range(len(DATA))]
    qkey = [keys.hash_values("query", slot) for slot in range(8)]
    qrows: dict[int, tuple] = {}
    out = []
    for time, data_ev, query_ev in _script():
        dd = delta.Delta()
        for kind, i in data_ev:
            vec = (ALT if kind.endswith("alt") else DATA)[i]
            dd.append(dkey[i], (vec,), -1 if kind[0] == "-" else 1)
        qd = delta.Delta()
        held = dict(qrows)
        for kind, slot, *rest in query_ev:
            if kind == "-":
                qd.append(qkey[slot], held[slot], -1)
                continue
            q, k = rest
            qrows[slot] = (None if kind == "none" else QUERIES[q], k)
            qd.append(qkey[slot], qrows[slot], 1)
        for key, row, diff in op.step(time, [dd, qd]).entries:
            out.append((time, int(key), diff,
                        [(int(mk), float(s)) for mk, s in row[0]]))
    return out


def _hold(jout, tout):
    assert [e[:3] for e in tout] == [e[:3] for e in jout]
    for (_, _, _, jrep), (_, _, _, trep) in zip(jout, tout):
        assert [k for k, _ in trep] == [k for k, _ in jrep]
        np.testing.assert_allclose([s for _, s in trep], [s for _, s in jrep],
                                   rtol=RTOL, atol=ATOL)
        assert all(type(s) is float for _, s in trep)


@pytest.mark.parametrize("revise", [False, True], ids=["as_of_now", "revise"])
@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_operator_events_equal_reference(metric, revise):
    jout = _run("jax", metric, revise)
    tout = _run("torch", metric, revise)
    assert jout
    _hold(jout, tout)
    times = {t for t, _, _, _ in tout}
    # the data-only tick answers nothing as of now; revise re-answers
    assert (4 in times) == revise
    # the None-vector query is an empty reply; k > index gives every row
    by_key = {(t, k): rep for t, k, d, rep in tout if d > 0}
    assert by_key[(0, int(tkeys.hash_values("query", 4)))] == []
    assert len(by_key[(0, int(tkeys.hash_values("query", 5)))]) == 30


def test_as_of_now_answers_are_never_revised():
    """Every as-of-now answer is emitted once at its query's time and
    retracted only when its query is."""
    out = _run("torch", "l2sq", revise=False)
    inserted = [(t, k) for t, k, d, _ in out if d > 0]
    retracted = [(t, k) for t, k, d, _ in out if d < 0]
    # time 2: slot 0 updated, slot 1 retracted; time 8: slot 6 retracted,
    # slots 2 and 3 updated
    assert len(retracted) == 5
    for t, k in retracted:
        assert any(k == ik and it < t for it, ik in inserted)


def test_operator_equal_reference_with_result_cache_on(monkeypatch):
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "1")
    jout = _run("jax", "cos", revise=False)
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")
    _hold(jout, _run("torch", "cos", revise=False))


def test_operator_is_device_bound_over_the_device_index():
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

    emb = EncoderEmbedder(config=EncoderConfig.tiny(), device="cpu")
    index = tknn.DeviceEmbeddingKnnIndex(
        emb, tknn.BruteForceKnnIndex(64, metric="cos", device="cpu"))
    op = tindex_ops.ExternalIndexOperator(
        index, data_vec_pos=0, data_filter_pos=None, query_vec_pos=0,
        query_limit_pos=None, query_filter_pos=None)
    assert op.device_bound
