"""The port's ``pw.stdlib.ml`` (with ``stdlib.utils`` and
``stdlib.stateful``) against the JAX package's: every test of
tests/test_ml_stdlib.py, run through both packages on the same inputs.

- the custom accumulator, HMM decoding (on a duck-typed graph class both
  packages accept: no networkx), the fuzzy joins and
  ``classifier_accuracy``: rows equal, keys included;
- the LSH bucketers: band codes equal bit for bit (both bucketers, several
  seeds and shapes), and ``lsh``'s flat table equal;
- the LSH classifier (bucketed and exact) and the digits classifier: the
  predicted labels equal row by row;
- ``clustering_via_lsh``: the partitions equal up to a relabelling;
- ``kmeans_labels`` on seeded blobs (n = 4096, d = 384, k = 64): labels
  equal exactly; ``_kmeans_fn`` with a cluster left empty (a duplicated
  initial centre) and with a cluster of zero weight: labels equal
  exactly;
- ``stdlib.utils`` (``col``, ``filtering``, ``bucketing``) and
  ``stdlib.stateful.deduplicate``: rows equal.

The port runs on ``device="cpu"``. Every comparison is exact: the JAX
package's k-means is float32 XLA on the CPU, the port's float32 torch, and
on these inputs no point lies near a tie. The JAX side runs with
``PATHWAY_AUTO_JIT=0``, ``PATHWAY_DEVICE_INFLIGHT=1`` and
``PATHWAY_RESULT_CACHE=0``."""

from __future__ import annotations

import datetime
import types
from functools import partial

import numpy as np
import pytest

SIDES = ("jax", "torch")


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")


def _side(side: str):
    """Each package's modules under one namespace; ``kw`` is what the
    port's device entry points need on the CPU."""
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.internals import schema
        from pathway_tpu.internals.parse_graph import G
        from pathway_tpu.internals.runner import run_tables
        from pathway_tpu.stdlib.ml import classifiers
        from pathway_tpu.stdlib.ml.classifiers import _clustering
        kw = {}
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.internals import schema
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.internals.runner import run_tables
        from pathway_tpu_torch.stdlib.ml import classifiers
        from pathway_tpu_torch.stdlib.ml.classifiers import _clustering
        kw = {"device": "cpu"}
    G.clear()
    return types.SimpleNamespace(
        pw=pw, schema=schema, run_tables=run_tables, T=pw.debug.table_from_markdown,
        classifiers=classifiers, clustering=_clustering, kw=kw)


def _snapshots(m, *tables) -> list[dict]:
    return [cap.snapshot() for cap in m.run_tables(*tables)]


def _both(build) -> list:
    """``build(m)`` through each package: [jax result, torch result]."""
    return [build(_side(side)) for side in SIDES]


def _rows(snap: dict) -> dict:
    return {int(k): v for k, v in snap.items()}


# ---------------------------------------------------------------------------
# custom accumulators and HMM decoding
# ---------------------------------------------------------------------------

def test_udf_reducer_custom_accumulator():
    def build(m):
        class SumSq(m.pw.BaseCustomAccumulator):
            def __init__(self, v):
                self.total = v * v

            @classmethod
            def from_row(cls, row):
                [v] = row
                return cls(v)

            def update(self, other):
                self.total += other.total

            def compute_result(self):
                return self.total

        t = m.T("""
        g | x
        a | 1
        a | 2
        b | 3
        """)
        r = t.groupby(t.g).reduce(g=t.g,
                                  s=m.pw.reducers.udf_reducer(SumSq)(t.x))
        return _rows(_snapshots(m, r)[0])

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows
    assert sorted(torch_rows.values()) == [("a", 5), ("b", 9)]


class _Nodes:
    """``graph.nodes()`` and ``graph.nodes[n]``, networkx's two forms."""

    def __init__(self):
        self._attrs: dict = {}

    def __call__(self):
        return list(self._attrs)

    def __getitem__(self, node):
        return self._attrs[node]


class _DiGraph:
    """The networkx DiGraph surface ``create_hmm_reducer`` reads."""

    def __init__(self):
        self.nodes = _Nodes()
        self._edges: list = []
        self.graph: dict = {}

    def add_node(self, node, **attrs):
        self.nodes._attrs[node] = attrs

    def add_edge(self, u, v, **attrs):
        self._edges.append((u, v, attrs))

    def edges(self, data: bool = False):
        return [e if data else e[:2] for e in self._edges]


def _manul_graph():
    def emis(observation, state):
        table = {("HUNGRY", "GRUMPY"): 0.9, ("HUNGRY", "HAPPY"): 0.1,
                 ("FULL", "GRUMPY"): 0.7, ("FULL", "HAPPY"): 0.3}
        return np.log(table[(state, observation)])

    g = _DiGraph()
    g.add_node("HUNGRY", calc_emission_log_ppb=partial(emis, state="HUNGRY"))
    g.add_node("FULL", calc_emission_log_ppb=partial(emis, state="FULL"))
    g.add_edge("HUNGRY", "HUNGRY", log_transition_ppb=np.log(0.4))
    g.add_edge("HUNGRY", "FULL", log_transition_ppb=np.log(0.6))
    g.add_edge("FULL", "HUNGRY", log_transition_ppb=np.log(0.6))
    g.add_edge("FULL", "FULL", log_transition_ppb=np.log(0.4))
    g.graph["start_nodes"] = ["HUNGRY", "FULL"]
    return g


@pytest.mark.parametrize("kept", [None, 3])
def test_hmm_viterbi_stream(kept):
    def build(m):
        obs = m.T("""
        observation | __time__
        HAPPY       | 1
        HAPPY       | 2
        GRUMPY      | 3
        GRUMPY      | 4
        HAPPY       | 5
        GRUMPY      | 6
        """)
        reducer = m.pw.reducers.udf_reducer(
            m.pw.stdlib.ml.hmm.create_hmm_reducer(_manul_graph(),
                                                  num_results_kept=kept))
        decoded = obs.reduce(decoded_state=reducer(obs.observation))
        [cap] = m.run_tables(decoded)
        return cap.events, _rows(cap.snapshot())

    (jax_events, jax_rows), (torch_events, torch_rows) = _both(build)
    assert torch_events == jax_events  # every re-decode, retractions too
    assert torch_rows == jax_rows
    if kept == 3:  # the reference doctest's last row
        assert list(torch_rows.values()) == [(("HUNGRY", "FULL", "HUNGRY"),)]


# ---------------------------------------------------------------------------
# fuzzy joins and classifier_accuracy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalization", ["WEIGHT", "LOGWEIGHT", "NONE"])
def test_fuzzy_match_columns(normalization):
    def build(m):
        left = m.T("""
        name
        Johnny Smith
        Alice Cooper
        Bob Marley
        """)
        right = m.T("""
        name
        smith john
        cooper alice
        marley bob
        """)
        ml = m.pw.stdlib.ml
        res = ml.fuzzy_match(left.name, right.name,
                             normalization=getattr(
                                 ml.FuzzyJoinNormalization, normalization))
        joined = res.join(left, res.left == left.id).select(
            lname=left.name, right=res.right)
        joined = joined.join(right, joined.right == right.id).select(
            lname=joined.lname, rname=right.name)
        return [_rows(s) for s in _snapshots(m, res, joined)]

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows
    pairs = dict(torch_rows[1].values())
    assert pairs["Alice Cooper"] == "cooper alice"
    assert pairs["Bob Marley"] == "marley bob"


def test_fuzzy_match_tables_and_self_match():
    def build(m):
        t1 = m.T("""
        a     | b
        apple | pie
        stock | market
        """)
        t2 = m.T("""
        c
        apple pie recipe
        stock market crash
        """)
        ml = m.pw.stdlib.ml
        res = ml.fuzzy_match_tables(t1, t2)
        t3 = m.T("""
        v
        hello world
        hello world
        something else
        """)
        selfm = ml.fuzzy_self_match(t3, t3.v)
        letters = ml.smart_fuzzy_match(
            t1.a, t2.c,
            feature_generation=ml.FuzzyJoinFeatureGeneration.LETTERS)
        return [_rows(s) for s in _snapshots(m, res, selfm, letters)]

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows
    assert len(torch_rows[0]) == 2 and len(torch_rows[1]) == 1


def test_fuzzy_match_with_hint():
    def build(m):
        left = m.T("""
        name
        Johnny Smith
        Alice Cooper
        """)
        right = m.T("""
        name
        smith john
        cooper alice
        """)
        ml = m.pw.stdlib.ml
        matches = ml.fuzzy_match(left.name, right.name)
        # a hand pair for the left rows matched above weight 0.9 (Alice
        # Cooper's, 1.0): it replaces their automatic match
        hand = matches.filter(matches.weight > 0.9).select(
            left=matches.left, right=matches.left, weight=2.0)
        hinted = ml.smart_table_ops.fuzzy_match_with_hint(matches, hand)
        return [_rows(s) for s in _snapshots(m, matches, hinted)]

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows


def test_classifier_accuracy():
    def build(m):
        predicted = m.T("""
        predicted_label
        cat
        dog
        cat
        """)
        exact = predicted.select(label=m.pw.apply(
            lambda p: "cat", predicted.predicted_label))
        acc = m.pw.stdlib.ml.utils.classifier_accuracy(predicted, exact)
        return _rows(_snapshots(m, acc)[0])

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows
    assert dict((v, c) for c, v in torch_rows.values()) == {True: 2,
                                                            False: 1}


# ---------------------------------------------------------------------------
# LSH bucketers: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("shape", [(6, 4, 12, 2.0), (384, 3, 8, 1.0),
                                   (32, 10, 20, 0.5)])
@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
def test_lsh_band_codes_bit_for_bit(kind, shape, seed):
    from pathway_tpu.stdlib.ml.classifiers import _lsh as jlsh
    from pathway_tpu_torch.stdlib.ml.classifiers import _lsh as tlsh

    d, M, L, A = shape
    rng = np.random.default_rng(seed + 100)
    xs = rng.standard_normal((40, d)) * 3.0
    if kind == "euclidean":
        jb = jlsh.generate_euclidean_lsh_bucketer(d, M, L, A, seed=seed)
        tb = tlsh.generate_euclidean_lsh_bucketer(d, M, L, A, seed=seed)
    else:
        jb = jlsh.generate_cosine_lsh_bucketer(d, M, L, seed=seed)
        tb = tlsh.generate_cosine_lsh_bucketer(d, M, L, seed=seed)
    assert tb.n_bands == jb.n_bands == L
    for x in xs:
        jc, tc = jb(x), tb(x)
        assert tc.dtype == jc.dtype == np.int64
        assert np.array_equal(tc, jc)


def _labeled_blobs(n_per=12, d=6, seed=3):
    """Three well-separated gaussian blobs with labels (the JAX test's)."""
    rng = np.random.default_rng(seed)
    centers = np.eye(3, d) * 10.0
    pts, labels = [], []
    for ci in range(3):
        pts.append(centers[ci] + rng.standard_normal((n_per, d)) * 0.3)
        labels += [f"c{ci}"] * n_per
    return np.concatenate(pts).astype(np.float64), labels


def _points_table(m, pts, labels=None):
    if labels is None:
        schema = m.schema.schema_from_types(data=np.ndarray)
        return m.pw.debug.table_from_rows(
            schema, [(pts[i],) for i in range(len(pts))])
    schema = m.schema.schema_from_types(data=np.ndarray, label=str)
    return m.pw.debug.table_from_rows(
        schema, [(pts[i], labels[i]) for i in range(len(pts))])


def test_lsh_flat_table_equal():
    pts, _ = _labeled_blobs(n_per=5)

    def build(m):
        c = m.classifiers
        flat = c.lsh(_points_table(m, pts),
                     c.generate_euclidean_lsh_bucketer(6, M=3, L=4, A=2.0),
                     origin_id="data_id", include_data=True)
        snap = _rows(_snapshots(m, flat)[0])
        return {k: (int(v[0]), v[1], v[2], v[3].tolist())
                for k, v in snap.items()}

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows
    assert len(torch_rows) == 15 * 4


# ---------------------------------------------------------------------------
# classifiers and clustering
# ---------------------------------------------------------------------------

_QUERIES = np.array([[10.0, 0, 0, 0, 0, 0.2], [0, 9.7, 0.1, 0, 0, 0],
                     [0.1, 0, 10.2, 0, 0, 0], [30.0, 30.0, 0, 0, 0, 0]])


@pytest.mark.parametrize("k", [1, 3])
def test_lsh_bucketed_classifier_votes_correctly(k):
    pts, labels = _labeled_blobs()

    def build(m):
        c = m.classifiers
        classifier = c.knn_lsh_euclidean_classifier_train(
            _points_table(m, pts, labels), d=6, M=4, L=12, A=2.0)
        res = c.knn_lsh_classify(classifier, _points_table(m, _QUERIES),
                                 k=k)
        return _rows(_snapshots(m, res)[0])

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows  # the far query: no bucket, label None
    assert sorted(v[0] for v in torch_rows.values() if v[0]) == [
        "c0", "c1", "c2"]


@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
def test_lsh_exact_classifier_equal(kind):
    pts, labels = _labeled_blobs()

    def build(m):
        c = m.classifiers
        classifier = c.knn_lsh_classifier_train(
            _points_table(m, pts, labels), 5, kind, n_dimensions=6, **m.kw)
        res = c.knn_lsh_classify(classifier, _points_table(m, _QUERIES), k=3)
        return _rows(_snapshots(m, res)[0])

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows


def test_lsh_cosine_bucketed_classifier_equal():
    pts, labels = _labeled_blobs()

    def build(m):
        c = m.classifiers
        classifier = c.knn_lsh_classifier_train(
            _points_table(m, pts, labels), 6, "cosine", d=6, M=3)
        res = c.knn_lsh_classify(classifier, _points_table(m, _QUERIES), k=3)
        return _rows(_snapshots(m, res)[0])

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows


@pytest.mark.parametrize("bogus", [{"bogus": 1}, {"d": 6, "Q": 2}])
def test_lsh_classifier_rejects_unknown_params(bogus):
    pts, labels = _labeled_blobs(n_per=3)
    for side in SIDES:
        m = _side(side)
        data = _points_table(m, pts, labels)
        with pytest.raises(TypeError, match="unsupported lsh_params"):
            m.classifiers.knn_lsh_classifier_train(data, 5, "euclidean",
                                                   **bogus)


def _partition(labels: dict) -> set:
    groups: dict = {}
    for key, lbl in labels.items():
        groups.setdefault(lbl, set()).add(key)
    return {frozenset(g) for g in groups.values()}


@pytest.mark.parametrize("k,A", [(3, 4.0), (5, 2.0)])
def test_clustering_via_lsh_partitions_equal(k, A):
    pts, true_labels = _labeled_blobs(n_per=15)

    def build(m):
        c = m.classifiers
        kw = {} if not m.kw else {"device": "cpu"}
        res = c.clustering_via_lsh(
            _points_table(m, pts),
            c.generate_euclidean_lsh_bucketer(6, M=3, L=8, A=A), k, **kw)
        return {key: v[0] for key, v in _rows(_snapshots(m, res)[0]).items()}

    jax_labels, torch_labels = _both(build)
    assert set(torch_labels) == set(jax_labels)
    assert len(torch_labels) == len(pts)
    assert _partition(torch_labels) == _partition(jax_labels)
    if k == 3:  # the JAX test's case: three clusters, the three blobs
        assert len(set(torch_labels.values())) == 3


def _blobs(n: int, d: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32)
    blob = rng.integers(0, k, n)
    pts = (centers[blob] + 0.25 * rng.standard_normal((n, d))).astype(
        np.float32)
    weights = rng.integers(1, 5, n).astype(np.float32)
    return pts, weights, blob


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_labels_equal_on_blobs(seed):
    from pathway_tpu.stdlib.ml.classifiers import _clustering as jcl
    from pathway_tpu_torch.stdlib.ml.classifiers import _clustering as tcl

    pts, weights, blob = _blobs(4096, 384, 64, seed)
    jax_labels = jcl.kmeans_labels(pts, weights, 64, seed=seed)
    torch_labels = tcl.kmeans_labels(pts, weights, 64, seed=seed,
                                     device="cpu")
    assert torch_labels == jax_labels
    assert len(torch_labels) == 4096 and all(
        isinstance(v, int) for v in torch_labels)


def _kmeans_both(pts, weights, init, iters):
    import torch

    from pathway_tpu.stdlib.ml.classifiers import _clustering as jcl
    from pathway_tpu_torch.stdlib.ml.classifiers import _clustering as tcl

    jax_labels = np.asarray(jcl._kmeans_fn(len(init), iters)(
        pts, weights, init.astype(np.int32)))
    torch_labels = tcl._kmeans_fn(torch.from_numpy(pts),
                                  torch.from_numpy(weights),
                                  torch.from_numpy(init.astype(np.int64)),
                                  iters).numpy()
    return jax_labels, torch_labels


@pytest.mark.parametrize("iters", [0, 1, 5])
def test_kmeans_empty_cluster_keeps_its_centre(iters):
    """Centres 1 and 2 start on the same point (rows 3 and 7 are equal):
    ties go to the first, so the first assignment leaves centre 2 empty
    (with no step, label 2 never appears). Its centre then stays on row 3
    while centre 1 moves to its cluster's mean, so after one step rows 3
    and 7 lie at distance 0 from centre 2 and take its label."""
    pts, weights, _ = _blobs(512, 16, 4, 5)
    pts[7] = pts[3]
    init = np.array([0, 3, 7, 100, 200])
    jax_labels, torch_labels = _kmeans_both(pts, weights, init, iters)
    assert np.array_equal(torch_labels, jax_labels)
    if iters == 0:
        assert 2 not in set(torch_labels.tolist())
    elif iters == 1:
        assert torch_labels[3] == torch_labels[7] == 2


def test_kmeans_zero_weight_cluster_keeps_its_centre():
    """A blob of zero-weight points: its centre's weighted total is 0, so
    it stays where it started (``where(wtot > 0, ...)``)."""
    pts, weights, blob = _blobs(512, 16, 4, 6)
    weights[blob == 2] = 0.0
    init = np.array([int(np.flatnonzero(blob == b)[0]) for b in range(4)])
    jax_labels, torch_labels = _kmeans_both(pts, weights, init, 5)
    assert np.array_equal(torch_labels, jax_labels)


def test_digits_dataset_knn_classifier_end_to_end():
    """ml.datasets loader -> the exact kNN classifier -> labels, row by row
    (rows matched by their pixels: the two packages key tables
    differently)."""
    pytest.importorskip("sklearn")

    def build(m):
        from importlib import import_module

        c = m.classifiers
        ds = import_module(m.classifiers.__name__.rsplit(".", 1)[0]
                           + ".datasets.classification")
        train, test, train_labels, test_labels = ds.load_digits_sample(400)
        lbl = train_labels.ix(train.id, context=train)
        data = train.select(train.data, label=lbl.label)
        classifier = c.knn_lsh_classifier_train(data, n_dimensions=64,
                                                **m.kw)
        predicted = c.knn_lsh_classify(classifier, test, k=5)
        out = predicted.select(
            predicted.predicted_label,
            truth=test_labels.ix(predicted.id, context=predicted).label,
            pixels=test.ix(predicted.id, context=predicted).data)
        snap = _snapshots(m, out)[0]
        return sorted((tuple(np.asarray(px).tolist()), truth, pred)
                      for pred, truth, px in snap.values())

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows
    acc = sum(truth == pred for _, truth, pred in torch_rows) / len(
        torch_rows)
    assert len(torch_rows) > 0 and acc >= 0.85, acc


def test_load_mnist_sample_raises_without_fetching():
    from pathway_tpu_torch.stdlib.ml.datasets.classification import \
        load_mnist_sample

    with pytest.raises(NotImplementedError, match="network"):
        load_mnist_sample(100)


# ---------------------------------------------------------------------------
# stdlib.utils and stdlib.stateful
# ---------------------------------------------------------------------------

def test_utils_col_helpers_equal():
    def build(m):
        col = m.pw.stdlib.utils.col
        t = m.T("""
        g | a | b
        x | 1 | 10
        x | 2 | 20
        y | 3 | 30
        y | 3 | 40
        """)
        pairs = t.select(p=m.pw.make_tuple(t.a, t.b))
        unpacked = col.unpack_col(pairs.p, "first", "second")
        lists = t.select(v=m.pw.apply(lambda a: tuple(range(a)), t.a))
        flat = col.flatten_column(lists.v)
        multi = col.multiapply_all_rows(
            t.a, t.b, fun=lambda a, b: ([x + y for x, y in zip(a, b)],
                                        [x * y for x, y in zip(a, b)]),
            result_col_names=["s", "p"])
        single = col.apply_all_rows(t.b, fun=lambda b: [x // 10 for x in b],
                                    result_col_name="tens")
        majority = col.groupby_reduce_majority(t.g, t.a)
        return [_rows(s) for s in _snapshots(m, unpacked, flat, multi,
                                             single, majority)]

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows


@pytest.mark.parametrize("which", ["argmax_rows", "argmin_rows"])
def test_utils_filtering_equal(which):
    def build(m):
        t = m.T("""
        g | v
        x | 1
        x | 5
        y | 3
        y | 2
        """)
        fn = getattr(m.pw.stdlib.utils.filtering, which)
        return _rows(_snapshots(m, fn(t, t.g, what=t.v))[0])

    jax_rows, torch_rows = _both(build)
    assert torch_rows == jax_rows
    assert len(torch_rows) == 2


@pytest.mark.parametrize("fn", ["truncate_to_minutes", "truncate_to_hours",
                                "truncate_to_days"])
def test_utils_bucketing_equal(fn):
    from pathway_tpu.stdlib.utils import bucketing as jb
    from pathway_tpu_torch.stdlib.utils import bucketing as tb

    for t in (datetime.datetime(2024, 5, 17, 13, 45, 31, 250),
              datetime.datetime(2024, 5, 17, 13, 45, 31, 250,
                                tzinfo=datetime.timezone.utc)):
        assert getattr(tb, fn)(t) == getattr(jb, fn)(t)


def test_stateful_deduplicate_equal():
    def build(m):
        t = m.T("""
        k | v  | __time__
        a | 1  | 2
        a | 3  | 4
        b | 7  | 4
        a | 2  | 6
        b | 20 | 8
        """)
        out = m.pw.stdlib.stateful.deduplicate(
            t, col=t.v, instance=t.k,
            acceptor=lambda new, old: new > old)
        [cap] = m.run_tables(out)
        return cap.events, _rows(cap.snapshot())

    (jax_events, jax_rows), (torch_events, torch_rows) = _both(build)
    assert torch_events == jax_events
    assert torch_rows == jax_rows


def test_unported_utils_raise_naming_their_step():
    import pathway_tpu_torch.stdlib.utils as utils

    for name in ("AsyncTransformer", "pandas_transformer"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            getattr(utils, name)
