"""The port's classic ``KNNIndex`` (stdlib/ml/index.py) against the JAX
package's: the same rows and queries, numpy draws of one seed, in each
package's ``KNNIndex`` (the port's on ``device="cpu"``) under its own
``GraphRunner.run_batch``.

Cases: both metrics; ``with_distances``; ``collapse_rows=False``; a
callable ``metadata_filter``; ``get_nearest_items_asof_now``; and a
streamed case where rows and queries arrive over several ticks (the
standing query re-answered as the index grows, against the as-of-now
query answered once).

Checked: keys, times and diffs exactly (for a standing query over the
streamed rows, the output's state after every time instead: see
``_hold_states``); the matched rows' ids and
columns exactly and in rank order, except inside groups of matches
whose reference distances lie within ``TOL`` of each other (their order
is set by f32 rounding, as tests/test_torch_knn_bf16.py holds the float32
probe); the distances within ``TOL`` (1e-5 for cosine, 1e-5 of the
largest squared distance for euclidean). The JAX side runs with
``PATHWAY_AUTO_JIT=0``, ``PATHWAY_DEVICE_INFLIGHT=1`` and
``PATHWAY_RESULT_CACHE=0``."""

import types

import numpy as np
import pytest

N_ROWS, DIM, N_QUERIES = 240, 16, 12


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")
    monkeypatch.setenv("PATHWAY_RESULT_CACHE", "0")


def _side(side: str):
    if side == "jax":
        import pathway_tpu as pw
        from pathway_tpu.internals.parse_graph import G
        from pathway_tpu.internals.runner import GraphRunner
        from pathway_tpu.stdlib.ml import KNNIndex
        kw = {}
    else:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.internals.parse_graph import G
        from pathway_tpu_torch.internals.runner import GraphRunner
        from pathway_tpu_torch.stdlib.ml import KNNIndex
        kw = {"device": "cpu"}
    return types.SimpleNamespace(pw=pw, G=G, GraphRunner=GraphRunner,
                                 KNNIndex=KNNIndex, kw=kw)


def _draws(seed: int):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N_ROWS, DIM))
    queries = rng.standard_normal((N_QUERIES, DIM))
    queries[0] = rows[5]  # a copy of a row: distance 0
    return rows, queries


def _even(meta) -> bool:
    value = meta.value if hasattr(meta, "value") else meta
    return value["parity"] == 0


def _tables(m, rows, queries, streamed: bool):
    """(data, queries): data rows doc_id / vec / meta, queries q / filt;
    streamed, both arrive over ticks 2, 4, 6, 8."""
    pw = m.pw
    t_of = (lambda i, n: 2 * (1 + 4 * i // n)) if streamed else None
    data_rows = [(i, rows[i], pw.Json({"parity": i % 2}))
                 + ((t_of(i, N_ROWS), 1) if streamed else ())
                 for i in range(N_ROWS)]
    query_rows = [(queries[i], _even)
                  + ((t_of(i, N_QUERIES) + 1, 1) if streamed else ())
                  for i in range(N_QUERIES)]
    data = pw.debug.table_from_rows(
        pw.schema_from_types(doc_id=int, vec=np.ndarray, meta=pw.Json),
        data_rows, is_stream=streamed)
    qs = pw.debug.table_from_rows(
        pw.schema_from_types(q=np.ndarray, filt=object), query_rows,
        is_stream=streamed)
    return data, qs


CASES = {
    "items": dict(with_distances=False),
    "distances": dict(with_distances=True),
    "flat": dict(collapse_rows=False),
    "filter": dict(with_distances=True, metadata_filter="filt"),
    "asof_now": dict(with_distances=True, asof_now=True),
}


def _run(side: str, metric: str, case: str, streamed: bool, seed: int):
    m = _side(side)
    m.G.clear()
    rows, queries = _draws(seed)
    data, qs = _tables(m, rows, queries, streamed)
    index = m.KNNIndex(data.vec, data, n_dimensions=DIM,
                       distance_type=metric, metadata=data.meta, **m.kw)
    kw = dict(CASES[case])
    asof = kw.pop("asof_now", False)
    if kw.get("metadata_filter") == "filt":
        kw["metadata_filter"] = qs.filt
    query = index.get_nearest_items_asof_now if asof \
        else index.get_nearest_items
    out = query(qs.q, k=4, **kw)
    runner = m.GraphRunner()
    cap = runner.capture(out)
    runner.run_batch(n_workers=1)
    m.G.clear()
    return out.column_names(), cap.events


def _plain(v):
    if type(v).__name__ == "Json":
        return ("json", repr(sorted(v.value.items())))
    if isinstance(v, np.ndarray):
        return ("array", tuple(v.tolist()))
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def _hold_row(jrow, trow, names, tol: float) -> None:
    dist_at = names.index("dist") if "dist" in names else None
    if dist_at is None or not isinstance(jrow[dist_at], tuple):
        assert _plain(trow) == _plain(jrow)
        return
    jd, td = np.asarray(jrow[dist_at]), np.asarray(trow[dist_at])
    np.testing.assert_allclose(td, jd, rtol=0, atol=tol)
    # rank order outside groups of reference distances within tol
    start = 0
    while start < len(jd):
        end = start + 1
        while end < len(jd) and jd[end] - jd[end - 1] <= tol:
            end += 1
        for col, (jc, tc) in enumerate(zip(jrow, trow)):
            if col == dist_at:
                continue
            got, want = (sorted(map(repr, _plain(tc[start:end]))),
                         sorted(map(repr, _plain(jc[start:end]))))
            assert got == want, (names[col], start, end)
            if end - start == 1:
                assert _plain(tc[start]) == _plain(jc[start])
        start = end


def _hold_events(jev, tev, names, tol: float) -> None:
    assert [(int(k), t, d) for k, _, t, d in tev] == \
        [(int(k), t, d) for k, _, t, d in jev]
    for (_, jrow, _, _), (_, trow, _, _) in zip(jev, tev):
        _hold_row(jrow, trow, names, tol)


def _states(events) -> dict:
    """The output's rows by key after each time that has events."""
    state: dict = {}
    out = {}
    for t in sorted({t for _, _, t, _ in events}):
        for key, row, time_, diff in events:
            if time_ == t and diff < 0:
                state.pop(int(key), None)
        for key, row, time_, diff in events:
            if time_ == t and diff > 0:
                state[int(key)] = row
        out[t] = dict(state)
    return out


def _hold_states(jev, tev, names, tol: float) -> None:
    """A standing query re-answered in a batch of another size: the
    port's f32 product rounds by batch shape (ROADMAP queue 3, item 13),
    so it may retract and re-insert an answer whose distances moved by
    an ulp, where the JAX package's re-answer is bit for bit the same.
    So the output's state after every time of either stream is held: the
    same keys, each row as ``_hold_row`` holds it."""
    js, ts = _states(jev), _states(tev)
    for t in sorted(set(js) | set(ts)):
        jstate = js[max(x for x in js if x <= t)] if any(
            x <= t for x in js) else {}
        tstate = ts[max(x for x in ts if x <= t)] if any(
            x <= t for x in ts) else {}
        assert set(tstate) == set(jstate), t
        for key, jrow in jstate.items():
            _hold_row(jrow, tstate[key], names, tol)


def _tol(metric: str, seed: int) -> float:
    if metric == "cosine":
        return 1e-5
    rows, queries = _draws(seed)
    return 1e-5 * float(((queries[:, None] - rows[None]) ** 2).sum(-1).max())


@pytest.mark.parametrize("streamed", [False, True], ids=["batch", "streamed"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_knn_index_matches_reference(metric, case, streamed):
    seed = 3
    jnames, jev = _run("jax", metric, case, streamed, seed)
    tnames, tev = _run("torch", metric, case, streamed, seed)
    assert tnames == jnames
    assert len(tev) >= N_QUERIES
    revised = streamed and case != "asof_now"
    hold = _hold_states if revised else _hold_events
    hold(jev, tev, list(tnames), _tol(metric, seed))


def test_knn_index_finds_the_copy_and_runs_on_the_card_by_default():
    """The query that copies row 5 finds it first at distance ~0; without
    ``device`` the index is placed on "cuda", which raises on a machine
    without a card when the graph is built."""
    _, ev = _run("torch", "euclidean", "distances", False, 0)
    first = [row for _, row, _, _ in ev if row[1][0] == 5]
    assert len(first) == 1 and first[0][0][0] == pytest.approx(0.0,
                                                             abs=1e-4)
    np.testing.assert_array_equal(first[0][2][0], _draws(0)[0][5])
    import torch

    m = _side("torch")
    m.G.clear()
    rows, queries = _draws(0)
    data, qs = _tables(m, rows, queries, False)
    index = m.KNNIndex(data.vec, data, n_dimensions=DIM)
    out = index.get_nearest_items(qs.q, k=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner = m.GraphRunner()
            runner.capture(out)
            runner.run_batch(n_workers=1)
    m.G.clear()
