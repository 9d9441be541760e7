"""GroupByOperator's array_sum route in the port: ``device_segsum`` (one
in-order float32 add a row position over the padded (G, M, D) rows) and
the rule ``_segsum_pays`` that sends a tick to it, held against the per-row
numpy loop it replaces. Tolerance: none; arrays compare by their bytes.

On the CPU the route runs its torch code on CPU tensors
(``_array_sum_device`` patched). The ``cuda`` tests run it on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_array_sum.py

Nothing here imports JAX (tests/test_torch_groupby.py holds the route
against the JAX package's ``_device_segsum_fn``).
"""

import numpy as np
import pytest
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine import operators as ops
from pathway_tpu_torch.internals.runner import GraphRunner

# (rows a tick, groups a tick, rows of one large group): groups 0 is one
# group of the last field's rows beside singletons
CASES = [(128, 64, 0), (128, 8, 0), (128, 1, 0), (256, 0, 32), (96, 96, 0)]


def _ticks(rows: int, groups: int, big: int, dim: int, seed: int):
    rng = np.random.default_rng(seed)
    if groups:
        tick = rng.permutation(np.arange(rows) % groups)
    else:
        tick = rng.permutation(np.concatenate(
            [np.zeros(big, np.int64), np.arange(1, rows - big + 1)]))
    vecs = rng.standard_normal((2 * rows, dim)).astype(np.float32)
    vecs[::5, 0] = -0.0
    return np.concatenate([tick, rng.permutation(tick)]), vecs


def _run(gids, vecs, monkeypatch, route: str, device: str = "cpu"):
    """Two ticks of ``groupby(g).reduce(g, a=npsum(v))`` (the second also
    retracts the first tick's even rows) under ``run_batch``; returns the
    events (arrays as bytes) and the ``device_segsum`` calls."""
    rows = len(gids) // 2
    data = [(i, int(g), v, 2 * (i // rows), 1)
            for i, (g, v) in enumerate(zip(gids, vecs))]
    data += [(i, int(gids[i]), vecs[i], 2, -1) for i in range(0, rows, 2)]
    t = pw.debug.table_from_rows(
        pw.schema_from_types(rid=int, g=int, v=np.ndarray), data,
        is_stream=True)
    t = t.with_id_from(t.rid)
    runner = GraphRunner()
    cap = runner.capture(t.groupby(t.g).reduce(t.g, a=pw.reducers.npsum(t.v)))
    calls = [0]
    segsum = ops.device_segsum

    def counted(*args):
        calls[0] += 1
        return segsum(*args)

    with monkeypatch.context() as m:
        m.setattr(ops, "device_segsum", counted)
        m.setattr(ops, "_array_sum_device", lambda: torch.device(device))
        if route == "host":
            m.setattr(ops, "_array_sum_device_min", lambda: 0)
        elif route == "device":
            m.setattr(ops, "_array_sum_device_min", lambda: 1)
            m.setattr(ops, "_ARRAY_SUM_MAX_POSITIONS", 1 << 62)
            m.setattr(ops, "_ARRAY_SUM_MAX_PADDING", 1 << 62)
        else:  # the rule, past a lowered element threshold
            m.setattr(ops, "_array_sum_device_min", lambda: 64)
        runner.run_batch(n_workers=1)
    events = sorted((int(k), row[0], row[1].dtype.str, row[1].tobytes(), t, d)
                    for k, row, t, d in cap.events)
    return events, calls[0]


@pytest.mark.parametrize("rows,groups,big", CASES)
def test_forced_route_equals_host_loop(rows, groups, big, monkeypatch):
    gids, vecs = _ticks(rows, groups, big, 6, rows + groups + big)
    host, host_calls = _run(gids, vecs, monkeypatch, "host")
    dev, dev_calls = _run(gids, vecs, monkeypatch, "device")
    assert (host_calls, dev_calls) == (0, 2)
    assert dev == host


@pytest.mark.parametrize("rows,groups,big", CASES)
def test_rule_picks_the_route(rows, groups, big, monkeypatch):
    gids, vecs = _ticks(rows, groups, big, 6, rows + groups + big)
    tick = gids[:rows]
    pays = ops._segsum_pays(rows, len(np.unique(tick)),
                            int(np.bincount(tick).max()))
    got, calls = _run(gids, vecs, monkeypatch, "rule")
    # the second tick (rows + rows // 2 entries, the same groups) takes the
    # route the first does exactly when its shape also pays
    tick2 = np.concatenate([gids[rows:], gids[:rows:2]])
    pays2 = ops._segsum_pays(len(tick2), len(np.unique(tick2)),
                             int(np.bincount(tick2).max()))
    assert calls == int(pays) + int(pays2)
    assert got == _run(gids, vecs, monkeypatch, "host")[0]


@pytest.mark.parametrize("rows,groups,positions,pays", [
    (4096, 2048, 2, True),
    (4096, 4096, 1, True),
    (4096, 1, 4096, False),                      # one long group
    (4096, 16, 256, False),
    (4096, 3969, 128, False),                    # skew: padding blows up
    (4096, 4096 // 64, 64, True),
])
def test_segsum_pays(rows, groups, positions, pays):
    assert ops._segsum_pays(rows, groups, positions) is pays


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the route's device is the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096, 384), (2048, 2, 384),
                                   (7, 300, 1041), (3, 1, 4)])
def test_device_segsum_on_card_is_the_host_loop(shape):
    dev = _card()
    rng = np.random.default_rng(sum(shape))
    padded = rng.standard_normal(shape).astype(np.float32)
    padded[:, -1, ::3] = -0.0
    init = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
    init[0, 0] = -0.0
    got = ops.device_segsum(torch.from_numpy(padded).to(dev),
                            torch.from_numpy(init).to(dev)).cpu().numpy()
    acc = init.copy()
    for m in range(shape[1]):
        acc = acc + padded[:, m]
    assert got.tobytes() == acc.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,groups,big", CASES)
def test_route_on_card_equals_host_loop(rows, groups, big, monkeypatch):
    _card()
    gids, vecs = _ticks(rows, groups, big, 384, rows + groups + big)
    host, _ = _run(gids, vecs, monkeypatch, "host")
    dev, calls = _run(gids, vecs, monkeypatch, "device", device="cuda")
    assert calls == 2
    assert dev == host
