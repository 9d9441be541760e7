"""The port's request tracker (engine/request_tracker.py) against the JAX
package's: the same samples through both ``P2Quantile`` estimators, and
the same stamped spans through both ``RequestTracker``s — estimates, stage
decompositions, quantiles and summaries equal exactly (both are the same
pure-Python arithmetic on the same floats)."""

import numpy as np
import pytest

from pathway_tpu.engine import request_tracker as jrt
from pathway_tpu_torch.engine import request_tracker as trt


def _samples(dist: str, n: int, seed: int) -> list[float]:
    rng = np.random.default_rng(seed)
    if dist == "lognormal":
        xs = rng.lognormal(mean=2.0, sigma=0.6, size=n)
    elif dist == "exponential":
        xs = rng.exponential(10.0, size=n)
    else:  # ties and a constant run: the marker updates' edge cases
        xs = np.concatenate([np.full(n // 2, 3.0),
                             rng.integers(0, 5, size=n - n // 2)])
    return [float(x) for x in xs]


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
@pytest.mark.parametrize("dist,n", [("lognormal", 4000), ("exponential", 500),
                                    ("ties", 300), ("lognormal", 3)])
def test_p2_quantile_equal(q, dist, n):
    xs = _samples(dist, n, seed=n)
    est_j, est_t = jrt.P2Quantile(q), trt.P2Quantile(q)
    assert est_t.value() is None and est_j.value() is None
    for i, x in enumerate(xs):
        est_j.observe(x)
        est_t.observe(x)
        if i < 8 or i % 97 == 0:
            assert est_t.value() == est_j.value()
    assert est_t.count == est_j.count == n
    assert est_t.value() == est_j.value()


def _stamp(tracker, i: int, gaps: list, missing: int | None):
    """One span with stamps ingress + cumulative gaps (ms); the stamp at
    index ``missing`` (1..5) is left unset, the span then telescopes
    over it."""
    t = 1000.0 + i
    span = tracker.start(f"r{i}", "/q", t_ingress=t)
    names = ("t_admission", "t_enqueued", "t_tick_start", "t_host_done",
             "t_resolved")
    for j, name in enumerate(names, start=1):
        t += gaps[j - 1] / 1e3
        if j != missing:
            setattr(span, name, t)
    span.key = i
    tracker._by_key[i] = span
    return span


def test_stage_sums_and_aggregates_equal(monkeypatch):
    rng = np.random.default_rng(7)
    trackers = (jrt.RequestTracker(slo_ms=25.0),
                trt.RequestTracker(slo_ms=25.0))
    records = ([], [])
    for i in range(300):
        gaps = [float(g) for g in rng.exponential(3.0, size=6)]
        # one of the admission..host-done stamps unset, or none (an
        # unresolved span is dropped, as the last test holds)
        missing = int(rng.integers(0, 8))
        if missing not in (1, 2, 3, 4):
            missing = None
        for tracker, out in zip(trackers, records):
            span = _stamp(tracker, i, gaps, missing)
            stages = span.stages_ms()
            assert list(stages) == list(trt.STAGES)
            # the responded stamp is the clock at finish(): pin it
            monkeypatch.setattr(
                jrt.time if tracker is trackers[0] else trt.time,
                "perf_counter", lambda t=1000.0 + i + sum(gaps) / 1e3: t)
            tracker.finish(span)
            out.append(tracker.trace_spans()[-1])
    assert trt.STAGES == jrt.STAGES
    for rj, rt in zip(*records):
        assert rt["stages"] == rj["stages"]
        assert rt["e2e_ms"] == rj["e2e_ms"]
        assert rt["dominant_stage"] == rj["dominant_stage"]
        assert sum(rt["stages"].values()) == pytest.approx(rt["e2e_ms"],
                                                           abs=0.01)
    jt, tt = trackers
    assert tt.quantiles_ms() == jt.quantiles_ms()
    assert tt.stage_summary() == jt.stage_summary()
    assert tt.burn_rate() == jt.burn_rate()
    assert tt.count == jt.count == 300
    assert tt.violations == jt.violations > 0
    assert [r["request_id"] for r in tt.slow_queries()] == \
        [r["request_id"] for r in jt.slow_queries()]
    assert tt.summary() == jt.summary()


def test_picked_up_host_done_resolved_finish_equal():
    """The write side as the runtime drives it: enqueue, tick pickup
    (retractions skipped), host-done for the tick, resolve, finish; an
    unresolved span is dropped by both."""
    out = []
    for mod in (jrt, trt):
        tr = mod.RequestTracker(slo_ms=1e9)
        spans = [tr.start(f"r{i}", "/q", t_ingress=0.0) for i in range(4)]
        for i, span in enumerate(spans):
            tr.admission(span)
            tr.enqueued(span, 100 + i)
        tr.picked_up([(100, (), 1), (101, (), 1), (102, (), -1)], tick=3)
        assert tr.active()
        tr.host_done(3)
        tr.resolved(100)
        tr.resolved(101)
        for span in spans:
            tr.finish(span)
        assert not tr.active()
        out.append([(r["request_id"], r["tick"]) for r in tr.trace_spans()]
                   + [tr.count, tr.summary()["inflight"]])
    assert out[0] == out[1] == [("r0", 3), ("r1", 3), 2, 0]
