"""Request-scoped serving-path tracing + SLO accounting — port of
pathway_tpu/engine/request_tracker.py (pure Python, copied; the
per-tenant aggregates and the router's stage names are not ported).

The flight recorder (engine/flight_recorder.py) answers "what is each
*operator* doing"; this module answers "where did each *query* spend its
time". A request id is assigned at webserver ingress (io/http/), and the
span is stamped at fixed hand-off points as the request crosses the
serving path:

    ingress         arrival at the webserver dispatch (t_ingress)
    admission       entering the admission gate (t_admission)
    enqueued        row pushed into the connector session (t_enqueued)
    tick start      the commit loop drained the row (t_tick_start)
    host-leg done   the scheduler finished the tick's host leg (t_host_done)
    resolved        response_writer resolved the request key (t_resolved)
    responded       the HTTP handler returned the value (t_responded)

Consecutive stamps define the six stages reported everywhere
(:data:`STAGES`): ``ingress_wait`` (parse/validate), ``admission_wait``
(the admission gate: QoS is not ported, so the gate is a no-op and the
stage reads ~0), ``queue`` (waiting for the commit tick), ``host``
(host-leg compute), ``device`` (device-leg dispatch through resolution —
in synchronous mode the host leg subsumes it), ``response_write`` (event
wake + serialization). Stamps are normalized to a monotone sequence (a
missing or out-of-order stamp snaps to its predecessor), so the stage
decomposition **telescopes**: the six stages sum to the wall-clock e2e
total by construction.

Aggregation is streaming and bounded: P² quantile estimators
(Jain & Chlamtac 1985) for e2e p50/p95/p99 and per-stage p50, a sliding
window for the SLO burn rate, and a ring of the last N over-budget
requests with their dominant stage. Completed spans also keep their raw
stamps in a bounded ring (``trace_spans``), which bench.py's serving leg
slices by count.

The tracker is created iff the flight recorder is enabled; request ids
never enter engine rows, so pipeline outputs are identical with tracing
on or off.
"""

from __future__ import annotations

import collections
import time

# stage names, in hand-off order (see module doc)
STAGES = ("ingress_wait", "admission_wait", "queue", "host", "device",
          "response_write")

_DEFAULT_SLO_E2E_MS = 20.0       # BASELINE.md serving target
_DEFAULT_ERROR_BUDGET = 0.01     # 1% of requests may exceed the SLO
_DEFAULT_WINDOW = 256            # burn-rate sliding window (requests)
_DEFAULT_SLOW_TAIL = 16          # slow_queries() depth
_DEFAULT_TRACE_SPANS = 512       # completed spans kept for the trace


class P2Quantile:
    """Streaming quantile estimator (the P² algorithm): O(1) memory,
    O(1) per observation, no sample retention. Exact until 5
    observations, then parabolic marker interpolation."""

    __slots__ = ("q", "count", "_init", "_heights", "_pos", "_desired",
                 "_inc")

    def __init__(self, q: float):
        assert 0.0 < q < 1.0
        self.q = q
        self.count = 0
        self._init: list[float] = []
        self._heights: list[float] = []
        self._pos: list[int] = []
        self._desired: list[float] = []
        self._inc = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    def observe(self, x: float) -> None:
        self.count += 1
        if self._heights == []:
            self._init.append(float(x))
            if len(self._init) == 5:
                self._init.sort()
                self._heights = list(self._init)
                self._pos = [1, 2, 3, 4, 5]
                q = self.q
                self._desired = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                                 3.0 + 2.0 * q, 5.0]
            return
        h, n, d = self._heights, self._pos, self._desired
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (h[k] <= x < h[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            d[i] += self._inc[i]
        for i in (1, 2, 3):
            diff = d[i] - n[i]
            if (diff >= 1.0 and n[i + 1] - n[i] > 1) or \
                    (diff <= -1.0 and n[i - 1] - n[i] < -1):
                s = 1 if diff >= 1.0 else -1
                # parabolic (P²) candidate, falling back to linear when it
                # would break marker-height monotonicity
                cand = h[i] + s / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + s) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1]))
                if not (h[i - 1] < cand < h[i + 1]):
                    cand = h[i] + s * (h[i + s] - h[i]) / (n[i + s] - n[i])
                h[i] = cand
                n[i] += s

    def value(self) -> float | None:
        """Current estimate (exact below 5 observations; None when
        nothing was observed)."""
        if self._heights:
            return self._heights[2]
        if not self._init:
            return None
        xs = sorted(self._init)
        # nearest-rank on the tiny exact prefix
        idx = min(len(xs) - 1, max(0, round(self.q * (len(xs) - 1))))
        return xs[idx]


class RequestSpan:
    """One in-flight (or completed) request's stamp set. Mutated by the
    webserver thread (ingress/enqueued/responded), the commit loop
    (tick start / host done) and the device-bridge worker (resolved);
    every stamp is a single attribute store, ordered by the pipeline's
    own hand-off sequence."""

    __slots__ = ("rid", "route", "key", "tick", "t_ingress",
                 "t_admission", "t_enqueued", "t_tick_start", "t_host_done",
                 "t_resolved", "t_responded")

    def __init__(self, rid: str, route: str, t_ingress: float):
        self.rid = rid
        self.route = route
        self.key = None
        self.tick: int | None = None
        self.t_ingress = t_ingress
        self.t_admission: float | None = None
        self.t_enqueued: float | None = None
        self.t_tick_start: float | None = None
        self.t_host_done: float | None = None
        self.t_resolved: float | None = None
        self.t_responded: float | None = None

    def normalized_stamps(self) -> list[float]:
        """The seven stamps as a monotone sequence: a missing or
        out-of-order stamp snaps to its predecessor, so consecutive
        differences are non-negative and telescope exactly to
        ``t_responded - t_ingress``."""
        raw = (self.t_ingress, self.t_admission, self.t_enqueued,
               self.t_tick_start, self.t_host_done, self.t_resolved,
               self.t_responded)
        out = [raw[0]]
        cur = raw[0]
        for t in raw[1:]:
            if t is None or t < cur:
                t = cur
            out.append(t)
            cur = t
        return out

    def stages_ms(self) -> dict[str, float]:
        norm = self.normalized_stamps()
        return {name: (norm[i + 1] - norm[i]) * 1e3
                for i, name in enumerate(STAGES)}


class RequestTracker:
    """Thread-safe per-request span store + streaming SLO aggregates
    (see module doc). One per run, owned by the flight recorder."""

    def __init__(self, slo_ms: float | None = None,
                 error_budget: float | None = None):
        from pathway_tpu_torch.internals.config import _env_float, _env_int

        self.slo_ms = slo_ms if slo_ms is not None else _env_float(
            "PATHWAY_SLO_E2E_MS", _DEFAULT_SLO_E2E_MS)
        budget = error_budget if error_budget is not None else _env_float(
            "PATHWAY_SLO_ERROR_BUDGET", _DEFAULT_ERROR_BUDGET)
        self.error_budget = max(1e-6, budget)
        from pathway_tpu_torch.engine.locking import create_lock

        self._lock = create_lock("RequestTracker._lock")
        self._by_key: dict = {}
        self._by_tick: dict[int, list[RequestSpan]] = {}
        self.completed: collections.deque = collections.deque(
            maxlen=max(8, _env_int("PATHWAY_REQUEST_TRACE_SPANS",
                                   _DEFAULT_TRACE_SPANS)))
        self.slow: collections.deque = collections.deque(
            maxlen=max(1, _env_int("PATHWAY_SLOW_QUERY_TAIL",
                                   _DEFAULT_SLOW_TAIL)))
        self._window: collections.deque = collections.deque(
            maxlen=max(16, _env_int("PATHWAY_SLO_WINDOW", _DEFAULT_WINDOW)))
        self.count = 0
        self.sum_ms = 0.0
        self.violations = 0
        self._e2e_q = {0.5: P2Quantile(0.5), 0.95: P2Quantile(0.95),
                       0.99: P2Quantile(0.99)}
        self._stage_p50 = {s: P2Quantile(0.5) for s in STAGES}
        self._stage_sum = {s: 0.0 for s in STAGES}

    # -- write side (stamping, in hand-off order) --------------------------
    def start(self, rid: str, route: str, t_ingress: float) -> RequestSpan:
        return RequestSpan(rid, route, t_ingress)

    def admission(self, span: RequestSpan) -> None:
        """The handler is about to enter the admission gate: everything
        before this stamp is parse/validate (``ingress_wait``); the gap to
        the enqueue stamp is ``admission_wait``. QoS is not ported, so the
        gate is a no-op and this is stamped immediately before the
        enqueue: the stage reads ~0, as in the JAX package with QoS off."""
        span.t_admission = time.perf_counter()

    def enqueued(self, span: RequestSpan, key) -> None:
        """Row built and about to be pushed; registers the engine key so
        drain/resolve can find the span. MUST run before session.push —
        the commit loop may drain the row immediately."""
        span.t_enqueued = time.perf_counter()
        span.key = key
        with self._lock:
            self._by_key[key] = span

    def picked_up(self, entries, tick: int) -> None:
        """The commit loop drained ``entries`` for the tick about to
        run. Called only for sessions of request-tracking sources, and
        only when requests are in flight."""
        if not self._by_key:
            return
        t = time.perf_counter()
        with self._lock:
            for key, _row, diff in entries:
                if diff <= 0:
                    continue  # delete_completed_queries retraction
                span = self._by_key.get(key)
                if span is not None and span.t_tick_start is None:
                    span.t_tick_start = t
                    span.tick = tick
                    self._by_tick.setdefault(tick, []).append(span)

    def active(self) -> bool:
        """Any request picked up and awaiting its host-leg stamp? One
        truthiness probe — the scheduler calls this every tick."""
        return bool(self._by_tick)

    def host_done(self, tick: int) -> None:
        """The scheduler finished ``tick``'s host leg (about to submit /
        step the device leg)."""
        if tick not in self._by_tick:
            return
        t = time.perf_counter()
        # under the lock: finish() on the event-loop thread removes spans
        # from this same list (a request resolved mid-tick), and an
        # unlocked iteration could skip a sibling span entirely
        with self._lock:
            for span in self._by_tick.get(tick, ()):
                if span.t_host_done is None:
                    span.t_host_done = t

    def resolved(self, key) -> None:
        """response_writer resolved ``key`` (host thread in synchronous
        mode, bridge worker under pipelining)."""
        span = self._by_key.get(key)
        if span is not None and span.t_resolved is None:
            span.t_resolved = time.perf_counter()

    def finish(self, span: RequestSpan) -> None:
        """Handler is returning (or unwinding). A resolved span completes
        and feeds the aggregates; an unresolved one (client disconnect,
        handler error) is abandoned without polluting the SLO numbers."""
        if span.t_resolved is None:
            self._discard(span)
            return
        span.t_responded = time.perf_counter()
        stages = span.stages_ms()
        e2e = (span.normalized_stamps()[-1] - span.t_ingress) * 1e3
        dominant = max(stages, key=stages.get)
        record = {
            "request_id": span.rid,
            "route": span.route,
            "tick": span.tick,
            "e2e_ms": round(e2e, 3),
            "stages": {k: round(v, 3) for k, v in stages.items()},
            "dominant_stage": dominant,
            "t0": span.t_ingress,
            "stamps": span.normalized_stamps(),
            "over_budget": e2e > self.slo_ms,
            "at": time.time(),
        }
        with self._lock:
            self._discard_locked(span)
            self.count += 1
            self.sum_ms += e2e
            self._window.append(e2e)
            for q in self._e2e_q.values():
                q.observe(e2e)
            for s, ms in stages.items():
                self._stage_sum[s] += ms
                self._stage_p50[s].observe(ms)
            self.completed.append(record)
            if record["over_budget"]:
                self.violations += 1
                self.slow.append(record)

    def _discard(self, span: RequestSpan) -> None:
        with self._lock:
            self._discard_locked(span)

    def _discard_locked(self, span: RequestSpan) -> None:
        if span.key is not None:
            cur = self._by_key.get(span.key)
            if cur is span:
                del self._by_key[span.key]
        if span.tick is not None:
            spans = self._by_tick.get(span.tick)
            if spans is not None:
                try:
                    spans.remove(span)
                except ValueError:
                    pass
                if not spans:
                    del self._by_tick[span.tick]

    # -- read side ---------------------------------------------------------
    def quantiles_ms(self) -> dict[float, float] | None:
        """{0.5: p50, 0.95: p95, 0.99: p99} in ms, None before the first
        completed request. Values are sorted so the exposed set is always
        monotone (independent P² estimators can cross transiently)."""
        with self._lock:
            vals = [q.value() for q in self._e2e_q.values()]
        if any(v is None for v in vals):
            return None
        vals.sort()
        return dict(zip(sorted(self._e2e_q), vals))

    def burn_rate(self) -> float:
        """Observed violation ratio over the sliding window, divided by
        the allowed error budget: 1.0 = burning exactly the budget,
        >1.0 = on track to exhaust it."""
        with self._lock:
            if not self._window:
                return 0.0
            viol = sum(1 for v in self._window if v > self.slo_ms)
            return (viol / len(self._window)) / self.error_budget

    def stage_summary(self) -> dict[str, dict]:
        with self._lock:
            return {
                s: {"p50_ms": self._stage_p50[s].value(),
                    "sum_ms": round(self._stage_sum[s], 3)}
                for s in STAGES
            }

    def slow_queries(self) -> list[dict]:
        """Last-N over-budget requests, oldest first, each naming its
        dominant stage."""
        with self._lock:
            return [dict(r, stages=dict(r["stages"])) for r in self.slow]

    def trace_spans(self) -> list[dict]:
        """Completed spans (bounded ring) with raw perf_counter stamps,
        for the flight recorder's trace and bench.py's count-based
        slicing."""
        with self._lock:
            return list(self.completed)

    def summary(self) -> dict:
        """Compact serving snapshot."""
        qs = self.quantiles_ms()
        with self._lock:
            inflight = len(self._by_key)
        out = {
            "requests": self.count,
            "inflight": inflight,
            "slo_ms": self.slo_ms,
            "error_budget": self.error_budget,
            "violations": self.violations,
            "burn_rate": round(self.burn_rate(), 3),
        }
        if qs is not None:
            out["e2e_ms"] = {"p50": round(qs[0.5], 3),
                             "p95": round(qs[0.95], 3),
                             "p99": round(qs[0.99], 3)}
            out["stages"] = {
                s: (None if v["p50_ms"] is None else round(v["p50_ms"], 3))
                for s, v in self.stage_summary().items()
            }
        return out
