"""Monitoring levels and the per-operator stats monitor — port of
pathway_tpu/internals/monitoring.py, trimmed to what the streaming runtime
calls.

``pw.run(monitoring_level=...)`` gates a monitor that, once a second,
prints per-operator rows (insertions, retractions, last step latency),
the device bridge's counters, the auto-jit tier's dispatch mix and the
request tracker's serving quantiles to stderr as plain ``[monitor]``
lines. The JAX package renders the same
rows as a ``rich`` live dashboard; ``rich`` is not a dependency of the
port, so the plain lines are its only form here.
"""

from __future__ import annotations

import enum
import sys
import time


class MonitoringLevel(enum.Enum):
    AUTO = enum.auto()
    AUTO_ALL = enum.auto()
    NONE = enum.auto()
    IN_OUT = enum.auto()
    ALL = enum.auto()


class StatsMonitor:
    """Collects per-operator counters + latency from the scheduler and
    prints them (plain lines on stderr) at most once a
    ``refresh_seconds``."""

    def __init__(self, level: MonitoringLevel = MonitoringLevel.NONE,
                 refresh_seconds: float = 1.0):
        self.level = level
        self.refresh_seconds = refresh_seconds
        self._last_render = 0.0
        self._rows: list[tuple] = []
        self._lines: list[str] = []

    def enabled(self) -> bool:
        if self.level == MonitoringLevel.NONE:
            return False
        if self.level in (MonitoringLevel.AUTO, MonitoringLevel.AUTO_ALL):
            return sys.stderr.isatty()
        return True

    def _in_out_only(self) -> bool:
        return self.level in (MonitoringLevel.IN_OUT, MonitoringLevel.AUTO)

    def update(self, scheduler, graph, now_time: int) -> None:
        if not self.enabled():
            return
        now = time.monotonic()
        if now - self._last_render < self.refresh_seconds:
            return
        self._last_render = now
        self._rows = []
        for node in graph.nodes:
            st = scheduler.stats.get(node.id)
            if not st:
                continue
            if self._in_out_only() and not node.name.startswith(
                    ("source", "subscribe", "capture", "output")):
                continue
            self._rows.append((node.name or str(node.id),
                               st["insertions"], st["retractions"],
                               st.get("latency_ms", 0.0),
                               st.get("total_ms", 0.0)))
        self._lines = []
        bridge = scheduler.bridge_stats()
        if bridge is not None:
            # pipelined execution: in-flight depth, queue wait and overlap
            self._lines.append(
                f"device bridge: in-flight {bridge['depth']}/"
                f"{bridge['max_inflight']}  legs {bridge['legs_resolved']}/"
                f"{bridge['legs_dispatched']}  "
                f"overlap {bridge['overlap_ratio']:.0%}  "
                f"queue-wait {bridge['queue_wait_ms']:.0f}ms  "
                f"exec {bridge['exec_ms']:.0f}ms")
        self._lines += self._autojit_lines()
        self._lines += self._serving_lines(scheduler)
        self._render(now_time)

    @staticmethod
    def _autojit_lines() -> list[str]:
        """Fused-program dispatches (internals/autojit.py): whether the
        auto-jit tier carries batches and on which backend — a demotion
        shows here live."""
        from pathway_tpu_torch.internals.autojit import autojit_stats

        ajs = autojit_stats()
        if not ajs["programs"]:
            return []
        return [f"auto-jit: {ajs['programs']} fused program(s)  "
                f"torch {ajs['device_dispatches']} / "
                f"vector {ajs['vector_dispatches']} dispatches  "
                f"compiles {ajs['compiles']}  "
                f"demotions {ajs['demotions']}"]

    def _serving_lines(self, scheduler) -> list[str]:
        """The request tracker's serving snapshot: e2e quantiles, burn
        rate and the dominant stage's p50."""
        rec = scheduler.recorder
        tracker = rec.requests if rec is not None and rec.enabled else None
        if tracker is None or not tracker.count:
            return []
        s = tracker.summary()
        e2e = s.get("e2e_ms") or {}
        line = (f"serving: {s['requests']} requests  "
                f"p50 {e2e.get('p50', 0.0):.1f}ms  "
                f"p99 {e2e.get('p99', 0.0):.1f}ms  "
                f"SLO {s['slo_ms']:.0f}ms  burn {s['burn_rate']:.2f}")
        stages = {k: v for k, v in (s.get("stages") or {}).items()
                  if v is not None}
        if stages:
            worst = max(stages, key=stages.get)
            line += f"  dominant stage {worst} ({stages[worst]:.1f}ms p50)"
        return [line]

    def _render(self, now_time: int) -> None:
        for name, ins, rets, lat, _tot in self._rows:
            print(f"[monitor] t={now_time} {name}: +{ins} -{rets} "
                  f"{lat:.2f}ms", file=sys.stderr)
        for line in self._lines:
            print(f"[monitor] {line}", file=sys.stderr)

    def close(self) -> None:
        self._rows = []
        self._lines = []
