"""Stream-windowing operators: buffer / forget / freeze / forget-immediately
— port of pathway_tpu/engine/temporal_ops.py.

They drive the temporal *behaviors* (stdlib/temporal): the watermark is the
largest event time seen in the designated time column, and each row's
threshold is an event-time value the behavior computes. ``BufferOperator``
holds rows until the watermark reaches their threshold, ``ForgetOperator``
retracts them once it passes, ``FreezeOperator`` drops late updates.

Under sharded execution (engine/graph.py) rows route by key and the
replicas of a watermark operator share one boxed watermark, global across
workers as a timely frontier is: the scheduler advances it from every
worker's input before any replica steps. Not ported: operator-state
snapshots (ROADMAP queue 1, item 6a).
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.delta import Delta, row_fingerprint
from pathway_tpu_torch.engine.operators import Exchange, Operator

NEG_INF = float("-inf")


def _no_snapshots(self, *args):
    raise NotImplementedError(
        "operator snapshots are not ported to pathway_tpu_torch yet "
        "(ROADMAP queue 1, item 6a)")


class ForgetImmediatelyOperator(Operator):
    """Pass rows through, retract them at the next processed timestamp —
    gives query streams as-of-now one-shot semantics."""

    snapshot_state = restore_state = _no_snapshots

    def __init__(self):
        self.queued = Delta()

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        out = Delta(self.queued.entries + delta.entries).consolidate()
        self.queued = delta.negate()
        return out


class FilterOutForgettingOperator(Operator):
    """Drop pure deletions (those not paired with a same-key insertion at the
    same time) so downstream results persist after upstream forgetting."""

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if not delta:
            return delta
        inserted_keys = {k for k, _, d in delta.entries if d > 0}
        return Delta([
            (k, r, d) for k, r, d in delta.entries
            if d > 0 or k in inserted_keys
        ])


class _WatermarkOp(Operator):
    snapshot_state = restore_state = _no_snapshots

    def __init__(self, threshold_fn: Callable, time_fn: Callable):
        self.threshold_fn = threshold_fn
        self.time_fn = time_fn
        # boxed, so that the sharded replicas share one global watermark
        self._wm_box: list = [NEG_INF]

    @property
    def watermark(self) -> Any:
        return self._wm_box[0]

    @watermark.setter
    def watermark(self, v: Any) -> None:
        self._wm_box[0] = v

    def exchange_specs(self):
        return [Exchange.BY_KEY]

    def replicate(self, n):
        reps = super().replicate(n)
        for r in reps[1:]:
            r._wm_box = self._wm_box
        return reps

    def _advance_watermark(self, delta: Delta) -> None:
        """Raise the watermark to the largest event time inserted."""
        self._advance_watermark_value(self._watermark_candidate(delta))

    def _watermark_candidate(self, delta: Delta) -> Any:
        """The largest event time a delta inserts (None: none): one
        worker's contribution to the global watermark."""
        best = None
        for key, row, diff in delta.entries:
            if diff > 0:
                t = self.time_fn(key, row)
                if t is not None and (best is None or _gt(t, best)):
                    best = t
        return best

    def _advance_watermark_value(self, v: Any) -> None:
        if v is not None and _gt(v, self.watermark):
            self.watermark = v


def _gt(a, b):
    if b is NEG_INF:
        return True
    try:
        return a > b
    except TypeError:
        return False


def _le(a, b):
    if b is NEG_INF:
        return False
    try:
        return a <= b
    except TypeError:
        return False


class BufferOperator(_WatermarkOp):
    """Delay rows until the watermark reaches their threshold
    (behavior ``delay`` — emit once per closed window instead of per update)."""

    def __init__(self, threshold_fn, time_fn):
        super().__init__(threshold_fn, time_fn)
        self.held: dict = {}  # (key, fingerprint) -> (key, row, count)

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        out = Delta()
        self._advance_watermark(delta)
        for key, row, diff in delta.entries:
            thr = self.threshold_fn(key, row)
            fp = (key, row_fingerprint(row))
            if fp in self.held:
                k, r, c = self.held[fp]
                c += diff
                if c == 0:
                    del self.held[fp]
                else:
                    self.held[fp] = (k, r, c)
            elif thr is not None and _gt(thr, self.watermark):
                if diff > 0:
                    self.held[fp] = (key, row, diff)
                else:
                    out.append(key, row, diff)  # retraction of a released row
            else:
                out.append(key, row, diff)
        # release anything whose threshold has now passed
        for fp, (key, row, c) in list(self.held.items()):
            thr = self.threshold_fn(key, row)
            if thr is None or _le(thr, self.watermark):
                out.append(key, row, c)
                del self.held[fp]
        return out.consolidate()

    def flush_all(self) -> Delta:
        out = Delta()
        for key, row, c in self.held.values():
            out.append(key, row, c)
        self.held.clear()
        return out

    def flush(self, time):
        return self.flush_all()


class ForgetOperator(_WatermarkOp):
    """Retract rows once the watermark passes their threshold (behavior
    ``cutoff`` — bounded state); late entries are never admitted."""

    def __init__(self, threshold_fn, time_fn, mark: bool = False):
        super().__init__(threshold_fn, time_fn)
        self.live: dict = {}
        self.mark = mark

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        out = Delta()
        self._advance_watermark(delta)
        for key, row, diff in delta.entries:
            thr = self.threshold_fn(key, row)
            if thr is not None and _le(thr, self.watermark) and diff > 0:
                continue  # late row: never admitted
            fp = (key, row_fingerprint(row))
            if diff > 0:
                self.live[fp] = (key, row, self.live.get(fp, (0, 0, 0))[2] + diff)
            else:
                if fp in self.live:
                    k, r, c = self.live[fp]
                    c += diff
                    if c <= 0:
                        del self.live[fp]
                    else:
                        self.live[fp] = (k, r, c)
                else:
                    # retraction of a row already forgotten (or never
                    # admitted): dropping it keeps multiplicities >= 0
                    continue
            out.append(key, row, diff)
        # forget expired state
        for fp, (key, row, c) in list(self.live.items()):
            thr = self.threshold_fn(key, row)
            if thr is not None and _le(thr, self.watermark):
                out.append(key, row, -c)
                del self.live[fp]
        return out.consolidate()


class FreezeOperator(_WatermarkOp):
    """Stop updating rows whose threshold passed the watermark: late inserts
    and retractions for frozen thresholds are dropped."""

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        out = Delta()
        self._advance_watermark(delta)
        for key, row, diff in delta.entries:
            thr = self.threshold_fn(key, row)
            if thr is not None and _le(thr, self.watermark):
                continue
            out.append(key, row, diff)
        return out
