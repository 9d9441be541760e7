"""Incremental operators over diff-deltas — port of
pathway_tpu/engine/operators.py, trimmed to the operators the batch path's
lowerings create (internals/runner.py).

Each operator consumes consolidated input deltas for one timestamp and
emits the exact output delta — the differential-dataflow contract —
scheduled by a host-side microbatch loop (engine/graph.py). Batched
columnar callables do the per-batch math; there is no per-row FFI in the
hot path.

Conventions:
- every table is keyed: ≤1 live row per key,
- ``step(time, in_deltas)`` is called once per node per timestamp,
- map/filter callables receive ``(keys: list[Pointer], rows: list[tuple])``
  and return batch results (lists / numpy arrays).

Not ported here: sharding (exchange specs, replicas), operator-state
snapshots, and the stateful operators of groupby, joins, dedupe, sort and
the temporal behaviors (ROADMAP queue 1, items 2c and 2d).
"""

from __future__ import annotations

from typing import Callable, Sequence

from pathway_tpu_torch.engine.delta import Arrangement, Delta, row_fingerprint
from pathway_tpu_torch.internals.keys import Pointer, hash_values


class Operator:
    arity = 1
    # True for ops whose step dispatches accelerator work (a batch UDF
    # with device=True): information only until the device bridge is
    # ported (ROADMAP queue 1, item 2b) — the scheduler steps every
    # operator serially on its own thread
    device_bound = False

    def step(self, time: int, in_deltas: list[Delta]) -> Delta:
        raise NotImplementedError

    def on_time_advance(self, time: int) -> Delta:
        """Called for every committed timestamp (even with no input) so
        buffering operators can release rows."""
        return Delta()

    def flush(self, time: int) -> Delta:
        """End-of-stream: release anything still held. Only called once,
        at the final flush tick."""
        return Delta()


class SourceOperator(Operator):
    """Fed externally by an input session; just passes its delta through."""

    arity = 0

    def __init__(self, name: str = "source"):
        self.name = name
        self.pending = Delta()

    def push(self, delta: Delta) -> None:
        self.pending.extend(delta.entries)

    def step(self, time, in_deltas):
        # consolidation here is load-bearing: a same-batch net-zero
        # (key,row) pair must cancel BEFORE operators/sinks see it —
        # order-sensitive reducers would otherwise record deleted values,
        # float sums drift, and sinks emit phantom insert/delete events
        out = self.pending.consolidate()
        self.pending = Delta()
        return out


class MapOperator(Operator):
    """Row-wise (batched) projection: select / expression tables
    (reference: expression_table, dataflow.rs:1258)."""

    def __init__(self, fn: Callable[[list, list], list]):
        self.fn = fn

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if not delta:
            return Delta()
        keys = delta.keys_list()
        rows = [r for _, r, _ in delta.entries]
        new_rows = self.fn(keys, rows)
        # contract: fn returns one TUPLE per row (compile_program and the
        # lowering's projections all do) — re-tupling was pure overhead
        return Delta([
            (k, nr, d)
            for (k, _, d), nr in zip(delta.entries, new_rows)
        ])


def _stable_row_fp(row: tuple) -> int:
    """Cross-process-stable row digest (hash_values: fixed blake2b salt),
    as the JAX package keys its cache — hash()-based row_fingerprint
    varies with the process hash seed for string cells."""
    return int(hash_values(*row))


class DeterministicMapOperator(MapOperator):
    """Map that caches outputs per key so retractions replay identical values
    even for non-deterministic fns (reference:
    map_named_with_consistent_deletions, dataflow/operators.rs:308)."""

    def __init__(self, fn):
        super().__init__(fn)
        self.cache: dict[tuple[Pointer, int], tuple] = {}

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if not delta:
            return Delta()
        out = Delta()
        to_eval = []
        for key, row, diff in delta.entries:
            ck = (key, _stable_row_fp(row))
            if diff < 0 and ck in self.cache:
                out.append(key, self.cache.pop(ck), diff)
            else:
                to_eval.append((key, row, diff, ck))
        if to_eval:
            keys = [k for k, _, _, _ in to_eval]
            rows = [r for _, r, _, _ in to_eval]
            new_rows = self.fn(keys, rows)
            for (key, _, diff, ck), nr in zip(to_eval, new_rows):
                nr = tuple(nr)
                if diff > 0:
                    self.cache[ck] = nr
                out.append(key, nr, diff)
        return out


class FilterOperator(Operator):
    def __init__(self, pred: Callable[[list, list], Sequence[bool]]):
        self.pred = pred

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if not delta:
            return Delta()
        keys = delta.keys_list()
        rows = [r for _, r, _ in delta.entries]
        mask = self.pred(keys, rows)
        return Delta([e for e, m in zip(delta.entries, mask) if m])


class ReindexOperator(Operator):
    """Re-key rows (with_id_from / reindex). New key computed from the row;
    collisions on the new key are a user error (like reference)."""

    def __init__(self, key_fn: Callable[[list, list], Sequence[Pointer]]):
        self.key_fn = key_fn

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if not delta:
            return Delta()
        keys = delta.keys_list()
        rows = [r for _, r, _ in delta.entries]
        new_keys = self.key_fn(keys, rows)
        return Delta([
            (nk, r, d) for (k, r, d), nk in zip(delta.entries, new_keys)
        ]).consolidate()


class FlattenOperator(Operator):
    """One row -> many rows (Table.flatten). fn(key,row) yields (new_key,new_row)."""

    def __init__(self, fn: Callable[[Pointer, tuple], list]):
        self.fn = fn

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        out = Delta()
        for key, row, diff in delta.entries:
            for nk, nr in self.fn(key, row):
                out.append(nk, tuple(nr), diff)
        return out.consolidate()


class BinaryKeyOperator(Operator):
    """Generic key-aligned binary combiner.

    Covers concat/update_rows/intersect/difference/restrict/having and
    same-universe column zipping: maintains both input arrangements, and for
    every affected key recomputes ``combine(left_row|None, right_row|None)``
    before and after the delta, emitting the difference. This is the
    host analogue of DD's arrange-both-sides + per-key recompute
    (reference: concat/update_rows via engine union ops, dataflow.rs).
    """

    arity = 2

    def __init__(self, combine: Callable[[tuple | None, tuple | None], tuple | None]):
        self.combine = combine
        self.left = Arrangement()
        self.right = Arrangement()

    def step(self, time, in_deltas):
        dl, dr = in_deltas
        if not dl and not dr:
            return Delta()
        affected: dict[Pointer, None] = {}
        for k, _, _ in dl.entries:
            affected[k] = None
        for k, _, _ in dr.entries:
            affected[k] = None
        old_out: dict[Pointer, tuple | None] = {}
        for k in affected:
            old_out[k] = self.combine(self.left.get(k), self.right.get(k))
        self.left.update(dl)
        self.right.update(dr)
        out = Delta()
        for k in affected:
            new = self.combine(self.left.get(k), self.right.get(k))
            old = old_out[k]
            if old is not None and (new is None or
                                    row_fingerprint(old) != row_fingerprint(new)):
                out.append(k, old, -1)
            if new is not None and (old is None or
                                    row_fingerprint(old) != row_fingerprint(new)):
                out.append(k, new, 1)
        return out


class NAryConcatOperator(Operator):
    """Disjoint-key union of N inputs (Table.concat). Raises on key overlap
    unless ``update`` (last input wins — update_rows semantics)."""

    def __init__(self, n: int, combine_rows: Callable[[list], tuple | None],
                 update: bool = False):
        self.arity = n
        self.states = [Arrangement() for _ in range(n)]
        self.combine_rows = combine_rows
        self.update = update

    def step(self, time, in_deltas):
        if not any(in_deltas):
            return Delta()
        affected: dict[Pointer, None] = {}
        for d in in_deltas:
            for k, _, _ in d.entries:
                affected[k] = None
        old = {k: self._combined(k) for k in affected}
        for st, d in zip(self.states, in_deltas):
            st.update(d)
        out = Delta()
        for k in affected:
            new = self._combined(k)
            o = old[k]
            if o is not None and (new is None or row_fingerprint(o) != row_fingerprint(new)):
                out.append(k, o, -1)
            if new is not None and (o is None or row_fingerprint(o) != row_fingerprint(new)):
                out.append(k, new, 1)
        return out

    def _combined(self, key):
        present = [st.get(key) for st in self.states]
        live = [r for r in present if r is not None]
        if not live:
            return None
        if len(live) > 1 and not self.update:
            raise KeyError(
                f"duplicate key {key!r} in concat of tables with overlapping "
                "universes; use update_rows or concat_reindex"
            )
        return self.combine_rows(present)


class OutputOperator(Operator):
    """Terminal capture: invokes callback(time, delta); passes delta through."""

    def __init__(self, callback: Callable[[int, Delta], None]):
        self.callback = callback

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if delta:
            self.callback(time, delta)
        return delta
