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

Also ported: ``GroupByOperator`` (with the array_sum segment sum on the
device, ``device_segsum``, off unless PATHWAY_ARRAY_SUM_DEVICE_MIN is set),
``JoinOperator`` (its pure-Python loops; ``ix``
lowers to it) and ``DeduplicateOperator``. Not ported here: sharding
(exchange specs, replicas), operator-state snapshots, the native
``fastjoin`` / ``fastgroup`` passes, ``ColumnarGroupByOperator`` (every
groupby lowers to ``GroupByOperator``, which emits the same events), and
the operators of sort and the temporal behaviors (ROADMAP queue 1, item
2d).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.engine.delta import (Arrangement, Delta,
                                            row_fingerprint, upsert_delta)
from pathway_tpu_torch.engine.reducers import make_reducer_state
from pathway_tpu_torch.internals.keys import Pointer, hash_values, mix_pointers


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


# a tick needs this many rows before its array_sum reducers are considered
# for the device segment sum
_ARRAY_SUM_MIN_ROWS = 64


def _array_sum_device_min() -> int:
    """Element count of a tick's array_sum rows above which they go through
    ``device_segsum`` instead of one numpy add per row
    (PATHWAY_ARRAY_SUM_DEVICE_MIN; 0, the default, disables the route).

    The JAX package's default is 2^20. Here, on an H100, the route's
    pre-pass (gather, pad, upload, adds, download) cost about as much as
    the per-row adds it saves, or several times more, at every tick
    measured (PERF.md, "array_sum route"): it gathers and pads every row
    in Python, which costs what the adds did."""
    return int(os.environ.get("PATHWAY_ARRAY_SUM_DEVICE_MIN", 0))


# where the route is on, it still skips the ticks it would make slower:
# the segment sum costs one add launch a row position of the longest group
# (M) and the upload of the padded (G, M, D) rows, so a long group, or a
# skewed tick whose padding outgrows its rows (one group of 128 rows
# beside 3,968 singletons pads to 744 MiB at D = 384), takes the per-row
# loop
_ARRAY_SUM_MAX_POSITIONS = 64
_ARRAY_SUM_MAX_PADDING = 2


def _segsum_pays(rows: int, groups: int, positions: int) -> bool:
    """True when a tick of ``rows`` rows in ``groups`` groups, the longest
    ``positions`` rows long, may take the device segment sum: no group
    longer than _ARRAY_SUM_MAX_POSITIONS rows, and padding to (groups,
    positions) at most _ARRAY_SUM_MAX_PADDING times the rows."""
    return (positions <= _ARRAY_SUM_MAX_POSITIONS
            and groups * positions <= _ARRAY_SUM_MAX_PADDING * rows)


def _array_sum_device() -> torch.device:
    """The device of the segment sum (tests patch it to the CPU)."""
    return resolve_device("cuda")


def device_segsum(padded: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """In-order segment sum: ``padded`` (G, M, D) holds the diff-weighted
    rows of G groups (row m of group g, padded with -0.0 past the group's
    length), ``init`` (G, D) each group's running total; returns the (G, D)
    totals.

    The port of the JAX package's ``_device_segsum_fn``, a ``lax.scan`` over
    the M axis: each group's rows are added one at a time in order, as the
    per-row numpy path does (``total = total + diff * v``). -0.0 is the
    exact IEEE additive identity, so the result is bit for bit the
    sequential host loop's. One float32 add per row position, no
    reassociation: this is not a kernel of its own."""
    acc = init.clone()
    for m in range(padded.shape[1]):
        acc.add_(padded[:, m])
    return acc


class GroupByOperator(Operator):
    """groupby().reduce() (reference: group_by_table, dataflow.rs:2904).

    ``group_fn(key,row) -> (group_key, group_vals)`` routes each input row to
    a group; ``reducer_specs`` is a list of
    ``(name, extract(key,row)->argtuple, kwargs)``. Emits per changed group a
    retraction of the old reduced row and the new one.
    """

    def __init__(self, group_fn, reducer_specs,
                 force_order_sensitive: bool = False):
        self.group_fn = group_fn
        self.reducer_specs = reducer_specs
        self.group_states: dict[Pointer, list] = {}   # gkey -> [states...]
        self.group_vals: dict[Pointer, tuple] = {}
        self.group_counts: dict[Pointer, int] = {}    # membership multiset size
        self.out = Arrangement()
        self.seq = 0
        # the other reducers are commutative: the canonical sort is only
        # needed for arrival-stamped and folded ones, and for float sums
        # (forced by the lowering: float addition is not associative)
        self._order_sensitive = force_order_sensitive or any(
            name in ("earliest", "latest", "stateful")
            for name, _, _ in reducer_specs)
        # "sum" too: an ndarray column summed by sum() takes the same route
        # (the first-row probe rejects scalar sums cheaply)
        self._array_sum_idx = [i for i, (name, _, _)
                               in enumerate(reducer_specs)
                               if name in ("array_sum", "sum")]

    def _device_array_sums(self, entries, routed):
        """One ``device_segsum`` per array_sum reducer for the whole tick
        instead of one numpy add per row. Returns {reducer_idx: {gkey:
        (total, count)}} for the reducers it handled; the others (mixed
        shapes, non-f32 dtypes, too few elements) and every reducer of a
        tick ``_segsum_pays`` turns down keep the per-row path."""
        threshold = _array_sum_device_min()
        if threshold <= 0:
            return {}
        # rows per group in entry order (canonically sorted by the caller
        # for float sums: the add order is part of the result)
        group_rows: dict[Pointer, list[int]] = {}
        counts: dict[Pointer, int] = {}
        for i, (_key, _row, diff) in enumerate(entries):
            gkey = routed[i][0]
            group_rows.setdefault(gkey, []).append(i)
            counts[gkey] = counts.get(gkey, 0) + diff
        gkeys = list(group_rows)
        m_b = max(len(v) for v in group_rows.values())
        if not _segsum_pays(len(entries), len(gkeys), m_b):
            return {}
        handled: dict[int, dict] = {}
        for idx in self._array_sum_idx:
            name, extract, _kw = self.reducer_specs[idx]
            # the element count is decidable from the first row's shape
            first = np.asarray(extract(*entries[0][:2])[0])
            shape = first.shape
            if not shape:
                # scalar sum(): the per-row path returns scalars, the
                # device route would emit 0-d arrays
                continue
            d = int(np.prod(shape))
            if first.dtype != np.float32 or len(entries) * d < threshold:
                continue
            arrs = [first]
            ok = True
            for key, row, _diff in entries[1:]:
                a = np.asarray(extract(key, row)[0])
                if a.dtype != np.float32 or a.shape != shape:
                    ok = False
                    break
                arrs.append(a)
            if not ok:
                continue
            # a running total that is not float32 (float64 rows summed by
            # earlier small ticks) keeps its dtype on the per-row path
            priors = {}
            for gkey in gkeys:
                states = self.group_states.get(gkey)
                prior = states[idx].total if states is not None else None
                if prior is not None:
                    prior = np.asarray(prior)
                    if prior.dtype != np.float32 or prior.shape != shape:
                        ok = False
                        break
                priors[gkey] = prior
            if not ok:
                continue
            # pad with -0.0, the exact additive identity (x + -0.0 == x
            # bitwise, -0.0 included; x + 0.0 would turn -0.0 into +0.0)
            padded = np.full((len(gkeys), m_b, d), -0.0, dtype=np.float32)
            # seed each group with its running total, so the sum continues
            # ((T + v_a) + v_b) as the per-row path does. A fresh group
            # starts as its state would: _ArraySumState at diff * v (seed
            # -0.0), _SumState at int 0 + diff * v (seed +0.0, so a -0.0
            # first value becomes +0.0 as numpy makes it)
            fresh_zero = np.float32(-0.0 if name == "array_sum" else 0.0)
            init = np.full((len(gkeys), d), fresh_zero, dtype=np.float32)
            for g, gkey in enumerate(gkeys):
                if priors[gkey] is not None:
                    init[g] = priors[gkey].reshape(-1)
                for p, i in enumerate(group_rows[gkey]):
                    diff = entries[i][2]
                    row_vec = arrs[i].reshape(-1)
                    padded[g, p] = row_vec if diff == 1 else diff * row_vec
            dev = _array_sum_device()
            totals = device_segsum(torch.from_numpy(padded).to(dev),
                                   torch.from_numpy(init).to(dev)
                                   ).cpu().numpy()
            handled[idx] = {
                gkey: (totals[g].reshape(shape), counts[gkey])
                for g, gkey in enumerate(gkeys)}
        return handled

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if not delta:
            return Delta()
        touched: dict[Pointer, None] = {}
        # canonical per-tick order (key, then retractions first, then row)
        # for the order-sensitive reducers
        if self._order_sensitive:
            entries = sorted(
                delta.entries,
                key=lambda e: (int(e[0]), e[2], row_fingerprint(e[1])))
        else:
            entries = delta.entries
        routed = None
        device_sums: dict[int, dict] = {}
        if self._array_sum_idx and len(entries) >= _ARRAY_SUM_MIN_ROWS:
            routed = [self.group_fn(key, row) for key, row, _ in entries]
            device_sums = self._device_array_sums(entries, routed)
        for i, (key, row, diff) in enumerate(entries):
            gkey, gvals = routed[i] if routed is not None \
                else self.group_fn(key, row)
            states = self.group_states.get(gkey)
            if states is None:
                states = [make_reducer_state(name, **kw)
                          for name, _, kw in self.reducer_specs]
                self.group_states[gkey] = states
                self.group_vals[gkey] = gvals
                self.group_counts[gkey] = 0
            self.group_counts[gkey] += diff
            for ri, (st, (name, extract, _kw)) in enumerate(
                    zip(states, self.reducer_specs)):
                if ri in device_sums:
                    continue  # the whole tick is summed on the device
                args = extract(key, row)
                if name in ("earliest", "latest"):
                    if diff > 0:
                        args = (*args, (time, self.seq))
                        self.seq += 1
                    else:
                        args = (*args, None)
                st.add(args, diff)
            touched[gkey] = None
        for ri, per_group in device_sums.items():
            for gkey, (total, count) in per_group.items():
                self.group_states[gkey][ri].set_total(total, count)
        out = Delta()
        for gkey in touched:
            states = self.group_states[gkey]
            if self.group_counts.get(gkey, 0) <= 0:
                new_row = None
                del self.group_states[gkey]
                self.group_vals.pop(gkey, None)
                self.group_counts.pop(gkey, None)
            else:
                gvals = self.group_vals[gkey]
                new_row = (*gvals, *[st.emit() for st in states])
            upsert_delta(self.out, gkey, new_row, out)
        self.out.update(out)
        return out


def _rows_equal(a, b) -> bool:
    """Value equality of two rows; fingerprint fallback for rows whose
    cells don't support plain == (ndarrays)."""
    try:
        return bool(a == b)
    except Exception:
        return row_fingerprint(a) == row_fingerprint(b)


class JoinOperator(Operator):
    """Inner/left/right/outer join (reference: join_tables, dataflow.rs:2276),
    the JAX package's pure-Python loops.

    ``lkey_fn/rkey_fn`` extract the join key from a row; by default the
    output id mixes the two side ids (``mix_pointers``); outer 'ears' appear
    when a side has no match. With the default key the delta is bilinear
    (ΔL⋈R_old + L_new⋈ΔR); a custom ``out_key_fn`` (``ix`` keys by the left
    id) can collide across pairs, so those joins recompute every affected
    join-key group before and after and emit the difference — exact under
    arbitrary retraction.
    """

    arity = 2

    def __init__(self, mode: str, lkey_fn, rkey_fn,
                 out_fn: Callable[[Pointer | None, tuple | None,
                                   Pointer | None, tuple | None], tuple],
                 out_key_fn=None):
        assert mode in ("inner", "left", "right", "outer")
        self.mode = mode
        self.lkey_fn = lkey_fn
        self.rkey_fn = rkey_fn
        self.out_fn = out_fn
        self._bilinear = out_key_fn is None
        # live (lk, rk) pairs recur every tick in dimension joins: a dict
        # probe beats re-mixing 128-bit ints per emitted row
        self._mix_cache: dict = {}
        self.out_key_fn = out_key_fn or self._default_out_key
        self.left: dict[Any, dict[Pointer, tuple]] = {}
        self.right: dict[Any, dict[Pointer, tuple]] = {}

    def _default_out_key(self, lkey, rkey, jk):
        ck = (lkey, rkey)
        p = self._mix_cache.get(ck)
        if p is None:
            p = mix_pointers(lkey, rkey)
            if len(self._mix_cache) < (1 << 20):
                self._mix_cache[ck] = p
        return p

    def _group_out(self, jk) -> dict[Pointer, tuple]:
        lg = self.left.get(jk) or {}
        rg = self.right.get(jk) or {}
        out: dict[Pointer, tuple] = {}
        if lg and rg:
            for lk, lrow in lg.items():
                for rk, rrow in rg.items():
                    out[self.out_key_fn(lk, rk, jk)] = self.out_fn(lk, lrow, rk, rrow)
        if self.mode in ("left", "outer") and lg and not rg:
            for lk, lrow in lg.items():
                out[self.out_key_fn(lk, None, jk)] = self.out_fn(lk, lrow, None, None)
        if self.mode in ("right", "outer") and rg and not lg:
            for rk, rrow in rg.items():
                out[self.out_key_fn(None, rk, jk)] = self.out_fn(None, None, rk, rrow)
        return out

    @staticmethod
    def _apply(index, jk, key, row, diff):
        grp = index.setdefault(jk, {})
        if diff > 0:
            grp[key] = row
        else:
            grp.pop(key, None)
            if not grp:
                index.pop(jk, None)

    def step(self, time, in_deltas):
        dl, dr = in_deltas
        if not dl and not dr:
            return Delta()
        l_entries = [(self.lkey_fn(k, r), k, r, d) for k, r, d in dl.entries]
        r_entries = [(self.rkey_fn(k, r), k, r, d) for k, r, d in dr.entries]
        if self._bilinear:
            return self._step_bilinear(l_entries, r_entries)
        affected: dict[Any, None] = {}
        for jk, _, _, _ in l_entries:
            affected[jk] = None
        for jk, _, _, _ in r_entries:
            affected[jk] = None
        affected.pop(None, None)  # null join keys never match
        old = {jk: self._group_out(jk) for jk in affected}
        for jk, k, r, d in l_entries:
            if jk is not None:
                self._apply(self.left, jk, k, r, d)
        for jk, k, r, d in r_entries:
            if jk is not None:
                self._apply(self.right, jk, k, r, d)
        out = Delta()
        for jk in affected:
            new = self._group_out(jk)
            o = old[jk]
            for okey, orow in o.items():
                n = new.get(okey)
                if n is None or row_fingerprint(n) != row_fingerprint(orow):
                    out.append(okey, orow, -1)
            for okey, nrow in new.items():
                oo = o.get(okey)
                if oo is None or row_fingerprint(oo) != row_fingerprint(nrow):
                    out.append(okey, nrow, 1)
        return out.consolidate()

    def _emit_left(self, out, jk, lk, lrow, sign) -> None:
        """Output delta for one left row vs the CURRENT right state."""
        rg = self.right.get(jk)
        if rg:
            append = out.entries.append
            okey, ofn = self.out_key_fn, self.out_fn
            for rk, rrow in rg.items():
                append((okey(lk, rk, jk), ofn(lk, lrow, rk, rrow), sign))
        elif self.mode in ("left", "outer"):
            out.append(self.out_key_fn(lk, None, jk),
                       self.out_fn(lk, lrow, None, None), sign)

    def _emit_right(self, out, jk, rk, rrow, sign) -> None:
        lg = self.left.get(jk)
        if lg:
            append = out.entries.append
            okey, ofn = self.out_key_fn, self.out_fn
            for lk, lrow in lg.items():
                append((okey(lk, rk, jk), ofn(lk, lrow, rk, rrow), sign))
        elif self.mode in ("right", "outer"):
            out.append(self.out_key_fn(None, rk, jk),
                       self.out_fn(None, None, rk, rrow), sign)

    def _step_bilinear(self, l_entries, r_entries) -> Delta:
        """Exact incremental join delta: ΔL⋈R_old + L_new⋈ΔR (+ ear
        emptiness transitions for left/right/outer).

        State applies entry by entry, as the recompute path's dicts do: an
        insert over a live row is an upsert (old outputs retracted first,
        nothing if the row is unchanged) and a retraction of an absent row
        emits nothing."""
        if self.mode == "inner":
            return self._step_bilinear_inner(l_entries, r_entries)
        out = Delta()
        left_ear = self.mode in ("left", "outer")
        right_ear = self.mode in ("right", "outer")
        fp = row_fingerprint
        # left-group emptiness transitions flip right-side ears; snapshot
        # before ΔL applies
        if right_ear:
            l_empty_old: dict[Any, bool] = {}
            for jk, _, _, _ in l_entries:
                if jk is not None and jk not in l_empty_old:
                    l_empty_old[jk] = jk not in self.left
        # ΔL against R_old, left state applied as we go
        for jk, lk, lrow, d in l_entries:
            if jk is None:
                continue
            lg = self.left.get(jk)
            cur = lg.get(lk) if lg else None
            if d > 0:
                if cur is not None:
                    if fp(cur) == fp(lrow):
                        continue  # duplicate upsert: outputs unchanged
                    self._emit_left(out, jk, lk, cur, -1)
                self._emit_left(out, jk, lk, lrow, 1)
                self._apply(self.left, jk, lk, lrow, 1)
            else:
                if cur is None:
                    continue  # retraction of an absent row: no-op
                self._emit_left(out, jk, lk, cur, -1)
                self._apply(self.left, jk, lk, lrow, -1)
        if right_ear:
            for jk, was_empty in l_empty_old.items():
                if (jk not in self.left) != was_empty:
                    rg = self.right.get(jk)
                    if rg:
                        sign = -1 if was_empty else 1
                        okey, ofn = self.out_key_fn, self.out_fn
                        for rk, rrow in rg.items():
                            out.append(okey(None, rk, jk),
                                       ofn(None, None, rk, rrow), sign)
        # ΔR against L_new, right state applied as we go
        if left_ear:
            r_empty_old: dict[Any, bool] = {}
            for jk, _, _, _ in r_entries:
                if jk is not None and jk not in r_empty_old:
                    r_empty_old[jk] = jk not in self.right
        for jk, rk, rrow, d in r_entries:
            if jk is None:
                continue
            rg = self.right.get(jk)
            cur = rg.get(rk) if rg else None
            if d > 0:
                if cur is not None:
                    if fp(cur) == fp(rrow):
                        continue
                    self._emit_right(out, jk, rk, cur, -1)
                self._emit_right(out, jk, rk, rrow, 1)
                self._apply(self.right, jk, rk, rrow, 1)
            else:
                if cur is None:
                    continue
                self._emit_right(out, jk, rk, cur, -1)
                self._apply(self.right, jk, rk, rrow, -1)
        # right-group emptiness transitions flip left-side ears (vs L_new)
        if left_ear:
            for jk, was_empty in r_empty_old.items():
                if (jk not in self.right) != was_empty:
                    lg = self.left.get(jk)
                    if lg:
                        sign = -1 if was_empty else 1
                        okey, ofn = self.out_key_fn, self.out_fn
                        for lk, lrow in lg.items():
                            out.append(okey(lk, None, jk),
                                       ofn(lk, lrow, None, None), sign)
        # not consolidated: the emissions are exact multiset deltas already
        return out

    def _one_side_inner(self, entries, my_index, other_index, flip):
        """One bilinear pass of the inner mode. An adjacent retract + insert
        of the same (jk, row key) — how a groupby's churn arrives — is
        fused into one upsert."""
        out_entries: list = []
        append = out_entries.append
        eq = _rows_equal
        okey, ofn = self.out_key_fn, self.out_fn
        i, n = 0, len(entries)
        while i < n:
            jk, k, row, d = entries[i]
            i += 1
            if jk is None:
                continue
            grp = my_index.get(jk)
            cur = grp.get(k) if grp else None
            if d > 0:
                if cur is not None:
                    if eq(cur, row):
                        continue  # duplicate upsert: outputs unchanged
                    og = other_index.get(jk)
                    if og:
                        for ok_, orow in og.items():
                            if flip:
                                key = okey(ok_, k, jk)
                                append((key, ofn(ok_, orow, k, cur), -1))
                                append((key, ofn(ok_, orow, k, row), 1))
                            else:
                                key = okey(k, ok_, jk)
                                append((key, ofn(k, cur, ok_, orow), -1))
                                append((key, ofn(k, row, ok_, orow), 1))
                    grp[k] = row
                else:
                    og = other_index.get(jk)
                    if og:
                        if flip:
                            for ok_, orow in og.items():
                                append((okey(ok_, k, jk),
                                        ofn(ok_, orow, k, row), 1))
                        else:
                            for ok_, orow in og.items():
                                append((okey(k, ok_, jk),
                                        ofn(k, row, ok_, orow), 1))
                    self._apply(my_index, jk, k, row, 1)
            else:
                if cur is None:
                    continue  # retraction of an absent row: no-op
                nxt = None
                if i < n:
                    jk2, k2, row2, d2 = entries[i]
                    if d2 > 0 and k2 == k and jk2 == jk:
                        nxt = row2
                        i += 1
                if nxt is not None:
                    if eq(cur, nxt):
                        continue  # value unchanged: no outputs, no state
                    og = other_index.get(jk)
                    if og:
                        for ok_, orow in og.items():
                            if flip:
                                key = okey(ok_, k, jk)
                                append((key, ofn(ok_, orow, k, cur), -1))
                                append((key, ofn(ok_, orow, k, nxt), 1))
                            else:
                                key = okey(k, ok_, jk)
                                append((key, ofn(k, cur, ok_, orow), -1))
                                append((key, ofn(k, nxt, ok_, orow), 1))
                    grp[k] = nxt
                else:
                    og = other_index.get(jk)
                    if og:
                        if flip:
                            for ok_, orow in og.items():
                                append((okey(ok_, k, jk),
                                        ofn(ok_, orow, k, cur), -1))
                        else:
                            for ok_, orow in og.items():
                                append((okey(k, ok_, jk),
                                        ofn(k, cur, ok_, orow), -1))
                    self._apply(my_index, jk, k, row, -1)
        return out_entries

    def _step_bilinear_inner(self, l_entries, r_entries) -> Delta:
        """Inner-mode bilinear delta: ΔL vs R_old, then ΔR vs L_new, with
        upsert-pair fusion (see _one_side_inner)."""
        out = Delta()
        if l_entries:
            out.entries.extend(
                self._one_side_inner(l_entries, self.left, self.right,
                                     flip=False))
        if r_entries:
            out.entries.extend(
                self._one_side_inner(r_entries, self.right, self.left,
                                     flip=True))
        return out


class DeduplicateOperator(Operator):
    """pw.Table.deduplicate (reference: deduplicate, dataflow.rs:3013):
    per instance keep one accepted value; ``acceptor(new, old) -> bool``
    decides replacement. Append-only w.r.t. input deletions (ignored)."""

    def __init__(self, instance_fn, value_fn, acceptor):
        self.instance_fn = instance_fn
        self.value_fn = value_fn
        self.acceptor = acceptor
        self.state: dict[Any, tuple[Pointer, tuple]] = {}

    def step(self, time, in_deltas):
        from pathway_tpu_torch.internals.error import global_error_log

        delta = in_deltas[0]
        out = Delta()
        # canonical per-tick order (by key): acceptance is order-sensitive
        for key, row, diff in sorted(
                delta.entries, key=lambda e: int(e[0])):
            if diff <= 0:
                continue  # deduplicate consumes append-only streams
            inst = self.instance_fn(key, row)
            new_val = self.value_fn(key, row)
            cur = self.state.get(inst)
            if cur is None:
                accept = True
            else:
                old_val = self.value_fn(cur[0], cur[1])
                try:
                    accept = bool(self.acceptor(new_val, old_val))
                except Exception as e:
                    global_error_log().log(
                        f"deduplicate acceptor raised: {e!r}", "deduplicate")
                    accept = False
            if accept:
                gkey = hash_values("dedup", inst)
                if cur is not None:
                    out.append(gkey, cur[1], -1)
                self.state[inst] = (key, row)
                out.append(gkey, row, 1)
        return out.consolidate()


class OutputOperator(Operator):
    """Terminal capture: invokes callback(time, delta); passes delta through."""

    def __init__(self, callback: Callable[[int, Delta], None]):
        self.callback = callback

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if delta:
            self.callback(time, delta)
        return delta
