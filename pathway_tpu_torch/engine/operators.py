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
``ColumnarGroupByOperator`` (the groupbys the lowering finds columnar:
count, integral sum/avg, min/max, argmin/argmax over plain columns),
``JoinOperator`` (joins, ``ix``) and ``DeduplicateOperator``, with the
native passes of the inner bilinear join and of the columnar groupby
(``native/fastjoin.cpp``, ``native/fastgroup.cpp``, built with g++ at first
use; when a build fails, a warning is logged, ``NATIVE_ERRORS`` says why
and the Python loops run). Also ``SortOperator`` (``Table.sort``: prev/next
pointers) and ``ZipAlignedOperator`` (auto-jit's host/device map split);
the temporal behaviors' operators are in engine/temporal_ops.py.

Sharded execution (engine/graph.py, ``n_workers > 1``): each operator
states one ``Exchange`` spec per input and is replicated once per worker
(``replicate``); replicas share every device-resident object they reach
(``_device.ReplicaShared``). Not ported here: operator-state
snapshots (ROADMAP queue 1, item 6a).
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.engine.delta import (Arrangement, Delta,
                                            row_fingerprint, upsert_delta)
from pathway_tpu_torch.engine.reducers import _orderable, make_reducer_state
from pathway_tpu_torch.internals.keys import (Pointer, canonical_shard_value,
                                              hash_values, mix_pointers)


class Exchange:
    """Per-input exchange contracts for sharded execution (reference:
    src/engine/dataflow/shard.rs — keys route to workers by hash). A spec
    is one of:

    - ``None``: no data movement — the input is processed on whichever
      worker holds each row (stateless operators),
    - ``Exchange.BY_KEY``: route each entry by its row key,
    - ``Exchange.GATHER``: send everything to worker 0 (operators whose
      state cannot be partitioned),
    - ``Exchange.BROADCAST``: every worker sees the complete input delta
      (the external index's data stream),
    - a callable ``(key, row) -> routing value``: route by the hash of the
      returned value (join keys, group keys, instances).
    """

    BY_KEY = "by_key"
    GATHER = "gather"
    BROADCAST = "broadcast"


class Operator:
    arity = 1
    # False for ops whose replicas share mutable state (one device index):
    # their per-worker steps must not run on the thread pool
    parallel_safe = True
    # True for ops whose step dispatches accelerator work (a batch UDF
    # with device=True, a device-resident index): the scheduler runs them
    # and their downstream closure as the tick's device leg, on the device
    # bridge's worker when PATHWAY_DEVICE_INFLIGHT >= 2
    device_bound = False
    # consulted only for exchanged inputs (the sharded merge points in
    # graph.py): False for ops whose step is exact on unconsolidated input
    consolidate_inputs = True

    def step(self, time: int, in_deltas: list[Delta]) -> Delta:
        raise NotImplementedError

    def exchange_specs(self) -> list:
        """One exchange spec per input (see Exchange). Default: stateless —
        rows are processed wherever they already live."""
        return [None] * self.arity

    def replicate(self, n: int) -> list["Operator"]:
        """Return n worker replicas of this operator, self as worker 0.

        Called before any data has flowed (state empty), so a deepcopy
        clones configuration with fresh state. Functions are atomic to
        the copy (closures are shared by reference), and every
        ``ReplicaShared`` object the operator reaches (a UDF or embedder,
        an index, the graphed ingest step, the pinned staging) deep-copies
        to itself: no replica copies a model, an index or a CUDA graph."""
        return [self] + [copy.deepcopy(self) for _ in range(n - 1)]

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


class ZipAlignedOperator(Operator):
    """Stateless zip of two 1:1 projections of the SAME upstream delta.

    Built by the lowering's auto-jit host/device map split
    (internals/runner.py): both inputs are MapOperators over one input
    node, so each tick they emit the same keys with the same diffs in the
    same order — the recombination needs no arrangements, just a
    positional merge per the column spec ((side, pos), ...) with side 0 =
    left row, 1 = right row. Alignment is asserted, not assumed: a key or
    diff mismatch means an engine invariant broke, and wrong-but-plausible
    output would be strictly worse than a crash.

    Sharded (engine/graph.py, n workers): neither input is exchanged, so
    each worker's replica zips the host map's and the device map's
    outputs over that worker's own rows, which are aligned as at one
    worker; the replicas share nothing, so they may step on the pool."""

    arity = 2
    parallel_safe = True

    def __init__(self, spec: tuple):
        self.spec = tuple(spec)
        # the merge runs per row on the hot path: compile it once to a
        # C-level tuple build instead of interpreting the spec per cell
        cells = ", ".join(f"{'l' if side == 0 else 'r'}[{pos}]"
                          for side, pos in self.spec)
        self._combine = eval(  # noqa: S307 — generated from the int spec
            f"lambda l, r: ({cells}{',' if self.spec else ''})")

    def exchange_specs(self):
        return [None, None]

    def step(self, time, in_deltas):
        dl, dr = in_deltas
        if not dl and not dr:
            return Delta()
        if len(dl.entries) != len(dr.entries):
            raise RuntimeError(
                "auto-jit map split lost alignment: "
                f"{len(dl.entries)} host rows vs {len(dr.entries)} device "
                "rows in one tick")
        combine = self._combine
        out = []
        for (lk, lrow, ld), (rk, rrow, rd) in zip(dl.entries, dr.entries):
            if lk != rk or ld != rd:
                raise RuntimeError(
                    "auto-jit map split lost alignment: "
                    f"({lk!r}, {ld}) vs ({rk!r}, {rd})")
            out.append((lk, combine(lrow, rrow), ld))
        return Delta(out)


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

    def exchange_specs(self):
        return [Exchange.BY_KEY, Exchange.BY_KEY]

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

    def exchange_specs(self):
        return [Exchange.BY_KEY] * self.arity

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
        # ticks whose array_sum reducers went through device_segsum
        self.segsum_steps = 0

    def exchange_specs(self):
        # route rows to the worker owning their group (reference: group_by
        # exchanges by group key, dataflow.rs:2904)
        return [lambda key, row: self.group_fn(key, row)[0]]

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
        if handled:
            self.segsum_steps += 1
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


_FASTJOIN = False  # False = not probed, None = unavailable, module = loaded
_FASTGROUP = False
# why a native pass is not loaded ({"fastjoin": "NativeBuildError: ..."})
NATIVE_ERRORS: dict[str, str] = {}


def _load_pass(name: str):
    """Build and import ``native/<name>.cpp`` (native/build.py);
    None, with a warning and the reason in NATIVE_ERRORS, when it fails."""
    try:
        from pathway_tpu_torch.native.build import load_extension

        return load_extension(name)
    except Exception as e:  # no g++, no Python.h, read-only checkout, ...
        logging.getLogger("pathway_tpu_torch").warning(
            "native %s pass unavailable (%s); using the pure-Python engine "
            "loops", name, e)
        NATIVE_ERRORS[name] = f"{type(e).__name__}: {e}"
        return None


def _get_fastjoin():
    """The native inner-join pass (native/fastjoin.cpp), built on first
    use; None when it cannot be built (the Python loops run)."""
    global _FASTJOIN
    if _FASTJOIN is False:
        _FASTJOIN = _load_pass("fastjoin")
    return _FASTJOIN


def _get_fastgroup():
    """The native groupby gather/emit passes (native/fastgroup.cpp)."""
    global _FASTGROUP
    if _FASTGROUP is False:
        _FASTGROUP = _load_pass("fastgroup")
    return _FASTGROUP


def _rows_equal(a, b) -> bool:
    """Value equality of two rows; fingerprint fallback for rows whose
    cells don't support plain == (ndarrays)."""
    try:
        return bool(a == b)
    except Exception:
        return row_fingerprint(a) == row_fingerprint(b)


class ColumnarGroupByOperator(Operator):
    """Columnar groupby for dictionary-encodable group keys with
    count / integral sum / integral avg / min / max / argmin / argmax
    reducers.

    The row path (GroupByOperator) pays per-row Python: a 128-bit hash per
    row for the group key plus a dict probe and a state-object method call
    per reducer. Here a tick's delta is processed as arrays: group values
    are interned to dense int codes (one dict probe per row; the group key
    is hashed once per distinct group ever seen), the sums live in numpy
    int64 arrays indexed by code (``np.add.at`` scatter), and only the
    touched groups pay per-group Python at emit. Exact under retraction:
    every state update is additive, so any insert/retract order gives the
    same state.

    Chosen by the lowering only when every reducer is in the columnar set,
    no reducer is order-sensitive, and the group values come from plain
    columns of hashable scalar dtype (internals/runner.py
    ``_columnar_groupby_spec``); every other groupby keeps
    GroupByOperator. ``native_steps`` counts the steps the native passes
    ran.
    """

    _GROW = 1024
    _INT_GUARD = 1 << 62  # |sum| beyond this migrates to exact python ints
    consolidate_inputs = False  # purely additive array state

    def __init__(self, gval_pos: list, reducer_cols: list):
        # gval_pos: row positions of the group-value columns
        # reducer_cols: [("count", None) | ("sum"|"avg"|"min"|"max", pos)
        #                | ("argmin"|"argmax", (cmp_pos, payload_pos))]
        self.gval_pos = list(gval_pos)
        self.reducer_cols = list(reducer_cols)
        self.native_steps = 0
        # (slot, code) -> exact python-int total for groups whose sums
        # left the int64 guard range (the row path's _SumState is exact)
        self._big: dict = {}
        self._intern: dict = {}          # typed gval -> dense code
        self._by_gkey: dict = {}         # hashed gkey -> code (alias dedup)
        self._gvals: list[tuple] = []    # code -> group values
        self._gkeys: list[Pointer] = []  # code -> output key (hashed once)
        self._last: list = []            # code -> last emitted row | None
        self._cnt = np.zeros(0, np.int64)
        # value-bearing reducers share one extraction slot order (the C
        # gather returns one column per _val_pos entry; -1 extracts the
        # row key); sums/avgs also own an int64 state array,
        # min/max/argmin/argmax a per-group value-count multiset (exact
        # under retraction)
        self._val_slot: dict[int, int] = {}   # reducer -> cmp/value slot
        self._arg_slot: dict[int, int] = {}   # argminmax -> payload slot
        self._sum_slot: dict[int, int] = {}
        self._mm: dict[int, dict] = {}   # reducer idx -> {code: {val: n}}
        val_pos: list[int] = []
        for i, (kind, pos) in enumerate(reducer_cols):
            if kind == "count":
                continue
            if kind in ("argmin", "argmax"):
                cpos, ppos = pos
                self._val_slot[i] = len(val_pos)
                val_pos.append(cpos)
                self._arg_slot[i] = len(val_pos)
                val_pos.append(ppos)
                self._mm[i] = {}
                continue
            self._val_slot[i] = len(val_pos)
            val_pos.append(pos)
            if kind in ("sum", "avg"):
                self._sum_slot[i] = len(self._sum_slot)
            else:  # min / max
                self._mm[i] = {}
        self._sums = [np.zeros(0, np.int64) for _ in self._sum_slot]
        # the native passes' parameter tables (native/fastgroup.cpp)
        self._gp = tuple(self.gval_pos)
        self._val_pos = tuple(val_pos)
        self._kinds = tuple(
            0 if kind == "count" else (2 if kind == "avg" else 1)
            for kind, _ in reducer_cols)

    def exchange_specs(self):
        # route by the canonical group value: the scheduler's route cache
        # memoizes value -> worker, and canonicalization sends hash-equal
        # values (1, 1.0, np.int64(1): one group in _add_group) to one
        # worker. Tuples route through hash_values, whose encoding
        # collapses the same equivalences element-wise.
        if len(self.gval_pos) == 1:
            p = self.gval_pos[0]
            return [lambda key, row: canonical_shard_value(row[p])]
        ps = self.gval_pos
        return [lambda key, row: tuple(row[p] for p in ps)]

    def snapshot_state(self):
        raise NotImplementedError(
            "operator snapshots are not ported to pathway_tpu_torch yet "
            "(ROADMAP queue 1, item 6a)")

    def restore_state(self, state) -> None:
        raise NotImplementedError(
            "operator snapshots are not ported to pathway_tpu_torch yet "
            "(ROADMAP queue 1, item 6a)")

    def _add_group(self, tkey, gvals: tuple) -> int:
        # alias through the hashed key: distinct typed representations of
        # hash-equal values (1 vs 1.0, np.int64(5) vs 5) must share a
        # group, exactly as the row path's hash_values keying does
        gkey = hash_values(*gvals)
        code = self._by_gkey.get(gkey)
        if code is not None:
            self._intern[tkey] = code
            return code
        code = len(self._gvals)
        self._intern[tkey] = code
        self._by_gkey[gkey] = code
        self._gvals.append(gvals)
        self._gkeys.append(gkey)
        self._last.append(None)
        if code >= self._cnt.shape[0]:
            self._cnt = np.concatenate(
                [self._cnt, np.zeros(self._GROW, np.int64)])
            self._sums = [np.concatenate([s, np.zeros(self._GROW, np.int64)])
                          for s in self._sums]
        return code

    def _codes(self, entries) -> np.ndarray:
        get = self._intern.get
        add = self._add_group
        codes = np.empty(len(entries), np.int64)
        if len(self.gval_pos) == 1:
            p = self.gval_pos[0]
            for i, (_k, row, _d) in enumerate(entries):
                v = row[p]
                # typed key: bool-vs-int dict equality (True == 1) must not
                # merge groups the hash path keeps distinct
                tk = (v.__class__, v)
                c = get(tk)
                codes[i] = add(tk, (v,)) if c is None else c
        else:
            ps = self.gval_pos
            for i, (_k, row, _d) in enumerate(entries):
                gvals = tuple(row[p] for p in ps)
                tk = (tuple(v.__class__ for v in gvals), gvals)
                c = get(tk)
                codes[i] = add(tk, gvals) if c is None else c
        return codes

    def step(self, time, in_deltas):
        entries = in_deltas[0].entries
        if not entries:
            return Delta()
        n = len(entries)
        fg = _get_fastgroup()
        cols = None
        if fg is not None:
            codes_l, diffs_l, cols = fg.gather(
                entries, self._intern, self._add_group, self._gp,
                self._val_pos)
            codes = np.asarray(codes_l, np.int64)
            diffs = np.asarray(diffs_l, np.int64)
        else:
            codes = self._codes(entries)
            diffs = np.fromiter((e[2] for e in entries), np.int64, n)
        np.add.at(self._cnt, codes, diffs)
        touched = np.unique(codes)
        guard = self._INT_GUARD
        # min/max/argmin/argmax multisets: one dict update per entry
        # (exact retraction)
        for i, groups in self._mm.items():
            kind, pos = self.reducer_cols[i]
            if kind in ("argmin", "argmax"):
                cpos, ppos = pos
                if cols is not None:
                    cvals = cols[self._val_slot[i]]
                    pvals = cols[self._arg_slot[i]]
                else:
                    cvals = [e[1][cpos] for e in entries]
                    pvals = [e[0] if ppos < 0 else e[1][ppos]
                             for e in entries]
                vals = list(zip(cvals, pvals))
            else:
                vals = cols[self._val_slot[i]] if cols is not None else \
                    [e[1][pos] for e in entries]
            for c, v, d in zip(codes.tolist(), vals, diffs.tolist()):
                g = groups.get(c)
                if g is None:
                    g = groups[c] = {}
                nc = g.get(v, 0) + d
                if nc == 0:
                    del g[v]
                else:
                    g[v] = nc
        for i, slot in self._sum_slot.items():
            pos = self.reducer_cols[i][1]
            arr = self._sums[slot]
            vals = cols[self._val_slot[i]] if cols is not None else \
                [e[1][pos] for e in entries]
            try:
                col = np.asarray(vals, np.int64)
                # bound the whole tick's contribution so the int64 scatter
                # cannot wrap before the migration check runs
                fast = bool(np.abs(col).max(initial=0) < guard // (n + 1))
            except (TypeError, ValueError, OverflowError):
                fast = False  # None / non-int / giant cells
            if fast:
                np.add.at(arr, codes, col * diffs)
                if self._big:
                    # groups already migrated to exact python ints track
                    # their tick contribution here (their arr slot is dead)
                    big = self._big
                    for j, c in enumerate(codes.tolist()):
                        bk = (slot, c)
                        cur = big.get(bk)
                        if cur is not None:
                            big[bk] = cur + int(col[j]) * int(diffs[j])
                # inputs bounded by the guard and prior totals inside it,
                # so no wrap happened yet; migrate any group that just
                # left the guard range to exact python-int accumulation
                mx = self._sums[slot][touched]
                if np.abs(mx).max(initial=0) >= guard:
                    for c in touched[np.abs(mx) >= guard].tolist():
                        self._big.setdefault((slot, c), int(arr[c]))
            else:
                # exact slow path (as _SumState: python ints, None adds
                # nothing); groups cross into _big when they outgrow int64
                big = self._big
                for c, v, d in zip(codes.tolist(), vals, diffs.tolist()):
                    if v is None:
                        continue
                    bk = (slot, c)
                    cur = big.get(bk)
                    if cur is not None:
                        big[bk] = cur + d * int(v)
                        continue
                    total = int(arr[c]) + d * int(v)
                    if -guard < total < guard:
                        arr[c] = total
                    else:
                        big[bk] = total
        # emit: gather the touched groups' state as lists, then one pass
        # over the touched groups only (native when available)
        tl = touched.tolist()
        cnts = self._cnt[touched].tolist()
        pcols = []
        for i, (kind, _pos) in enumerate(self.reducer_cols):
            if kind == "count":
                pcols.append([])
            elif kind in ("min", "max"):
                groups = self._mm[i]
                agg = min if kind == "min" else max

                def mm_of(c, _g=groups, _agg=agg):
                    g = _g.get(c)
                    if not g:
                        return None
                    # net-negative counts (a retraction seen ahead of its
                    # insertion) are excluded, as the row path's
                    # _MultisetState.iter_args max(c, 0) excludes them
                    live = [v for v, cnt in g.items() if cnt > 0]
                    return _agg(live) if live else None

                pcols.append([mm_of(c) for c in tl])
            elif kind in ("argmin", "argmax"):
                groups = self._mm[i]
                agg = min if kind == "argmin" else max

                def am_of(c, _g=groups, _agg=agg):
                    g = _g.get(c)
                    if not g:
                        return None
                    # ties break by orderable payload, exactly the row
                    # path's _ArgMin/_ArgMaxState key functions
                    best = _agg(
                        ((cv, _orderable(pv), pv)
                         for (cv, pv), cnt in g.items() if cnt > 0),
                        default=None)
                    return best[2] if best is not None else None

                pcols.append([am_of(c) for c in tl])
            else:
                pcols.append(
                    self._sums[self._sum_slot[i]][touched].tolist())
        big = self._big
        if big:
            for i, (kind, _pos) in enumerate(self.reducer_cols):
                if kind not in ("sum", "avg"):
                    continue
                slot = self._sum_slot[i]
                col = pcols[i]
                for idx, c in enumerate(tl):
                    exact = big.get((slot, c))
                    if exact is not None:
                        col[idx] = exact
        if fg is not None:
            self.native_steps += 1
            out = Delta()
            out.entries = fg.emit(tl, cnts, self._kinds, pcols,
                                  self._gvals, self._gkeys, self._last)
            return out
        out = Delta()
        append = out.entries.append
        last = self._last
        gkeys = self._gkeys
        gvals = self._gvals
        for idx, code in enumerate(tl):
            c = cnts[idx]
            if c <= 0:
                new = None
            else:
                red = [c if kind == "count"
                       else (pcols[i][idx] / c if kind == "avg"
                             else pcols[i][idx])
                       for i, (kind, _p) in enumerate(self.reducer_cols)]
                new = (*gvals[code], *red)
            old = last[code]
            if old == new:
                continue
            gkey = gkeys[code]
            if old is not None:
                append((gkey, old, -1))
            if new is not None:
                append((gkey, new, 1))
            last[code] = new
        return out


class JoinOperator(Operator):
    """Inner/left/right/outer join (reference: join_tables, dataflow.rs:2276).

    ``lkey_fn/rkey_fn`` extract the join key from a row; by default the
    output id mixes the two side ids (``mix_pointers``); outer 'ears' appear
    when a side has no match. With the default key the delta is bilinear
    (ΔL⋈R_old + L_new⋈ΔR); a custom ``out_key_fn`` (``ix`` and
    ``join(..., id=...)`` key by one side's id) can collide across pairs,
    so those joins recompute every affected join-key group before and
    after and emit the difference — exact under arbitrary retraction.

    The inner bilinear join runs the native pass (native/fastjoin.cpp,
    ``_step_inner_native``; ``native_steps`` counts its steps) when it
    builds. ``out_spec`` is ``out_fn`` as a table the pass reads
    (((side, pos), ...): side 0 the left row, 1 the right row, 2 a key,
    pos 0 the left id, 1 the right id); ``lkey_pos`` / ``rkey_pos`` name a
    join key that is a plain column, which the pass reads inline (exact
    str / int / Pointer cells raw, every other cell through
    ``lkey_fb(v, key)`` / ``rkey_fb``, the lowering's key function).
    """

    arity = 2

    def __init__(self, mode: str, lkey_fn, rkey_fn,
                 out_fn: Callable[[Pointer | None, tuple | None,
                                   Pointer | None, tuple | None], tuple],
                 out_key_fn=None, out_spec: tuple | None = None,
                 lkey_pos: int | None = None, lkey_fb=None,
                 rkey_pos: int | None = None, rkey_fb=None):
        assert mode in ("inner", "left", "right", "outer")
        self.mode = mode
        self.lkey_fn = lkey_fn
        self.rkey_fn = rkey_fn
        self.out_fn = out_fn
        self.out_spec = out_spec
        self.lkey_pos = lkey_pos
        self.lkey_fb = lkey_fb
        self.rkey_pos = rkey_pos
        self.rkey_fb = rkey_fb
        self._bilinear = out_key_fn is None
        # only the inner bilinear path fuses same-tick retract + insert
        # pairs; other modes would forward an uncancelled net-zero pair to
        # sinks as phantom delete + insert events, so they keep
        # consolidation of their exchanged inputs
        self.consolidate_inputs = not (self._bilinear and mode == "inner")
        self.native_steps = 0
        # live (lk, rk) pairs recur every tick in dimension joins: a dict
        # probe beats re-mixing 128-bit ints per emitted row
        self._mix_cache: dict = {}
        self.out_key_fn = out_key_fn or self._default_out_key
        self.left: dict[Any, dict[Pointer, tuple]] = {}
        self.right: dict[Any, dict[Pointer, tuple]] = {}

    def exchange_specs(self):
        # both sides route by join key, so each key group is wholly owned
        # by one worker (reference: join exchanges, dataflow.rs:2276)
        return [lambda k, r: self.lkey_fn(k, r),
                lambda k, r: self.rkey_fn(k, r)]

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
        if self._bilinear and self.mode == "inner":
            fj = _get_fastjoin()
            if fj is not None:
                return self._step_inner_native(fj, dl, dr)
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

    def _step_inner_native(self, fj, dl: Delta, dr: Delta) -> Delta:
        """The inner bilinear delta through the native pass
        (native/fastjoin.cpp): the algorithm of ``_one_side_inner``, ΔL vs
        R_old then ΔR vs L_new. Raw delta entries go in when the join key
        is a plain column (``lkey_pos``); otherwise the keyed 4-tuples are
        built here and the pass skips extraction."""
        self.native_steps += 1
        spec = self.out_spec
        ofn = self.out_fn if spec is None else None
        out = Delta()
        ext = out.entries.extend
        for delta, key_pos, key_fb, key_fn, mine, other, flip in (
                (dl, self.lkey_pos, self.lkey_fb, self.lkey_fn,
                 self.left, self.right, False),
                (dr, self.rkey_pos, self.rkey_fb, self.rkey_fn,
                 self.right, self.left, True)):
            if not delta.entries:
                continue
            if key_pos is not None:
                entries, pos, fb = delta.entries, key_pos, key_fb
            else:
                entries = [(key_fn(k, r), k, r, d)
                           for k, r, d in delta.entries]
                pos, fb = -1, None
            ext(fj.one_side_inner(
                entries, mine, other, self._mix_cache, mix_pointers,
                Pointer, ofn, spec, flip, pos, fb))
        return out

    def _step_bilinear_inner(self, l_entries, r_entries) -> Delta:
        """Inner-mode bilinear delta: ΔL vs R_old, then ΔR vs L_new, with
        upsert-pair fusion (see _one_side_inner); the Python loops the
        native pass replaces."""
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

    def exchange_specs(self):
        # per-instance acceptance is order-sensitive: one worker owns each
        # instance (reference: deduplicate exchanges by instance)
        return [lambda k, r: self.instance_fn(k, r)]

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


class SortOperator(Operator):
    """prev/next pointers within (instance, sort-key) order: a change
    recomputes the neighbours of the instances it touches — O(n log n) a
    touched instance, correct under retraction."""

    def __init__(self, key_fn, instance_fn):
        self.key_fn = key_fn
        self.instance_fn = instance_fn
        self.instances: dict[Any, dict[Pointer, Any]] = {}
        self.out = Arrangement()

    def exchange_specs(self):
        # prev/next neighbours are computed within an instance: one worker
        # owns each instance (reference: operators/prev_next.rs)
        return [lambda k, r: self.instance_fn(k, r)]

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if not delta:
            return Delta()
        touched: dict[Any, None] = {}
        removed: list[Pointer] = []
        for key, row, diff in delta.entries:
            inst = self.instance_fn(key, row)
            grp = self.instances.setdefault(inst, {})
            if diff > 0:
                grp[key] = self.key_fn(key, row)
            else:
                if key in grp:
                    grp.pop(key)
                    removed.append(key)
            touched[inst] = None
        out = Delta()
        for key in removed:
            # only retract if the key wasn't re-inserted (possibly under
            # another instance) in this same delta
            if not any(key in g for g in self.instances.values()):
                upsert_delta(self.out, key, None, out)
        for inst in touched:
            grp = self.instances.get(inst, {})
            order = sorted(grp.items(),
                           key=lambda kv: (_sortable(kv[1]), int(kv[0])))
            for i, (key, _sk) in enumerate(order):
                prev_k = order[i - 1][0] if i > 0 else None
                next_k = order[i + 1][0] if i + 1 < len(order) else None
                upsert_delta(self.out, key, (prev_k, next_k), out)
        self.out.update(out)
        return out


def _sortable(v):
    if v is None:
        return (0, 0)
    if isinstance(v, (bool, int, float, np.integer, np.floating)):
        return (1, float(v))
    if isinstance(v, str):
        return (2, v)
    return (3, repr(v))


class OutputOperator(Operator):
    """Terminal capture: invokes callback(time, delta); passes delta through."""

    def __init__(self, callback: Callable[[int, Delta], None]):
        self.callback = callback

    def replicate(self, n):
        # every worker funnels into the same sink: share the callback (a
        # deepcopy of a bound method would clone its receiver, and the
        # replicas' outputs would vanish into the copy)
        return [self] + [OutputOperator(self.callback) for _ in range(n - 1)]

    def step(self, time, in_deltas):
        delta = in_deltas[0]
        if delta:
            self.callback(time, delta)
        return delta
