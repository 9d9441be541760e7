"""Lowering + execution: Table plans → engine graph → microbatch run —
port of pathway_tpu/internals/runner.py.

Walks the plan DAG reachable from requested outputs, compiles expressions
against row layouts, builds engine operators, then drives the scheduler
over logical times: ``run_batch`` over the static feeds, or the streaming
runtime (engine/streaming.py, through ``pw.run``) over the streaming
sources that ``_lower_input`` collects in ``_stream_subjects``. Lowered:
static, input, identity, map, filter, filter_raw (remove_errors),
reindex, flatten, concat, concat_reindex, update_cells, groupby (every
groupby to ``GroupByOperator``), dedupe, ix (a ``JoinOperator`` keyed by
the left id) and external_index (the as-of-now index operator,
engine/index_ops.py). Not ported: auto-jit's host/device map split, and
the temporal, sort and join lowerings — a plan of those kinds raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import operators as eng
from pathway_tpu_torch.engine.delta import Delta
from pathway_tpu_torch.engine.graph import (CapturedStream, EngineGraph,
                                            Node, Scheduler)
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.expression_compiler import (
    CompileContext,
    ExpressionCompiler,
    compile_map_program,
)
from pathway_tpu_torch.internals.groupbys import split_reducers
from pathway_tpu_torch.internals.keys import Pointer, hash_values, mix_pointers
from pathway_tpu_torch.internals.table import _DSL_REST, Plan, Table
from pathway_tpu_torch.internals.type_inference import infer_dtype


class _Proxy:
    """Synthetic table for rewritten row spaces (groupby results)."""

    def __init__(self, names):
        self._names = list(names)

    def _column_names(self):
        return self._names


def _referenced_tables(exprs, base: Table) -> list[Table]:
    """All concrete tables appearing in exprs, base first."""
    seen: dict[int, Table] = {id(base): base}
    order = [base]

    def walk(e):
        if isinstance(e, ex.ColumnReference) and isinstance(e.table, Table):
            if id(e.table) not in seen:
                seen[id(e.table)] = e.table
                order.append(e.table)
        for d in getattr(e, "_deps", ()):
            walk(d)

    for e in exprs:
        walk(e)
    return order


def _map_op_for(program, nondet: bool):
    """Map operator for a compiled program; device-dispatching programs
    (batch UDFs with device=True, e.g. the encoder embedder) mark the
    operator device_bound, so the scheduler runs it in the tick's device
    leg (engine/device_bridge.py)."""
    op = eng.DeterministicMapOperator(program) if nondet \
        else eng.MapOperator(program)
    if getattr(program, "device_bound", False):
        op.device_bound = True
    return op


class GraphRunner:
    def __init__(self):
        self.graph = EngineGraph()
        self._memo: dict[int, Node] = {}
        # (node, {time: [(key, row, diff)]}) — pre-grouped at lowering so
        # run startup does not rescan whole feeds row by row
        self._static_feeds: list[tuple[Node, dict]] = []
        # (node, DataSource) of every streaming source, read by the
        # streaming runtime (engine/streaming.py)
        self._stream_subjects: list[tuple[Node, Any]] = []

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def capture(self, table: Table) -> CapturedStream:
        node = self.lower(table)
        cap = CapturedStream()
        self.graph.add_node(eng.OutputOperator(cap.on_delta), [node], "capture")
        return cap

    def subscribe(self, table: Table,
                  callback: Callable[[int, Delta], None]) -> None:
        node = self.lower(table)
        self.graph.add_node(eng.OutputOperator(callback), [node], "subscribe")

    def run_batch(self, n_workers: int = 1, recorder=None) -> None:
        """Run all static feeds to completion (batch mode: one pass over the
        totally-ordered times present in the inputs + a flush tick). The
        device legs run on the device bridge at ``PATHWAY_DEVICE_INFLIGHT``'s
        window (default 2; 1 steps every operator on the calling thread);
        the flush tick waits for every leg, and a leg's failure re-raises
        here. The scheduler stays as ``_scheduler``, its bridge closed, so
        ``bridge_stats()`` reads after the run. ``n_workers`` other than 1
        raises ``NotImplementedError`` (ROADMAP queue 1, item 2d).

        ``recorder`` threads a flight recorder through the scheduler
        (engine/flight_recorder.py); when omitted, the environment
        (``PATHWAY_TRACE_PATH`` / ``PATHWAY_FLIGHT_RECORDER``) decides —
        by default there is none."""
        if recorder is None:
            from pathway_tpu_torch.engine.flight_recorder import \
                FlightRecorder

            recorder = FlightRecorder.from_env()
        sched = Scheduler(self.graph, n_workers=n_workers,
                          recorder=recorder)
        by_time, feed_times = self.static_feeds_by_time()
        times = {0} | feed_times
        try:
            for t in sorted(times):
                for node, groups in by_time:
                    batch = groups.get(t)
                    if batch:
                        sched.push_source(node, Delta(batch))
                sched.run_time(t)
            # end-of-stream flush tick: buffering operators release rows
            sched.run_time(max(times) + 1, flush=True)
        finally:
            sched.close()
            self._scheduler = sched
            if recorder is not None:
                # the trace survives a failing run: it is the post-mortem
                try:
                    recorder.write_chrome_trace()
                except Exception:
                    pass

    def static_feeds_by_time(self):
        """Feeds are stored pre-grouped by logical time (see _lower_static).
        Returns ([(node, {time: [(k, r, d)]})], set_of_times)."""
        times: set[int] = set()
        for _node, groups in self._static_feeds:
            times.update(groups)
        return self._static_feeds, times

    # ------------------------------------------------------------------
    # lowering
    # ------------------------------------------------------------------
    def lower(self, table: Table) -> Node:
        key = id(table)
        if key in self._memo:
            return self._memo[key]
        plan = table._plan
        handler = getattr(self, f"_lower_{plan.kind}", None)
        if handler is None:
            raise NotImplementedError(
                f"no lowering for plan kind {plan.kind!r} in "
                f"pathway_tpu_torch yet ({_DSL_REST})")
        node = handler(table, plan)
        if node.trace is None:
            node.trace = plan.trace
        self._memo[key] = node
        return node

    # -- helpers ------------------------------------------------------------
    def _row_space(self, base: Table, exprs: list) -> tuple[Node, CompileContext]:
        """Node producing zipped rows of all tables referenced by exprs,
        with a CompileContext mapping references to positions."""
        tables = _referenced_tables(exprs, base)
        ctx = CompileContext()
        node = self.lower(tables[0])
        offset = ctx.add_table(tables[0], 0)
        for t in tables[1:]:
            right = self.lower(t)
            left_len = offset
            right_len = len(t._column_names())

            def combine(l, r, _ll=left_len, _rl=right_len):
                if l is None or r is None:
                    return None
                return (*l, *r)

            node = self.graph.add_node(
                eng.BinaryKeyOperator(combine), [node, right], "zip"
            )
            offset = ctx.add_table(t, offset)
        return node, ctx

    # -- sources ------------------------------------------------------------
    def _lower_static(self, table: Table, plan: Plan) -> Node:
        node = self.graph.add_source(table._name)
        keys = plan.params["keys"]
        rows = plan.params["rows"]
        times = plan.params.get("times")
        diffs = plan.params.get("diffs") or [1] * len(keys)
        groups: dict[int, list] = {}
        if times is None:
            groups[0] = [(k, tuple(r), d)
                         for k, r, d in zip(keys, rows, diffs)]
        else:
            for t, k, r, d in zip(times, keys, rows, diffs):
                g = groups.get(t)
                if g is None:
                    g = groups[t] = []
                g.append((k, tuple(r), d))
        self._static_feeds.append((node, groups))
        return node

    def _lower_input(self, table: Table, plan: Plan) -> Node:
        node = self.graph.add_source(table._name)
        self._stream_subjects.append((node, plan.params["datasource"]))
        return node

    def _lower_identity(self, table: Table, plan: Plan) -> Node:
        return self.lower(plan.params["base"])

    # -- row ops ------------------------------------------------------------
    def _lower_map(self, table: Table, plan: Plan) -> Node:
        base = plan.params["base"]
        exprs = plan.params["exprs"]
        node, ctx = self._row_space(base, exprs)
        program, nondet = compile_map_program(exprs, ctx)
        return self.graph.add_node(_map_op_for(program, nondet), [node],
                                   f"map:{table._name}")

    def _lower_filter(self, table: Table, plan: Plan) -> Node:
        base = plan.params["base"]
        pred = plan.params["pred"]
        node, ctx = self._row_space(base, [pred])
        comp = ExpressionCompiler(ctx)
        # keep base row shape: need projection back to base columns if zipped
        pred_fn = comp.compile_predicate(pred)
        n_base = len(base._column_names())

        def keep_base(keys, rows):
            return [r[:n_base] for r in rows]

        filt = self.graph.add_node(eng.FilterOperator(pred_fn), [node], "filter")
        if len(_referenced_tables([pred], base)) > 1:
            return self.graph.add_node(eng.MapOperator(keep_base), [filt], "proj")
        return filt

    def _lower_filter_raw(self, table: Table, plan: Plan) -> Node:
        """Filter with a prebuilt batch predicate fn(keys, rows) -> [bool]
        (Table.remove_errors)."""
        base = self.lower(plan.params["base"])
        return self.graph.add_node(
            eng.FilterOperator(plan.params["pred_fn"]), [base], "filter_raw")

    def _lower_reindex(self, table: Table, plan: Plan) -> Node:
        base = plan.params["base"]
        key_exprs = plan.params["key_exprs"]
        node, ctx = self._row_space(base, key_exprs)
        comp = ExpressionCompiler(ctx)
        if plan.params.get("raw"):
            vfn = comp.compile(key_exprs[0])

            def key_fn(keys, rows):
                out = []
                for v in vfn(keys, rows):
                    if not isinstance(v, Pointer):
                        v = hash_values(v)
                    out.append(v)
                return out
        else:
            key_fn = comp.compile_key_fn(key_exprs)
        n_base = len(base._column_names())
        reindexed = self.graph.add_node(
            eng.ReindexOperator(key_fn), [node], "reindex")
        if len(_referenced_tables(key_exprs, base)) > 1:
            return self.graph.add_node(
                eng.MapOperator(lambda keys, rows: [r[:n_base] for r in rows]),
                [reindexed], "proj")
        return reindexed

    # -- groupby ------------------------------------------------------------
    def _lower_groupby(self, table: Table, plan: Plan) -> Node:
        base: Table = plan.params["base"]
        by = plan.params["by"]
        instance = plan.params["instance"]
        out_exprs = plan.params["out_exprs"]
        use_raw_key = bool(plan.params.get("by_id", False))

        gvals_exprs = list(by)
        if instance is not None:
            gvals_exprs.append(instance)

        proxy = _Proxy([])
        rewritten, reducers = split_reducers(out_exprs, by, instance, proxy)
        proxy._names = [f"__g{i}" for i in range(len(gvals_exprs))] + [
            f"__r{j}" for j in range(len(reducers))
        ]

        # compile group-side fns over base rows
        inner_exprs = list(gvals_exprs)
        for r in reducers:
            inner_exprs.extend(r._args)
        node, ctx = self._row_space(base, inner_exprs)
        comp = ExpressionCompiler(ctx)
        gval_fns = [comp.compile_row(e) for e in gvals_exprs]
        reducer_specs = []
        force_sort = False
        for r in reducers:
            arg_fns = [comp.compile_row(a) for a in r._args]
            name = r._name
            if name in ("sum", "float_sum", "avg", "array_sum") and r._args:
                # float addition is not associative: keep the canonical
                # per-tick sort unless the argument is provably integral
                d = dt.unoptionalize(infer_dtype(r._args[0]))
                if d not in (dt.INT, dt.BOOL):
                    force_sort = True
            kwargs = dict(r._kwargs)
            fn = kwargs.pop("fn", None)
            spec_kwargs = {}
            if name in ("sorted_tuple", "tuple", "ndarray"):
                spec_kwargs["skip_nones"] = kwargs.get("skip_nones", False)
            if name == "stateful":
                spec_kwargs["fn"] = fn
                if kwargs.get("emit") is not None:
                    spec_kwargs["emit"] = kwargs["emit"]
            if name in ("argmin", "argmax"):
                # one arg: (value, row key); two: (value, payload)
                def extract(key, row, _fns=arg_fns):
                    vals = [f(key, row) for f in _fns]
                    return (vals[0], key) if len(vals) == 1 else (vals[0], vals[1])
            elif name in ("tuple", "ndarray"):
                def extract(key, row, _fns=arg_fns):
                    return (_fns[0](key, row), int(key))
            elif len(arg_fns) == 1:
                def extract(key, row, _fn=arg_fns[0]):
                    return (_fn(key, row),)
            else:
                def extract(key, row, _fns=arg_fns):
                    return tuple(f(key, row) for f in _fns)
            reducer_specs.append((name, extract, spec_kwargs))

        if len(gval_fns) == 1 and not use_raw_key:
            def group_fn(key, row, _f=gval_fns[0]):
                v = _f(key, row)
                return hash_values(v), (v,)
        else:
            def group_fn(key, row):
                gvals = tuple(f(key, row) for f in gval_fns)
                if use_raw_key:
                    gkey = gvals[0] if isinstance(gvals[0], Pointer) \
                        else hash_values(gvals[0])
                else:
                    gkey = hash_values(*gvals)
                return gkey, gvals

        gnode = self.graph.add_node(
            eng.GroupByOperator(group_fn, reducer_specs,
                                force_order_sensitive=force_sort),
            [node], f"groupby:{table._name}")

        # post-map over (gvals, reduced) rows; elided when it is the
        # identity projection (reduce() listing group cols then reducers in
        # storage order — the common case)
        if (len(rewritten) == len(proxy._names) and all(
                type(e) is ex.ColumnReference and e.table is proxy
                and e.name == proxy._names[i]
                for i, e in enumerate(rewritten))):
            return gnode
        post_ctx = CompileContext()
        post_ctx.add_table(proxy, 0)
        post_program, nondet = compile_map_program(rewritten, post_ctx)
        return self.graph.add_node(_map_op_for(post_program, nondet),
                                   [gnode], f"reduce:{table._name}")

    # -- set ops ------------------------------------------------------------
    def _project_to_names(self, t: Table, names: list[str]) -> Node:
        node = self.lower(t)
        own = t._column_names()
        if own == names:
            return node
        pos = [own.index(n) for n in names]

        def proj(keys, rows):
            return [tuple(r[p] for p in pos) for r in rows]

        return self.graph.add_node(eng.MapOperator(proj), [node], "proj")

    def _lower_concat(self, table: Table, plan: Plan) -> Node:
        tables = plan.params["tables"]
        update = plan.params["update"]
        names = table._column_names()
        nodes = [self._project_to_names(t, names) for t in tables]

        def combine_rows(present: list):
            live = [r for r in present if r is not None]
            return live[-1] if update else live[0]

        return self.graph.add_node(
            eng.NAryConcatOperator(len(nodes), combine_rows, update=update),
            nodes, "concat")

    def _lower_concat_reindex(self, table: Table, plan: Plan) -> Node:
        tables = plan.params["tables"]
        names = table._column_names()
        nodes = []
        for i, t in enumerate(tables):
            n = self._project_to_names(t, names)
            salt = i

            def key_fn(keys, rows, _s=salt):
                return [hash_values(k, _s) for k in keys]

            nodes.append(self.graph.add_node(
                eng.ReindexOperator(key_fn), [n], f"reindex{i}"))

        def combine_rows(present):
            return next(r for r in present if r is not None)

        return self.graph.add_node(
            eng.NAryConcatOperator(len(nodes), combine_rows, update=False),
            nodes, "concat_reindex")

    def _lower_update_cells(self, table: Table, plan: Plan) -> Node:
        base: Table = plan.params["base"]
        other: Table = plan.params["other"]
        columns = plan.params["columns"]
        lnode = self.lower(base)
        rnode = self.lower(other)
        base_names = base._column_names()
        other_names = other._column_names()
        repl = {base_names.index(c): other_names.index(c) for c in columns}

        def combine(l, r):
            if l is None:
                return None
            if r is None:
                return l
            return tuple(
                r[repl[i]] if i in repl else v for i, v in enumerate(l)
            )

        return self.graph.add_node(
            eng.BinaryKeyOperator(combine), [lnode, rnode], "update_cells")

    # -- reshaping ----------------------------------------------------------
    def _lower_flatten(self, table: Table, plan: Plan) -> Node:
        base: Table = plan.params["base"]
        col = plan.params["col_name"]
        origin_id = plan.params.get("origin_id")
        node = self.lower(base)
        pos = base._column_names().index(col)

        def fn(key, row):
            val = row[pos]
            if val is None:
                return []
            out = []
            for i, elem in enumerate(val):
                # mix-derived child keys: parent keys are already uniform
                # 128-bit digests, so the multiply-xor mix preserves
                # uniformity at a fraction of a fresh blake2b per row
                nk = mix_pointers(key, i)
                nr = list(row)
                nr[pos] = elem
                if origin_id is not None:
                    nr.append(key)
                out.append((nk, tuple(nr)))
            return out

        return self.graph.add_node(eng.FlattenOperator(fn), [node], "flatten")

    def _lower_dedupe(self, table: Table, plan: Plan) -> Node:
        base: Table = plan.params["base"]
        value_e = plan.params["value"]
        inst_e = plan.params["instance"]
        acceptor = plan.params["acceptor"]
        node = self.lower(base)
        ctx = CompileContext()
        ctx.add_table(base, 0)
        comp = ExpressionCompiler(ctx)
        vfn = comp.compile_row(value_e) if value_e is not None else None
        ifn = comp.compile_row(inst_e) if inst_e is not None else None

        def value_fn(key, row):
            return vfn(key, row) if vfn is not None else row

        def instance_fn(key, row):
            return ifn(key, row) if ifn is not None else 0

        return self.graph.add_node(
            eng.DeduplicateOperator(instance_fn, value_fn, acceptor),
            [node], "deduplicate")

    # -- pointer lookup ------------------------------------------------------
    def _lower_ix(self, table: Table, plan: Plan) -> Node:
        target: Table = plan.params["target"]
        ctx_table: Table = plan.params["ctx"]
        key_expr = plan.params["key_expr"]
        optional = plan.params["optional"]

        lnode, lctx = self._row_space(ctx_table, [key_expr])
        comp = ExpressionCompiler(lctx)
        kfn = comp.compile_row(key_expr)
        rnode = self.lower(target)

        def lkey_fn(key, row):
            k = kfn(key, row)
            # None lookup key: matches nothing, but in optional mode the
            # row must still surface with a None payload
            return ("__pw_null__", "l", key) if k is None else k

        def rkey_fn(key, row):
            return key

        nt = len(target._column_names())

        def out_fn(lk, lrow, rk, rrow):
            return rrow if rrow is not None else (None,) * nt

        mode = "left" if optional else "inner"
        return self.graph.add_node(
            eng.JoinOperator(mode, lkey_fn, rkey_fn, out_fn,
                             out_key_fn=lambda lk, rk, jk: lk),
            [lnode, rnode], "ix")

    # -- external index ------------------------------------------------------
    def _lower_external_index(self, table: Table, plan: Plan) -> Node:
        from pathway_tpu_torch.engine.index_ops import ExternalIndexOperator

        data: Table = plan.params["data"]
        queries: Table = plan.params["queries"]
        factory = plan.params["index_factory"]
        dnode = self.lower(data)
        qnode = self.lower(queries)

        def colpos(t, col):
            if col is None:
                return None
            name = col.name if isinstance(col, ex.ColumnReference) else col
            return t._column_names().index(name)

        op = ExternalIndexOperator(
            index=factory.build(),
            data_vec_pos=plan.params.get("data_vec_pos", 0),
            data_filter_pos=colpos(data, plan.params.get("data_filter_col")),
            query_vec_pos=plan.params.get("query_vec_pos", 0),
            query_limit_pos=colpos(queries, plan.params.get("limit_col")),
            query_filter_pos=colpos(queries, plan.params.get("query_filter_col")),
            revise=plan.params.get("revise", False),
        )
        return self.graph.add_node(op, [dnode, qnode], "external_index")


# ---------------------------------------------------------------------------
# convenience: run tables to captured streams (test harness backbone)
# ---------------------------------------------------------------------------

def run_tables(*tables: Table) -> list[CapturedStream]:
    runner = GraphRunner()
    caps = [runner.capture(t) for t in tables]
    runner.run_batch()
    return caps
