"""Lowering + execution: Table plans → engine graph → microbatch run —
port of pathway_tpu/internals/runner.py.

Walks the plan DAG reachable from requested outputs, compiles expressions
against row layouts, builds engine operators, then drives the scheduler
over logical times: ``run_batch`` over the static feeds, or the streaming
runtime (engine/streaming.py, through ``pw.run``) over the streaming
sources that ``_lower_input`` collects in ``_stream_subjects``. Lowered:
static, input, identity, map, filter, filter_raw (remove_errors),
reindex, flatten, concat, concat_reindex, update_cells, key_filter
(restrict / intersect / difference), having, groupby (to
``ColumnarGroupByOperator`` where ``_columnar_groupby_spec`` finds it
columnar, as the JAX package chooses, else to ``GroupByOperator``),
join_select (a ``JoinOperator``, which emits the projected row itself when
every selected expression is a plain column or id), sort, dedupe, ix (a
``JoinOperator`` keyed by the left id), the temporal behaviors' buffer /
forget / freeze / forget_immediately / filter_out_forgetting
(engine/temporal_ops.py) and external_index (the as-of-now index
operator, engine/index_ops.py). A map whose select carries both auto-jit
fusable UDF chains and host-only UDFs lowers into a host map, a device
map and a ``ZipAlignedOperator`` (``_lower_map_split``). Not ported:
iterate and gradual_broadcast — a plan of those kinds raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import operators as eng
from pathway_tpu_torch.engine import temporal_ops as tops
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
from pathway_tpu_torch.internals.keys import (Pointer, canonical_shard_value,
                                              hash_values, mix_pointers)
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

    def run_batch(self, n_workers: int | None = None, cluster=None,
                  recorder=None) -> None:
        """Run all static feeds to completion (batch mode: one pass over the
        totally-ordered times present in the inputs + a flush tick).
        ``n_workers`` (None reads ``PATHWAY_THREADS``, default 1) above 1
        runs the dataflow sharded over that many in-process workers
        (engine/graph.py). At one worker the device legs run on the
        device bridge at ``PATHWAY_DEVICE_INFLIGHT``'s window (default 2;
        1 steps every operator on the calling thread); the flush tick
        waits for every leg, and a leg's failure re-raises here. The
        scheduler stays as ``_scheduler``, its bridge and worker pool
        closed, so ``bridge_stats()`` and ``exchange_rounds_per_tick()``
        read after the run. ``cluster`` (the multi-process run) raises
        ``NotImplementedError`` (ROADMAP queue 1, item 6f).

        ``recorder`` threads a flight recorder through the scheduler
        (engine/flight_recorder.py); when omitted, the environment
        (``PATHWAY_TRACE_PATH`` / ``PATHWAY_FLIGHT_RECORDER``) decides —
        by default there is none."""
        if n_workers is None:
            from pathway_tpu_torch.internals.config import get_pathway_config

            n_workers = get_pathway_config().threads
        if recorder is None:
            from pathway_tpu_torch.engine.flight_recorder import \
                FlightRecorder

            recorder = FlightRecorder.from_env()
        sched = Scheduler(self.graph, n_workers=n_workers, cluster=cluster,
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
        split_node = self._lower_map_split(table, exprs, node, ctx)
        if split_node is not None:
            return split_node
        program, nondet = compile_map_program(exprs, ctx)
        return self.graph.add_node(_map_op_for(program, nondet), [node],
                                   f"map:{table._name}")

    def _lower_map_split(self, table: Table, exprs, node, ctx) -> Node | None:
        """Host/device split (internals/autojit.py): a select that carries
        BOTH auto-jit-fusable UDF chains and host-only UDFs lowers into two
        map operators over the same input — the fused part marked
        device_bound so it rides the device leg, the host-only part
        stepped on the host thread *while* a previous tick's device leg is
        still in flight — recombined by a stateless aligned zip. One
        operator would serialize the host-only UDF time before the device
        dispatch every tick."""
        from pathway_tpu_torch.internals.autojit import (discard_programs,
                                                         split_map_exprs)

        split = split_map_exprs(exprs)
        if split is None:
            return None
        dev_idx, host_idx = split
        dev_program, dev_nd = compile_map_program(
            [exprs[i] for i in dev_idx], ctx)
        host_program, host_nd = compile_map_program(
            [exprs[i] for i in host_idx], ctx)
        if dev_program.autojit is None or dev_nd or host_nd or \
                host_program.device_bound:
            # fusion did not engage after all, or a side needs the
            # caching DeterministicMapOperator (which reorders entries —
            # the aligned zip requires order preservation), or the "host"
            # side carries a device=True batch UDF (both maps would ride
            # the device leg: the split is pure overhead). One node: the
            # full-program compile builds its own FusedProgram, so back
            # the split's out of the registry and the counter
            discard_programs(dev_program.autojit)
            discard_programs(host_program.autojit)
            return None
        spec = [None] * len(exprs)
        for j, i in enumerate(host_idx):
            spec[i] = (0, j)
        for j, i in enumerate(dev_idx):
            spec[i] = (1, j)
        host_node = self.graph.add_node(
            eng.MapOperator(host_program), [node],
            f"map_host:{table._name}")
        dev_node = self.graph.add_node(
            _map_op_for(dev_program, dev_nd), [node],
            f"map_dev:{table._name}")
        return self.graph.add_node(
            eng.ZipAlignedOperator(tuple(spec)), [host_node, dev_node],
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

        columnar = None
        if not force_sort and not use_raw_key:
            columnar = _columnar_groupby_spec(gvals_exprs, reducers, ctx)
        if columnar is not None:
            gnode = self.graph.add_node(
                eng.ColumnarGroupByOperator(*columnar),
                [node], f"groupby:{table._name}")
        else:
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

    # -- joins --------------------------------------------------------------
    def _lower_join_select(self, table: Table, plan: Plan) -> Node:
        left: Table = plan.params["left"]
        right: Table = plan.params["right"]
        on = plan.params["on"]
        mode = plan.params["mode"]
        id_expr = plan.params.get("id_expr")
        exprs = plan.params["exprs"]

        lnode = self.lower(left)
        rnode = self.lower(right)

        lctx = CompileContext()
        lctx.add_table(left, 0)
        lcomp = ExpressionCompiler(lctx)
        l_fns = [lcomp.compile_row(a) for a, _ in on]
        rctx = CompileContext()
        rctx.add_table(right, 0)
        rcomp = ExpressionCompiler(rctx)
        r_fns = [rcomp.compile_row(b) for _, b in on]

        # SQL null semantics: a None join value matches nothing, but in
        # left/right/outer mode the row must still appear as an unmatched
        # "ear" — so map it to a per-row sentinel key that can't collide.
        # Hashable scalars are used RAW as the join-group key (dict keys in
        # the join state) — hashing per row bought nothing. Bools still hash:
        # True == 1 as a dict key, but hash_values keeps them distinct,
        # and both sides must agree on the keying.
        def _jkey(v, side, key):
            if v is None:
                return ("__pw_null__", side, key)
            cls = v.__class__
            if cls is str or cls is Pointer:
                return v
            if cls is int:  # not bool: its class is bool
                return v
            if cls is bool:
                # True == 1 as a dict key but hash_values keeps bools
                # distinct from ints — a raw bool would falsely match an
                # int join key from the other side
                return hash_values(v)
            # floats / np scalars canonicalize so equal ints and floats
            # (1 vs 1.0, np.int64(1) vs 1) join exactly as the hash
            # encoding says they do; NaN and exotica fall back to hashing
            return canonical_shard_value(v)

        if len(l_fns) == 1:
            def lkey_fn(key, row, _f=l_fns[0]):
                return _jkey(_f(key, row), "l", key)
        else:
            def lkey_fn(key, row):
                vals = tuple(f(key, row) for f in l_fns)
                if any(v is None for v in vals):
                    return ("__pw_null__", "l", key)
                return hash_values(*vals)

        if len(r_fns) == 1:
            def rkey_fn(key, row, _f=r_fns[0]):
                return _jkey(_f(key, row), "r", key)
        else:
            def rkey_fn(key, row):
                vals = tuple(f(key, row) for f in r_fns)
                if any(v is None for v in vals):
                    return ("__pw_null__", "r", key)
                return hash_values(*vals)

        # plain-column join keys: give the native pass the position so it
        # extracts + canonicalizes inline (fallback reproduces _jkey)
        lkey_pos = rkey_pos = None
        if len(on) == 1 and type(on[0][0]) is ex.ColumnReference:
            try:
                lkey_pos = lctx.position(on[0][0])
            except KeyError:
                lkey_pos = None
        if len(on) == 1 and type(on[0][1]) is ex.ColumnReference:
            try:
                rkey_pos = rctx.position(on[0][1])
            except KeyError:
                rkey_pos = None
        key_kw = dict(
            lkey_pos=lkey_pos,
            lkey_fb=(lambda v, key: _jkey(v, "l", key))
            if lkey_pos is not None else None,
            rkey_pos=rkey_pos,
            rkey_fb=(lambda v, key: _jkey(v, "r", key))
            if rkey_pos is not None else None,
        )

        nl = len(left._column_names())
        nr = len(right._column_names())

        out_key_fn = None
        if id_expr is not None and isinstance(id_expr, ex.IdExpression):
            if id_expr.table is left:
                out_key_fn = lambda lk, rk, jk: lk
            elif id_expr.table is right:
                out_key_fn = lambda lk, rk, jk: rk

        ctx = CompileContext()
        off = ctx.add_table(left, 0)
        off = ctx.add_table(right, off)
        ctx.id_pos = {id(left): nl + nr, id(right): nl + nr + 1}

        # When every selected expression is a plain column/id reference the
        # join emits the projected row DIRECTLY (code-generated picker) and
        # the whole select map node disappears — one tuple per output row
        # instead of three (wide row, column batch, zipped row).
        direct = _direct_join_projection(exprs, ctx, nl, nr, mode)
        if direct is not None:
            direct_fn, cspec = direct
            jnode = self.graph.add_node(
                eng.JoinOperator(mode, lkey_fn, rkey_fn, direct_fn,
                                 out_key_fn, out_spec=cspec, **key_kw),
                [lnode, rnode], f"join_select:{table._name}")
            return jnode

        def out_fn(lk, lrow, rk, rrow):
            lr = lrow if lrow is not None else (None,) * nl
            rr = rrow if rrow is not None else (None,) * nr
            return (*lr, *rr, lk, rk)

        jnode = self.graph.add_node(
            eng.JoinOperator(mode, lkey_fn, rkey_fn, out_fn, out_key_fn,
                             **key_kw),
            [lnode, rnode], f"join:{mode}")

        program, nondet = compile_map_program(exprs, ctx)
        return self.graph.add_node(_map_op_for(program, nondet), [jnode],
                                   f"join_select:{table._name}")

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

    def _lower_key_filter(self, table: Table, plan: Plan) -> Node:
        base: Table = plan.params["base"]
        other: Table = plan.params["other"]
        mode = plan.params["mode"]
        lnode = self.lower(base)
        rnode = self.lower(other)
        if mode in ("restrict", "intersect"):
            combine = lambda l, r: l if (l is not None and r is not None) else None
        elif mode == "difference":
            combine = lambda l, r: l if (l is not None and r is None) else None
        else:
            raise ValueError(mode)
        return self.graph.add_node(
            eng.BinaryKeyOperator(combine), [lnode, rnode], mode)

    def _lower_having(self, table: Table, plan: Plan) -> Node:
        base: Table = plan.params["base"]
        indexer = plan.params["indexer"]
        idx_table: Table = plan.params["indexer_table"]
        lnode = self.lower(base)
        inode = self.lower(idx_table)
        ctx = CompileContext()
        ctx.add_table(idx_table, 0)
        comp = ExpressionCompiler(ctx)
        vfn = comp.compile(indexer)

        def key_fn(keys, rows):
            return [v if isinstance(v, Pointer) else hash_values(v)
                    for v in vfn(keys, rows)]

        keyed = self.graph.add_node(
            eng.ReindexOperator(key_fn), [inode], "having_keys")
        combine = lambda l, r: l if (l is not None and r is not None) else None
        return self.graph.add_node(
            eng.BinaryKeyOperator(combine), [lnode, keyed], "having")

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

    def _lower_sort(self, table: Table, plan: Plan) -> Node:
        base: Table = plan.params["base"]
        key_e = plan.params["key"]
        inst_e = plan.params["instance"]
        # an instance expression raises TypeError in this truth test, as in
        # the JAX package (ROADMAP queue 3, item 7)
        node, ctx = self._row_space(base, [key_e] + ([inst_e] if inst_e else []))
        comp = ExpressionCompiler(ctx)
        kfn = comp.compile_row(key_e)
        ifn = comp.compile_row(inst_e) if inst_e is not None else None

        def instance_fn(key, row):
            return ifn(key, row) if ifn is not None else None

        return self.graph.add_node(
            eng.SortOperator(kfn, instance_fn), [node], "sort")

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

    # -- temporal (engine/temporal_ops.py) ----------------------------------
    def _lower_forget_immediately(self, table: Table, plan: Plan) -> Node:
        node = self.lower(plan.params["base"])
        return self.graph.add_node(tops.ForgetImmediatelyOperator(), [node],
                                   "forget_now")

    def _lower_filter_out_forgetting(self, table: Table, plan: Plan) -> Node:
        node = self.lower(plan.params["base"])
        return self.graph.add_node(tops.FilterOutForgettingOperator(), [node],
                                   "filter_out_forgetting")

    def _lower_buffer(self, table: Table, plan: Plan) -> Node:
        return self._lower_time_column_op(table, plan, "buffer")

    def _lower_forget(self, table: Table, plan: Plan) -> Node:
        return self._lower_time_column_op(table, plan, "forget")

    def _lower_freeze(self, table: Table, plan: Plan) -> Node:
        return self._lower_time_column_op(table, plan, "freeze")

    def _lower_time_column_op(self, table: Table, plan: Plan, kind: str) -> Node:
        base: Table = plan.params["base"]
        node, ctx = self._row_space(base, [plan.params["threshold"],
                                           plan.params["time"]])
        comp = ExpressionCompiler(ctx)
        thr_fn = comp.compile_row(plan.params["threshold"])
        time_fn = comp.compile_row(plan.params["time"])

        if kind == "buffer":
            op = tops.BufferOperator(thr_fn, time_fn)
        elif kind == "forget":
            op = tops.ForgetOperator(thr_fn, time_fn,
                                     plan.params.get("mark", False))
        else:
            op = tops.FreezeOperator(thr_fn, time_fn)
        return self.graph.add_node(op, [node], kind)

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


def _direct_join_projection(exprs, ctx, nl: int, nr: int, mode: str):
    """``(out_fn, c_spec)`` when every select expression is a plain
    column/id reference; None otherwise. out_fn is a code-generated
    ``(lk, lrow, rk, rrow) -> projected row``; c_spec is the equivalent
    ((side, pos), ...) table for the native join pass (side 0 = left row,
    1 = right row, 2 = key with pos 0 lk / 1 rk). Replaces out_fn +
    select-map with a single tuple build per output row."""
    items = []
    cspec = []
    for e in exprs:
        if isinstance(e, ex.IdExpression):
            pos = ctx.id_pos.get(id(e.table))
            if pos == nl + nr:
                items.append("lk")
                cspec.append((2, 0))
            elif pos == nl + nr + 1:
                items.append("rk")
                cspec.append((2, 1))
            else:
                return None
        elif type(e) is ex.ColumnReference:
            try:
                p = ctx.position(e)
            except KeyError:
                return None
            if p < nl:
                items.append(f"lrow[{p}]")
                cspec.append((0, p))
            else:
                items.append(f"rrow[{p - nl}]")
                cspec.append((1, p - nl))
        else:
            return None
    body = f"({', '.join(items)},)" if items else "()"
    if mode == "inner":  # both rows always present
        fn = eval(f"lambda lk, lrow, rk, rrow: {body}")  # noqa: S307
        return fn, tuple(cspec)
    fn = eval(  # noqa: S307 — outer modes: absent side reads as None
        f"lambda lk, lrow, rk, rrow, _ln=(None,) * {nl}, _rn=(None,) * {nr}: "
        f"(lambda lrow, rrow: {body})("
        "lrow if lrow is not None else _ln, "
        "rrow if rrow is not None else _rn)")
    return fn, tuple(cspec)


# the group-value dtypes ColumnarGroupByOperator interns
_COLUMNAR_GVAL_DTYPES = (
    dt.INT, dt.BOOL, dt.STR, dt.FLOAT, dt.POINTER, dt.DATE_TIME_NAIVE,
    dt.DATE_TIME_UTC, dt.DURATION)


def _columnar_groupby_spec(gvals_exprs, reducers, ctx):
    """Positions for ColumnarGroupByOperator, or None if ineligible — the
    JAX package's choice, rule for rule.

    Eligible: every group value is a plain column of hashable scalar dtype
    and every reducer is count / integral sum / integral avg, or min /
    max / argmin / argmax over plain columns of such dtypes. The hash
    semantics are kept exactly: the operator aliases typed intern keys
    through ``hash_values`` on first sight of each distinct value."""

    def hashable_dtype(d) -> bool:
        d = dt.unoptionalize(d)
        if d in _COLUMNAR_GVAL_DTYPES:
            return True
        # concrete scalar tuples (window keys: (instance, start, end))
        # intern fine — tuple hashing over hashable members
        if isinstance(d, dt.Tuple):
            return all(hashable_dtype(el) for el in d.args)
        return False

    gval_pos = []
    for e in gvals_exprs:
        if isinstance(e, ex.IdExpression) or type(e) is not ex.ColumnReference:
            return None
        try:
            if not hashable_dtype(infer_dtype(e)):
                return None
        except Exception:
            return None
        gval_pos.append(ctx.position(e))
    reducer_cols = []
    for r in reducers:
        name = r._name
        if name == "count" and not r._args:
            reducer_cols.append(("count", None))
            continue
        if name in ("sum", "int_sum", "avg") and len(r._args) == 1:
            a = r._args[0]
            if type(a) is not ex.ColumnReference:
                return None
            try:
                d = dt.unoptionalize(infer_dtype(a))
            except Exception:
                return None
            if d not in (dt.INT, dt.BOOL):
                return None
            reducer_cols.append(
                ("avg" if name == "avg" else "sum", ctx.position(a)))
            continue
        if name in ("min", "max") and len(r._args) == 1:
            # multiset side-state in the columnar operator: exact under
            # retraction, values must be hashable scalars
            a = r._args[0]
            if type(a) is not ex.ColumnReference:
                return None
            try:
                if not hashable_dtype(infer_dtype(a)):
                    return None
            except Exception:
                return None
            reducer_cols.append((name, ctx.position(a)))
            continue
        if name in ("argmin", "argmax") and len(r._args) in (1, 2):
            # (cmp, payload) multiset; payload defaults to the row key
            # (runner's argmin extract semantics, position -1)
            positions = []
            for a in r._args:
                if type(a) is not ex.ColumnReference:
                    return None
                try:
                    if not hashable_dtype(infer_dtype(a)):
                        return None
                except Exception:
                    return None
                positions.append(ctx.position(a))
            if len(positions) == 1:
                positions.append(-1)  # payload = row key
            reducer_cols.append((name, tuple(positions)))
            continue
        return None
    return gval_pos, reducer_cols


# ---------------------------------------------------------------------------
# convenience: run tables to captured streams (test harness backbone)
# ---------------------------------------------------------------------------

def run_tables(*tables: Table) -> list[CapturedStream]:
    runner = GraphRunner()
    caps = [runner.capture(t) for t in tables]
    runner.run_batch()
    return caps
