"""Realtime microbatch runtime — port of pathway_tpu/engine/streaming.py,
trimmed to one process.

Replaces the reference's worker hot loop (dataflow.rs:5519-5572 —
``loop { probers; flushers; pollers; step_or_park }``): connector threads
feed sessions; every autocommit interval the runtime drains all sessions,
advances the logical timestamp, and runs one scheduler step. Totally
ordered timestamps + whole-batch steps give the same consistency
guarantee as timely's progress frontiers (every time is complete when
processed). ``n_workers`` (None reads ``PATHWAY_THREADS``) above 1 runs the
dataflow sharded in this process (engine/graph.py): each source's rows are
partitioned by key as they are fed.

The commit interval is the smallest ``autocommit_duration_ms`` of the
sources (``default_commit_ms`` for a source without one). Device legs go
through the device bridge (engine/device_bridge.py) at
``PATHWAY_DEVICE_INFLIGHT``'s window (default 2): a query's answer is
computed on the bridge worker while the commit loop drains the next tick.
With a flight recorder on (``PATHWAY_FLIGHT_RECORDER=1`` or a trace
path), serving sources get the run's request tracker
(engine/request_tracker.py) and each query's stages are stamped. With
``PATHWAY_PROFILER=1`` the run installs a continuous profiler
(engine/profiler.py, on ``PATHWAY_PROFILER_DEVICE``, default cuda),
samples its threads while it runs and removes it at the end.

Reader threads are the sources' own (``DataSource.start``): a reader that
raises closes its session with the error, and the runtime stops and
re-raises it from ``run`` (``terminate_on_error=True``) or records it in
the global error log and serves on (``False``).

Not ported, each raising ``NotImplementedError`` naming its ROADMAP item
when a caller asks for it: persistence and operator-state snapshots,
read replicas and the router, the multi-process cluster, QoS, the
connector supervisor and the watchdog, and the monitoring HTTP server.
"""

from __future__ import annotations

import threading
import weakref

from pathway_tpu_torch.engine.delta import Delta
from pathway_tpu_torch.engine.graph import Scheduler
from pathway_tpu_torch.engine.result_cache import note_commit_ticks
from pathway_tpu_torch.internals.monitoring import MonitoringLevel, StatsMonitor

# ROADMAP queue 1 items of what the runtime leaves out
UNPORTED = {
    "persistence_config": "item 6a: persistence and snapshots",
    "qos": "item 6b: QoS and admission control",
    "connector_policy": "item 6c: the connector supervisor and watchdog",
    "watchdog": "item 6c: the connector supervisor and watchdog",
    "with_http_server": "item 6d: the monitoring HTTP server and telemetry",
    "replica": "item 6e: read replicas and the router",
    "cluster": "item 6f: the multi-process cluster",
}


def refuse_unported(**options) -> None:
    """Raise ``NotImplementedError`` for the first option a caller set
    that the runtime does not port (None and False are not set)."""
    for name, value in options.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to pathway_tpu_torch yet "
                f"(ROADMAP queue 1, {UNPORTED[name]})")


# live runtimes (weak: a runtime dies with its last strong ref). Lets
# embedding code — and the tests — stop pw.run() loops started on
# background threads: stop_all() requests stop and joins reader threads.
_ACTIVE_RUNTIMES: "weakref.WeakSet[StreamingRuntime]" = weakref.WeakSet()


def stop_all(join_timeout: float = 5.0) -> None:
    """Request stop on every live StreamingRuntime and join their reader
    threads; also stops static-mode connectors sleeping between polls
    (CollectSession). Safe to call from any thread; idempotent."""
    from pathway_tpu_torch.io._datasource import stop_collect_sessions

    stop_collect_sessions()
    for rt in list(_ACTIVE_RUNTIMES):
        rt.stop()
    for rt in list(_ACTIVE_RUNTIMES):
        rt.join_readers(join_timeout)


class StreamingRuntime:
    def __init__(self, runner, *, monitoring_level=None,
                 with_http_server=False, persistence_config=None,
                 terminate_on_error=True, default_commit_ms: int = 100,
                 n_workers: int | None = None, cluster=None,
                 connector_policy=None,
                 watchdog=None, trace_path: str | None = None, replica=None,
                 qos=None):
        refuse_unported(persistence_config=persistence_config,
                        replica=replica, cluster=cluster, qos=qos,
                        connector_policy=connector_policy,
                        watchdog=watchdog,
                        with_http_server=with_http_server)
        from pathway_tpu_torch.engine.threads import install_excepthook

        # uncaught exceptions in ANY engine thread land in the ErrorLog
        # instead of dying silently on stderr
        install_excepthook()
        if n_workers is None:
            from pathway_tpu_torch.internals.config import get_pathway_config

            n_workers = get_pathway_config().threads
        self.runner = runner
        self.default_commit_ms = default_commit_ms
        self.terminate_on_error = terminate_on_error
        self._stop = threading.Event()
        # last tick run_time RETURNED for (pipelined: its device leg may
        # still be in flight)
        self._last_completed_tick = 0
        # an engine failure swallowed by the degrade path
        # (terminate_on_error=False): kept so teardown neither re-raises
        # it nor mistakes it for an unobserved device error
        self._degraded_engine_error = None
        # the first reader error under terminate_on_error=True
        self.fatal_error: BaseException | None = None
        self._reported: set[int] = set()  # sessions whose error was logged
        self.monitor = StatsMonitor(monitoring_level or MonitoringLevel.NONE)
        # flight recorder (engine/flight_recorder.py): on when a trace
        # path is configured, PATHWAY_FLIGHT_RECORDER is set or the
        # monitor shows the data; otherwise None — one dead branch per
        # operator step
        from pathway_tpu_torch.engine.flight_recorder import FlightRecorder

        self.recorder = FlightRecorder.from_env(
            trace_path=trace_path, auto_on=self.monitor.enabled())
        # continuous profiler (engine/profiler.py): on with
        # PATHWAY_PROFILER=1 (no surface of the port shows its data by
        # itself yet); installed process-wide so the kernel cost-model
        # hooks and the legs find it with one global load. Sampling starts
        # when the run does.
        from pathway_tpu_torch.engine.profiler import (Profiler,
                                                       current_profiler,
                                                       install_profiler)

        self.profiler = Profiler.from_env()
        self._installed_profiler = False
        if self.profiler is not None and current_profiler() is None:
            install_profiler(self.profiler)
            self._installed_profiler = True
        self.scheduler = Scheduler(runner.graph, n_workers=n_workers,
                                   recorder=self.recorder)
        self.sessions = []
        self._readers: list[threading.Thread] = []
        from pathway_tpu_torch.io._datasource import Session

        for node, datasource in runner._stream_subjects:
            if getattr(datasource, "durable_ack", False):
                raise NotImplementedError(
                    "rest_connector(durable_ack=True) is not ported to "
                    "pathway_tpu_torch yet (ROADMAP queue 1, "
                    f"{UNPORTED['persistence_config']})")
            self.sessions.append((node, Session(), datasource))
        # request-scoped serving tracing (engine/request_tracker.py):
        # sources that declare a request_tracker slot (rest_connector)
        # get the run's tracker, so each query's ingress/queue/host/
        # device/response stages are stamped end to end
        self._request_tracker = (
            self.recorder.requests if self.recorder is not None else None)
        if self._request_tracker is not None:
            for _node, _session, ds in self.sessions:
                if hasattr(ds, "request_tracker"):
                    ds.request_tracker = self._request_tracker

    def stats(self) -> dict:
        """The run's shape and progress: its workers (``n_workers``) and
        the last tick ``run_time`` returned for."""
        return {"n_workers": self.scheduler.n_workers,
                "last_completed_tick": self._last_completed_tick}

    def stop(self) -> None:
        self._stop.set()
        for _node, session, _ds in self.sessions:
            session.stopping.set()

    def join_readers(self, timeout: float = 5.0) -> None:
        """Join connector threads after stop(); they observe the session's
        stop event between polls (Session.sleep / stop_requested)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        for t in list(self._readers):
            t.join(max(0.0, deadline - _time.monotonic()))

    def _handle_engine_failure(self, error: BaseException) -> bool:
        """A failure escaped the commit loop: a poisoned device leg or an
        operator error. Returns True iff the failure is absorbed as a
        degrade (``terminate_on_error=False``): recorded in the global
        ErrorLog (kind="engine"), run ends cleanly. Interrupts and
        shutdown requests always re-raise."""
        if isinstance(error, (KeyboardInterrupt, SystemExit,
                              GeneratorExit)):
            return False
        if self.terminate_on_error:
            return False
        import logging

        from pathway_tpu_torch.internals.error import global_error_log

        kind = ("device leg"
                if self.scheduler.take_device_error() is error
                else "engine")
        global_error_log().log(
            f"{kind} failed under terminate_on_error=False; stopping "
            f"ingestion: {type(error).__name__}: {error}",
            operator="engine", kind="engine")
        logging.getLogger(__name__).error(
            "%s failed; degrading to a clean stop "
            "(terminate_on_error=False).", kind, exc_info=error)
        self._degraded_engine_error = error
        return True

    def _poll_readers(self) -> bool:
        """Observe crashed readers (the supervisor's job in the JAX
        package, whose restart policies are not ported). Returns True when
        the run must stop: a reader raised under terminate_on_error=True.
        Under False the error is logged once and the source counts as
        closed; the rest of the pipeline keeps serving."""
        for i, (_node, session, ds) in enumerate(self.sessions):
            if session.closed_reason != "error" or i in self._reported:
                continue
            self._reported.add(i)
            if self.terminate_on_error:
                self.fatal_error = session.error
                return True
            from pathway_tpu_torch.internals.error import global_error_log

            global_error_log().log(
                f"connector {ds.name!r} failed under terminate_on_error="
                f"False: {type(session.error).__name__}: {session.error}",
                operator=f"source:{ds.name}", kind="connector")
        return False

    def _drain_and_forward(self, tick: int):
        """Drain every session into its source node. Returns (any_data,
        all_closed)."""
        any_data = False
        all_closed = True
        tracker = self._request_tracker
        for node, session, datasource in self.sessions:
            entries = session.drain()
            if entries:
                any_data = True
                if tracker is not None and \
                        getattr(datasource, "request_tracker", None) \
                        is tracker:
                    # tick-pickup stamp: ends each request's queue stage
                    tracker.picked_up(entries, tick)
                self.scheduler.push_source(node, Delta(entries))
            if not session.closed.is_set():
                all_closed = False
        return any_data, all_closed

    def run(self) -> None:
        _ACTIVE_RUNTIMES.add(self)
        if self.profiler is not None:
            self.profiler.start()
        time_counter = 1
        try:
            for _node, session, datasource in self.sessions:
                self._readers.append(datasource.start(session))

            # feed static tables at startup: dimension data joined
            # against live streams must be present from tick one. One
            # tick per distinct logical time, like run_batch.
            static_by_time, static_times = \
                self.runner.static_feeds_by_time()
            for t in sorted(static_times):
                any_batch = False
                for node, groups in static_by_time:
                    batch = groups.get(t)
                    if batch:
                        self.scheduler.push_source(node, Delta(batch))
                        any_batch = True
                if any_batch:
                    self.scheduler.run_time(time_counter)
                    time_counter += 1

            commit_s = min(
                [s[2].autocommit_duration_ms or self.default_commit_ms
                 for s in self.sessions] + [self.default_commit_ms]
            ) / 1000.0
            # Event wait, not time.sleep: a stop request wakes the loop
            # immediately instead of out-waiting the commit interval
            while not self._stop.wait(commit_s):
                if self._poll_readers():
                    break
                any_data, all_closed = self._drain_and_forward(time_counter)
                # empty ticks keep running: they are near-free and drive
                # as-of-now retractions (delete_completed_queries)
                self.scheduler.run_time(time_counter)
                self._last_completed_tick = time_counter
                # close every live result cache's invalidations-a-tick
                # window (engine/result_cache.py)
                note_commit_ticks()
                self.monitor.update(self.scheduler, self.runner.graph,
                                    time_counter)
                time_counter += 1
                if all_closed and not any_data:
                    # re-drain: a source may have pushed between its
                    # drain() and closing — loop until truly empty, then
                    # the final tick
                    leftovers = True
                    while leftovers:
                        leftovers, _closed = self._drain_and_forward(
                            time_counter)
                        if leftovers:
                            self.scheduler.run_time(time_counter)
                            time_counter += 1
                    # all sources closed: end-of-stream flush tick (a hard
                    # resolve barrier under pipelined execution)
                    self.scheduler.run_time(time_counter, flush=True)
                    self._last_completed_tick = time_counter
                    break
        except BaseException as e:  # noqa: BLE001 — escalation decides
            if not self._handle_engine_failure(e):
                raise
        finally:
            # teardown: stop reader threads FIRST so nothing pushes into a
            # closed pipeline, then join them
            self.stop()
            self.join_readers()
            _ACTIVE_RUNTIMES.discard(self)
            if self.recorder is not None:
                # written in the finally so a crashed run still leaves its
                # trace on disk (the post-mortem)
                try:
                    self.recorder.write_chrome_trace()
                except Exception:
                    import logging

                    logging.getLogger(__name__).warning(
                        "failed to write trace to %s",
                        self.recorder.trace_path, exc_info=True)
            self.monitor.close()
            self.scheduler.close()
            if self.profiler is not None:
                # stop the sampler and any capture, commit the legs still
                # timed on the card; release the module-global hook only
                # if this run installed it (a profiler installed by the
                # caller outlives the run)
                self.profiler.stop()
                if self._installed_profiler:
                    from pathway_tpu_torch.engine.profiler import (
                        current_profiler, install_profiler)

                    if current_profiler() is self.profiler:
                        install_profiler(None)
        if self.fatal_error is not None:
            # the connector's own exception (its reader-thread traceback
            # is attached) from pw.run, after a full clean teardown
            raise self.fatal_error
        # a device leg that failed after the loop's last submit (e.g. the
        # run was stopped externally) was drained-but-not-raised by
        # scheduler.close(): surface it now, exactly as synchronous mode
        # would have raised it out of run_time — unless the degrade path
        # already absorbed and recorded this exact failure
        deferred = self.scheduler.take_device_error()
        if deferred is not None \
                and deferred is not self._degraded_engine_error:
            if self.terminate_on_error or not self._handle_engine_failure(
                    deferred):
                raise deferred
