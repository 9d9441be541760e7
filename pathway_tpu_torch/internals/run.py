"""pw.run — execute the collected pipeline — port of
pathway_tpu/internals/run.py (reference: python/pathway/internals/
run.py:12-52)."""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.runner import GraphRunner


def run(*, debug: bool = False, monitoring_level=None,
        with_http_server: bool = False, default_logging: bool = True,
        persistence_config=None, runtime_typechecking: bool | None = None,
        terminate_on_error: bool = True, telemetry_config=None,
        static_check: str | None = None, connector_policy=None,
        watchdog=None, trace_path: str | None = None,
        replica_of: str | None = None, qos=None, **kwargs) -> Any:
    """Build the engine graph from all registered outputs and run it.

    Static-only graphs run in batch mode to completion
    (``GraphRunner.run_batch``); graphs with streaming sources
    (``pw.io.python.read``, ``pw.io.http.rest_connector``) enter the
    realtime microbatch loop (engine/streaming.py) until all sources
    finish or the run is stopped (``engine.streaming.stop_all()``).
    Both run sharded over ``PATHWAY_THREADS`` in-process workers (default
    1; engine/graph.py). Returns the runner.

    ``trace_path`` (or ``PATHWAY_TRACE_PATH``) turns on the flight
    recorder (engine/flight_recorder.py) and writes the run's span buffer
    as Chrome trace-event JSON; ``PATHWAY_FLIGHT_RECORDER=1`` turns it on
    without a file (the request tracker's stage stamps ride it). With
    ``terminate_on_error=True`` a connector or engine failure stops the
    run and re-raises here; with ``False`` it lands in the global error
    log.

    The auto-jit tier (internals/autojit.py) is on by default: when the
    graph is lowered, the traceable / vmappable sync UDF chains of each
    select compile into one fused dispatch a batch, byte-identical to the
    interpreted path — torch ops on the card (a CUDA graph replay a
    batch) for the trees its exactness gate admits, numpy on the host for
    the rest. A graph with such device trees raises without a card.
    ``PATHWAY_AUTO_JIT=0`` turns the tier off.

    Not ported, each raising ``NotImplementedError`` naming its ROADMAP
    item when set: ``persistence_config`` (also through
    ``PATHWAY_PERSISTENT_STORAGE`` / ``PATHWAY_REPLAY_STORAGE``),
    ``with_http_server``, ``telemetry_config``, ``static_check`` (also
    ``PATHWAY_STATIC_CHECK``), ``connector_policy``, ``watchdog``,
    ``replica_of`` (also ``PATHWAY_REPLICA_OF``), ``qos`` (``False`` is
    the default decision and accepted) and a multi-process cluster
    (``PATHWAY_PROCESSES`` > 1).
    """
    from pathway_tpu_torch.engine.streaming import (UNPORTED,
                                                    refuse_unported)

    if persistence_config is None:
        path = (os.environ.get("PATHWAY_REPLAY_STORAGE")
                or os.environ.get("PATHWAY_PERSISTENT_STORAGE"))
        persistence_config = f"filesystem({path})" if path else None
    refuse_unported(
        persistence_config=persistence_config,
        replica=replica_of or os.environ.get("PATHWAY_REPLICA_OF") or None,
        cluster=(os.environ.get("PATHWAY_PROCESSES")
                 if os.environ.get("PATHWAY_PROCESSES", "1") != "1"
                 else None),
        qos=qos, connector_policy=connector_policy, watchdog=watchdog,
        with_http_server=with_http_server)
    if telemetry_config is not None:
        raise NotImplementedError(
            "telemetry_config is not ported to pathway_tpu_torch yet "
            f"(ROADMAP queue 1, {UNPORTED['with_http_server']})")
    check = static_check or os.environ.get("PATHWAY_STATIC_CHECK", "off")
    if check not in ("off", ""):
        raise NotImplementedError(
            f"static_check={check!r} is not ported to pathway_tpu_torch "
            "yet (ROADMAP queue 1, item 6g: the static analyzer)")

    runner = GraphRunner()
    for binder in G.output_binders:
        binder(runner)
    if runner._stream_subjects:
        from pathway_tpu_torch.engine.streaming import StreamingRuntime

        StreamingRuntime(runner, monitoring_level=monitoring_level,
                         terminate_on_error=terminate_on_error,
                         trace_path=trace_path).run()
    else:
        from pathway_tpu_torch.engine.flight_recorder import FlightRecorder

        runner.run_batch(
            recorder=FlightRecorder.from_env(trace_path=trace_path))
    for on_end in getattr(runner, "_on_end_callbacks", ()):
        on_end()  # pw.io.subscribe(on_end=...): the run has finished
    return runner
