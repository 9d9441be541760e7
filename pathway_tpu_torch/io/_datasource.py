"""Streaming datasource machinery shared by the input connectors — port of
pathway_tpu/io/_datasource.py.

A DataSource runs on its own thread and pushes parsed rows into a
session; the streaming runtime (engine/streaming.py) drains the sessions
each commit tick, assigns the next logical timestamp and steps the
scheduler. Not ported: connector supervision policies (restart/backoff,
engine/supervisor.py), which :func:`apply_connector_policy` refuses.
"""

from __future__ import annotations

import itertools
import queue
import threading
import weakref
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import Pointer, hash_values

_SUPERVISOR = "ROADMAP queue 1, item 6c: the connector supervisor and watchdog"

_source_counter = itertools.count()


class Session:
    """Thread-safe buffer between a connector thread and the scheduler."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.closed = threading.Event()
        # terminal state: a session closed by a crashing reader is NOT
        # end-of-stream — the runtime re-raises the reader's error
        self.closed_reason: str | None = None  # "eos" | "error"
        self.error: BaseException | None = None
        # set by the runtime at teardown; polling sources observe it via
        # stop_requested / sleep() so reader threads actually terminate
        self.stopping = threading.Event()

    @property
    def stop_requested(self) -> bool:
        return self.stopping.is_set()

    def sleep(self, seconds: float) -> bool:
        """Pause between polls, waking immediately on a stop request.
        Returns True to keep running, False when the source must exit."""
        return not self.stopping.wait(seconds)

    def push(self, key: Pointer, row: tuple, diff: int = 1,
             offset: Any = None) -> None:
        # ``offset`` is a source's durable position, read by the
        # persistence layer (not ported) and ignored here
        self._q.put((key, row, diff))

    def drain(self, limit: int | None = None) -> list[tuple]:
        """Pop buffered entries (all of them, or at most ``limit``)."""
        out = []
        while limit is None or len(out) < limit:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out
        return out

    def backlog(self) -> int:
        """Approximate queued-entry count (producers may race it)."""
        return self._q.qsize()

    def close(self, reason: str = "eos",
              error: BaseException | None = None) -> None:
        if not self.closed.is_set():  # first close wins
            self.closed_reason = reason
            self.error = error
        self.closed.set()


class DataSource:
    """Base class: subclasses implement run(session) on a worker thread."""

    name = "datasource"
    connector_policy = None

    def __init__(self, schema: type[sch.Schema],
                 autocommit_duration_ms: int | None = 1500):
        self.schema = schema
        self.autocommit_duration_ms = autocommit_duration_ms
        self._uid = next(_source_counter)

    def start(self, session: Session) -> threading.Thread:
        def runner():
            # capture the exception instead of swallowing it: a crashed
            # reader closing its session as if end-of-stream would let the
            # runtime flush and report success on partial data
            try:
                self.run(session)
            except BaseException as e:
                session.close(reason="error", error=e)
            else:
                session.close(reason="eos")

        from pathway_tpu_torch.engine.threads import spawn

        return spawn(runner, name=f"src-{self.name}-{self._uid}")

    def run(self, session: Session) -> None:
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    def row_to_engine(self, values: dict, seq: int) -> tuple[Pointer, tuple]:
        names = self.schema.column_names()
        pkeys = self.schema.primary_key_columns()
        dtypes = self.schema._dtypes()
        row = tuple(
            dt.coerce_value(values.get(n), dtypes[n]) for n in names
        )
        if pkeys:
            key = hash_values(*[values.get(k) for k in pkeys])
        else:
            key = hash_values("src", self._uid, seq)
        return key, row


def apply_connector_policy(source: DataSource, kwargs: dict,
                           policy=None) -> DataSource:
    """The ``connector_policy=`` every connector ``read()`` takes. The
    supervisor that would honor it is not ported: a policy raises rather
    than being dropped."""
    if policy is None:
        policy = kwargs.pop("connector_policy", None)
    if policy is not None:
        raise NotImplementedError(
            "connector_policy is not ported to pathway_tpu_torch yet "
            f"({_SUPERVISOR})")
    return source


# live CollectSessions (weak: dies with the read that created it) —
# engine.streaming.stop_all() stops these too
_LIVE_COLLECT_SESSIONS: "weakref.WeakSet[CollectSession]" = weakref.WeakSet()


def stop_collect_sessions() -> None:
    """Request stop on every live CollectSession (teardown path, called
    from engine.streaming.stop_all)."""
    for cs in list(_LIVE_COLLECT_SESSIONS):
        cs.stopping.set()


class CollectSession:
    """Session double folding pushed diffs into final state (the static
    modes of connectors)."""

    closed = False

    def __init__(self):
        self.state: dict = {}
        self.counts: dict = {}
        self.stopping = threading.Event()
        _LIVE_COLLECT_SESSIONS.add(self)

    @property
    def stop_requested(self) -> bool:
        return self.stopping.is_set()

    def sleep(self, seconds: float) -> bool:
        return not self.stopping.wait(seconds)

    def push(self, key, row, diff=1, offset=None):
        c = self.counts.get(key, 0) + diff
        self.counts[key] = c
        if c > 0:
            self.state[key] = row
        else:
            self.state.pop(key, None)
            self.counts.pop(key, None)


class CallbackSource(DataSource):
    """Wraps a generator function yielding dict rows."""

    def __init__(self, fn: Callable, schema, autocommit_duration_ms=1500,
                 name="callback"):
        super().__init__(schema, autocommit_duration_ms)
        self.fn = fn
        self.name = name

    def run(self, session: Session) -> None:
        seq = 0
        for values in self.fn():
            key, row = self.row_to_engine(values, seq)
            session.push(key, row, 1)
            seq += 1
