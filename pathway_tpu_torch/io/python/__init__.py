"""pw.io.python — custom Python sources — port of
pathway_tpu/io/python/__init__.py (reference:
python/pathway/io/python/__init__.py:42 ConnectorSubject)."""

from __future__ import annotations

import json as _json

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.table import Plan, Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._datasource import (DataSource, Session,
                                              apply_connector_policy)

_PERSISTENCE = "ROADMAP queue 1, item 6a: persistence and snapshots"


class ConnectorSubject:
    """Subclass and implement run(); emit rows with self.next(**values)."""

    _session: Session | None = None
    _source: "PythonSource | None" = None

    def run(self) -> None:
        raise NotImplementedError

    # -- emission API (reference ConnectorSubject) ---------------------------
    def next(self, **values) -> None:
        self._emit(values, 1)

    def next_json(self, message: dict | str) -> None:
        if isinstance(message, str):
            message = _json.loads(message)
        self.next(**message)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _remove(self, key=None, **values) -> None:
        self._emit(values, -1)

    def _emit(self, values: dict, diff: int) -> None:
        assert self._source is not None and self._session is not None
        key, row = self._source.row_to_engine(values, self._source.bump_seq())
        self._session.push(key, row, diff)

    def commit(self) -> None:
        pass  # commits are driven by the runtime's autocommit clock

    def close(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    @property
    def _deletions_enabled(self) -> bool:
        return True


class PythonSource(DataSource):
    name = "python"

    def __init__(self, subject: ConnectorSubject, schema,
                 autocommit_duration_ms=1500):
        super().__init__(schema, autocommit_duration_ms)
        self.subject = subject
        self._seq = 0

    def bump_seq(self) -> int:
        self._seq += 1
        return self._seq

    def run(self, session: Session) -> None:
        self.subject._session = session
        self.subject._source = self
        try:
            self.subject.run()
        finally:
            try:
                self.subject.on_stop()
            except Exception:
                pass


def read(subject: ConnectorSubject, *, schema: type[sch.Schema] | None = None,
         format: str = "raw", autocommit_duration_ms: int | None = 1500,
         name: str | None = None, persistent_id: str | None = None,
         connector_policy=None, **kwargs) -> Table:
    """A table fed by ``subject.run()`` on its own reader thread. The
    persistence layer is not ported: ``persistent_id`` raises."""
    if persistent_id is not None:
        raise NotImplementedError(
            "pw.io.python.read(persistent_id=...) is not ported to "
            f"pathway_tpu_torch yet ({_PERSISTENCE})")
    if schema is None:
        schema = sch.schema_from_types(data=dt.ANY)
    source = PythonSource(subject, schema,
                          autocommit_duration_ms=autocommit_duration_ms)
    source.persistent_id = name
    apply_connector_policy(source, {}, policy=connector_policy)
    plan = Plan("input", datasource=source)
    return Table(plan, schema, Universe(), name=name or "python_input")
