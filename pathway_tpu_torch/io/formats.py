"""Dependency-free wire formats — port of pathway_tpu/io/formats.py,
trimmed to what ``pw.io.fs`` reads and writes: ``parse_payload`` (binary,
plaintext, plaintext_by_file, csv, dsv, json) and the DSV parser and
formatter. The Debezium CDC parser and the psql formatters feed
connectors the port does not have yet; they raise ``NotImplementedError``
naming their ROADMAP step."""

from __future__ import annotations

import csv as _csv
import io as _io
import json as _json
from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals.json import Json

_CDC = ("ROADMAP queue 1, step 7 (item 6c): the CDC and database "
        "connectors")


@dataclass(frozen=True)
class ParsedEvent:
    kind: str                       # "insert" | "delete" | "upsert"
    key: tuple | None               # primary-key values (None = derive)
    values: dict[str, Any] | None   # None only for upsert-deletes


class ParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# DSV (delimiter-separated values) — data_format.rs:377 (parser), 816
# ---------------------------------------------------------------------------

def _parse_typed(raw: str, dtype) -> Any:
    """String field → engine value, mirroring parse_with_type
    (data_format.rs:412): int/float/bool/json/str."""
    from pathway_tpu_torch.internals import dtype as dt

    if dtype is None or dtype == dt.STR or dtype == dt.ANY:
        return raw
    if dtype == dt.INT:
        return int(raw)
    if dtype == dt.FLOAT:
        return float(raw)
    if dtype == dt.BOOL:
        low = raw.strip().lower()
        # advanced bool parsing (data_format.rs:403): accept common forms
        if low in ("true", "t", "yes", "y", "on", "1"):
            return True
        if low in ("false", "f", "no", "n", "off", "0"):
            return False
        raise ParseError(f"cannot parse {raw!r} as bool")
    if dtype == dt.JSON:
        return Json.parse(raw)
    if dtype == dt.BYTES:
        return raw.encode()
    return raw


def parse_payload(data: bytes, format: str, schema=None,
                  dsv_separator: str = ",") -> list[dict]:
    """Value-dicts from one file's payload, per connector format."""
    if format == "binary":
        return [{"data": data}]
    text = data.decode("utf-8", errors="replace")
    if format == "plaintext_by_file":
        return [{"data": text}]
    if format == "plaintext":
        return [{"data": line} for line in text.splitlines()]
    if format == "csv":
        return list(_csv.DictReader(_io.StringIO(text)))
    if format == "dsv":
        parser = DsvParser(separator=dsv_separator, schema=schema)
        return [ev.values for ev in parser.parse_lines(text)]
    if format in ("json", "jsonlines"):
        return [_json.loads(line) for line in text.splitlines()
                if line.strip()]
    raise ValueError(f"unknown format {format!r}")


class DsvParser:
    """Header-driven DSV with a configurable delimiter.

    First line names the columns; subsequent lines become events. Typed via
    an optional schema. ``value_columns`` restricts which columns land in
    rows; ``key_columns`` extracts the primary key tuple."""

    def __init__(self, *, separator: str = ",", schema=None,
                 value_columns: list[str] | None = None,
                 key_columns: list[str] | None = None):
        if len(separator) != 1:
            raise ParseError("DSV separator must be a single character")
        self.separator = separator
        self.schema = schema
        self.value_columns = value_columns
        self.key_columns = key_columns
        self._header: list[str] | None = None

    def _split(self, line: str) -> list[str]:
        # csv module handles quoting/escaping for any single-char delimiter
        return next(_csv.reader(_io.StringIO(line),
                                delimiter=self.separator))

    def parse_header(self, line: str) -> list[str]:
        self._header = self._split(line.rstrip("\r\n"))
        return self._header

    def parse_line(self, line: str, kind: str = "insert") -> ParsedEvent:
        if self._header is None:
            raise ParseError("DSV header not parsed yet")
        tokens = self._split(line.rstrip("\r\n"))
        if len(tokens) != len(self._header):
            raise ParseError(
                f"DSV row has {len(tokens)} fields, header has "
                f"{len(self._header)}")
        raw = dict(zip(self._header, tokens))
        cols = self.value_columns or self._header
        dtypes = {}
        if self.schema is not None:
            dtypes = {n: self.schema[n].dtype
                      for n in self.schema.column_names() if n in raw}
        values = {}
        for n in cols:
            if n not in raw:
                raise ParseError(f"DSV row is missing column {n!r}")
            values[n] = _parse_typed(raw[n], dtypes.get(n))
        key = None
        if self.key_columns:
            key_vals = []
            for n in self.key_columns:
                if n in values:
                    key_vals.append(values[n])
                elif n in raw:
                    key_vals.append(_parse_typed(raw[n], dtypes.get(n)))
                else:
                    raise ParseError(f"DSV key column {n!r} is not in "
                                     "the header")
            key = tuple(key_vals)
        return ParsedEvent(kind, key, values)

    def parse_lines(self, text: str) -> list[ParsedEvent]:
        out = []
        for i, line in enumerate(text.splitlines()):
            if not line.strip():
                continue
            if self._header is None:
                self.parse_header(line)
                continue
            out.append(self.parse_line(line))
        return out


class DsvFormatter:
    """Rows → DSV lines with trailing time/diff columns (reference
    DsvFormatter appends time and diff, data_format.rs:830-860)."""

    def __init__(self, value_columns: list[str], *, separator: str = ","):
        self.value_columns = value_columns
        self.separator = separator

    def header(self) -> str:
        return self._fmt(self.value_columns + ["time", "diff"])

    def _fmt(self, fields: list) -> str:
        buf = _io.StringIO()
        _csv.writer(buf, delimiter=self.separator,
                    lineterminator="").writerow(fields)
        return buf.getvalue()

    def format(self, values: dict[str, Any], time: int, diff: int) -> str:
        return self._fmt(
            [values[n] for n in self.value_columns] + [time, diff])


class _NotPorted:
    """A format class of the JAX package that the port does not have."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported to pathway_tpu_torch yet "
            f"({_CDC})")


class DebeziumMessageParser(_NotPorted):
    """Debezium CDC messages (not ported)."""


class PsqlUpdatesFormatter(_NotPorted):
    """Postgres update statements (not ported)."""


class PsqlSnapshotFormatter(_NotPorted):
    """Postgres snapshot statements (not ported)."""
