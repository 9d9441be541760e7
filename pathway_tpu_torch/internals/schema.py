"""Class-based schemas — port of pathway_tpu/internals/schema.py.

``class MySchema(pw.Schema): x: int = pw.column_definition(primary_key=True)``
plus builders: schema_from_types / schema_from_dict / schema_builder /
schema_from_csv, schema union via ``|``. The pandas builder is not ported
(ROADMAP queue 1, step 9: pandas I/O).
"""

from __future__ import annotations

import csv as _csv
import typing
from dataclasses import dataclass
from typing import Any, Mapping

from pathway_tpu_torch.internals import dtype as dt


@dataclass
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = ...
    dtype: dt.DType | None = None
    name: str | None = None
    append_only: bool | None = None
    _description: str | None = None
    example: Any = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not ...


def column_definition(*, primary_key: bool = False, default_value: Any = ...,
                      dtype: Any = None, name: str | None = None,
                      append_only: bool | None = None, description: str | None = None,
                      example: Any = None) -> Any:
    return ColumnDefinition(
        primary_key=primary_key,
        default_value=default_value,
        dtype=dt.wrap(dtype) if dtype is not None else None,
        name=name,
        append_only=append_only,
        _description=description,
        example=example,
    )


@dataclass
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = ...
    append_only: bool = False
    description: str | None = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not ...

    @property
    def typehint(self):
        return self.dtype.typehint


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnSchema]

    def __init__(cls, name, bases, namespace, append_only: bool | None = None,
                 **kwargs):
        super().__init__(name, bases, namespace)
        columns: dict[str, ColumnSchema] = {}
        for base in bases:
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)
        hints = {}
        try:
            hints = typing.get_type_hints(cls)
        except Exception:
            hints = dict(namespace.get("__annotations__", {}))
        for attr, hint in namespace.get("__annotations__", {}).items():
            if attr.startswith("__"):
                continue
            hint = hints.get(attr, hint)
            definition = namespace.get(attr, None)
            if not isinstance(definition, ColumnDefinition):
                definition = ColumnDefinition(
                    default_value=definition if attr in namespace else ...
                )
            col_dtype = definition.dtype or dt.wrap(hint)
            col_name = definition.name or attr
            columns[attr] = ColumnSchema(
                name=col_name,
                dtype=col_dtype,
                primary_key=definition.primary_key,
                default_value=definition.default_value,
                append_only=bool(
                    definition.append_only
                    if definition.append_only is not None
                    else (append_only or False)
                ),
                description=definition._description,
            )
        cls.__columns__ = columns

    # -- public api on schema classes --------------------------------------
    def column_names(cls) -> list[str]:
        return [c.name for c in cls.__columns__.values()]

    def columns(cls) -> Mapping[str, ColumnSchema]:
        return dict(cls.__columns__)

    def primary_key_columns(cls) -> list[str] | None:
        pkeys = [c.name for c in cls.__columns__.values() if c.primary_key]
        return pkeys or None

    def typehints(cls) -> dict[str, Any]:
        return {c.name: c.dtype.typehint for c in cls.__columns__.values()}

    def _dtypes(cls) -> dict[str, dt.DType]:
        return {c.name: c.dtype for c in cls.__columns__.values()}

    def default_values(cls) -> dict[str, Any]:
        return {
            c.name: c.default_value
            for c in cls.__columns__.values()
            if c.has_default_value
        }

    def keys(cls):
        return cls.column_names()

    def __getitem__(cls, name) -> ColumnSchema:
        for c in cls.__columns__.values():
            if c.name == name:
                return c
        raise KeyError(name)

    def __or__(cls, other):
        cols = {**cls.__columns__, **other.__columns__}
        return schema_from_columns(cols, name=f"{cls.__name__}|{other.__name__}")

    def __repr__(cls):
        body = ", ".join(f"{c.name}: {c.dtype!r}" for c in cls.__columns__.values())
        return f"<pw.Schema {cls.__name__}({body})>"

    def __eq__(cls, other):
        if not isinstance(other, SchemaMetaclass):
            return NotImplemented
        return cls._dtypes() == other._dtypes()

    def __hash__(cls):
        return hash(tuple(sorted((n, repr(d)) for n, d in cls._dtypes().items())))

    def with_types(cls, **kwargs):
        cols = dict(cls.__columns__)
        for name, hint in kwargs.items():
            if name not in cols:
                raise ValueError(f"no column {name!r} in schema")
            old = cols[name]
            cols[name] = ColumnSchema(
                name=old.name, dtype=dt.wrap(hint), primary_key=old.primary_key,
                default_value=old.default_value, append_only=old.append_only,
            )
        return schema_from_columns(cols, name=cls.__name__)

    def without(cls, *columns):
        names = {
            c if isinstance(c, str) else c.name for c in columns
        }
        cols = {k: v for k, v in cls.__columns__.items() if v.name not in names}
        return schema_from_columns(cols, name=cls.__name__)

    def update_properties(cls, **kwargs):
        return cls

    def universe_properties(cls):
        return None


class SchemaProperties:
    """Schema-wide properties (reference: internals/schema.py
    SchemaProperties — ``append_only`` marks every column append-only)."""

    def __init__(self, append_only: bool | None = None):
        self.append_only = append_only


class Schema(metaclass=SchemaMetaclass):
    """Base class for user schemas."""

    __properties__: "SchemaProperties | None" = None

    @classmethod
    def properties(cls) -> "SchemaProperties | None":
        return cls.__properties__


def schema_from_columns(columns: dict[str, ColumnSchema], name: str = "Schema"):
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    return cls


def schema_from_types(_name: str = "Schema", **kwargs) -> type[Schema]:
    cols = {
        name: ColumnSchema(name=name, dtype=dt.wrap(hint))
        for name, hint in kwargs.items()
    }
    return schema_from_columns(cols, name=_name)


def schema_from_dict(columns: dict, name: str = "Schema") -> type[Schema]:
    cols = {}
    for cname, spec in columns.items():
        if isinstance(spec, dict):
            cols[cname] = ColumnSchema(
                name=cname,
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", ...),
            )
        else:
            cols[cname] = ColumnSchema(name=cname, dtype=dt.wrap(spec))
    return schema_from_columns(cols, name=name)


def schema_builder(columns: dict[str, ColumnDefinition], *,
                   name: str = "Schema", properties=None) -> type[Schema]:
    schema_append_only = bool(getattr(properties, "append_only", False))
    cols = {}
    for cname, definition in columns.items():
        cols[cname] = ColumnSchema(
            name=definition.name or cname,
            dtype=definition.dtype or dt.ANY,
            primary_key=definition.primary_key,
            default_value=definition.default_value,
            append_only=bool(definition.append_only
                             or schema_append_only),
        )
    out = schema_from_columns(cols, name=name)
    out.__properties__ = properties
    return out


def schema_from_csv(path: str, *, name: str = "Schema", properties=None,
                    delimiter: str = ",", comment_character: str | None = None,
                    quote: str = '"', double_quote_escapes: bool = True,
                    num_parsed_rows: int | None = None) -> type[Schema]:
    with open(path, newline="") as f:
        reader = _csv.reader(f, delimiter=delimiter, quotechar=quote)
        rows = []
        header = None
        for row in reader:
            if comment_character and row and row[0].startswith(comment_character):
                continue
            if header is None:
                header = row
                continue
            rows.append(row)
            if num_parsed_rows is not None and len(rows) >= num_parsed_rows:
                break
    assert header is not None, "empty csv"
    cols = {}
    for i, cname in enumerate(header):
        values = [r[i] for r in rows if i < len(r)]
        cols[cname] = ColumnSchema(name=cname, dtype=_infer_str_dtype(values))
    return schema_from_columns(cols, name=name)


def _infer_str_dtype(values: list[str]) -> dt.DType:
    def all_parse(fn):
        try:
            for v in values:
                fn(v)
            return True
        except ValueError:
            return False

    if not values:
        return dt.STR
    if all_parse(int):
        return dt.INT
    if all_parse(float):
        return dt.FLOAT
    if all(v.lower() in ("true", "false") for v in values):
        return dt.BOOL
    return dt.STR
