"""Static type lattice for schemas and expressions — port of
pathway_tpu/internals/dtype.py.

A lattice of column dtypes with Optional/Tuple/Array parametric types,
wrapping of Python annotations, and least-common-ancestor computation used
by `if_else`, `concat` and friends. Every dtype knows its numpy storage
dtype so the engine can keep numeric columns as dense arrays and only falls
back to object columns for variant data.
"""

from __future__ import annotations

import datetime
import typing
from abc import ABC
from typing import Any, Callable, Mapping, Optional as TOptional

import numpy as np
import torch


class DType(ABC):
    """Base of all column dtypes."""

    _name: str = "DType"

    @property
    def typehint(self) -> Any:
        return Any

    # numpy storage dtype for engine columns ("object" = host boxed values)
    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(object)

    @property
    def is_numeric(self) -> bool:
        return self.np_dtype != np.dtype(object) or self is BOOL

    def is_value_compatible(self, value: Any) -> bool:
        return True

    def __repr__(self) -> str:
        return self._name

    def __hash__(self):
        return hash(repr(self))

    def __eq__(self, other):
        return isinstance(other, DType) and repr(self) == repr(other)

    def equivalent_to(self, other: "DType") -> bool:
        return dtype_issubclass(self, other) and dtype_issubclass(other, self)


class _SimpleDType(DType):
    def __init__(self, name: str, typehint: Any, np_dtype: Any,
                 check: TOptional[Callable[[Any], bool]] = None):
        self._name = name
        self._typehint = typehint
        self._np = np.dtype(np_dtype)
        self._check = check

    @property
    def typehint(self) -> Any:
        return self._typehint

    @property
    def np_dtype(self) -> np.dtype:
        return self._np

    def is_value_compatible(self, value: Any) -> bool:
        if self._check is not None:
            return self._check(value)
        return True


class Pointer(DType):
    """128-bit row id. Parametrized variant ``Pointer[S]`` not tracked yet."""

    _name = "Pointer"

    def __init__(self, *args):
        self._args = args
        if args:
            self._name = f"Pointer[{', '.join(repr(a) for a in args)}]"

    @property
    def typehint(self):
        from pathway_tpu_torch.internals.keys import Pointer as PointerValue

        return PointerValue

    def is_value_compatible(self, value):
        from pathway_tpu_torch.internals.keys import Pointer as PointerValue

        return isinstance(value, PointerValue)


ANY = _SimpleDType("ANY", Any, object)
NONE = _SimpleDType("NONE", type(None), object, lambda v: v is None)
BOOL = _SimpleDType("bool", bool, np.bool_, lambda v: isinstance(v, (bool, np.bool_)))
INT = _SimpleDType(
    "int", int, np.int64,
    lambda v: isinstance(v, (int, np.integer)) and not isinstance(v, bool),
)
FLOAT = _SimpleDType(
    "float", float, np.float64,
    lambda v: isinstance(v, (int, float, np.integer, np.floating))
    and not isinstance(v, bool),
)
STR = _SimpleDType("str", str, object, lambda v: isinstance(v, str))
BYTES = _SimpleDType("bytes", bytes, object, lambda v: isinstance(v, bytes))
POINTER = Pointer()
DATE_TIME_NAIVE = _SimpleDType(
    "DateTimeNaive", "DateTimeNaive", "datetime64[ns]",
    lambda v: isinstance(v, datetime.datetime) or isinstance(v, np.datetime64),
)
DATE_TIME_UTC = _SimpleDType(
    "DateTimeUtc", "DateTimeUtc", object,
    lambda v: isinstance(v, datetime.datetime) or isinstance(v, np.datetime64),
)
DURATION = _SimpleDType(
    "Duration", "Duration", "timedelta64[ns]",
    lambda v: isinstance(v, datetime.timedelta) or isinstance(v, np.timedelta64),
)
ERROR = _SimpleDType("ERROR", "Error", object)


class _Json(DType):
    _name = "Json"

    @property
    def typehint(self):
        from pathway_tpu_torch.internals.json import Json as JsonValue

        return JsonValue


JSON = _Json()


class Optional(DType):
    """``Optional(T)`` — T or None.  Flattens nested optionals."""

    def __new__(cls, wrapped: DType):
        if isinstance(wrapped, Optional) or wrapped in (NONE, ANY):
            return wrapped
        self = super().__new__(cls)
        self.wrapped = wrapped
        self._name = f"Optional({wrapped!r})"
        return self

    @property
    def typehint(self):
        return typing.Optional[self.wrapped.typehint]

    @property
    def np_dtype(self) -> np.dtype:
        # floats can hold NaN; everything else degrades to object when nullable
        if self.wrapped is FLOAT:
            return np.dtype(np.float64)
        return np.dtype(object)

    def is_value_compatible(self, value):
        return value is None or self.wrapped.is_value_compatible(value)


class Tuple(DType):
    """Heterogeneous fixed-arity tuple ``Tuple(T1, T2, …)``."""

    def __init__(self, *args: DType):
        self.args = tuple(args)
        self._name = f"Tuple({', '.join(repr(a) for a in args)})"

    @property
    def typehint(self):
        return typing.Tuple[tuple(a.typehint for a in self.args)]

    def is_value_compatible(self, value):
        return isinstance(value, tuple) and len(value) == len(self.args) and all(
            a.is_value_compatible(v) for a, v in zip(self.args, value)
        )


class List(DType):
    """Homogeneous variable-length tuple ``List(T)``."""

    def __init__(self, arg: DType):
        self.wrapped = arg
        self._name = f"List({arg!r})"

    @property
    def typehint(self):
        return typing.Tuple[self.wrapped.typehint, ...]

    def is_value_compatible(self, value):
        return isinstance(value, (tuple, list))


ANY_TUPLE = List(ANY)


class Array(DType):
    """N-dim numeric array ``Array(n_dim, wrapped)`` (ndarray-valued cells).

    These are the cells the engine promotes to stacked device tensors
    (e.g. embedding columns feeding the KNN kernels).
    """

    def __init__(self, n_dim: TOptional[int] = None, wrapped: DType = ANY):
        self.n_dim = n_dim
        self.wrapped = wrapped
        self._name = f"Array({n_dim}, {wrapped!r})"

    @property
    def typehint(self):
        return np.ndarray

    def is_value_compatible(self, value):
        return isinstance(value, (np.ndarray, torch.Tensor))


ANY_ARRAY = Array(None, ANY)


class Callable_(DType):
    def __init__(self, arg_types=..., return_type: DType = ANY):
        self.arg_types = arg_types
        self.return_type = return_type
        self._name = f"Callable({arg_types}, {return_type!r})"

    @property
    def typehint(self):
        return typing.Callable


class Future(DType):
    """Result of a fully-async UDF not yet awaited (reference: dtype.Future)."""

    def __new__(cls, wrapped: DType):
        if isinstance(wrapped, Future):
            return wrapped
        self = super().__new__(cls)
        self.wrapped = wrapped
        self._name = f"Future({wrapped!r})"
        return self

    @property
    def typehint(self):
        return typing.Awaitable[self.wrapped.typehint]


_SIMPLE_WRAPS: Mapping[Any, DType] = {}


def _build_wrap_table():
    global _SIMPLE_WRAPS
    from pathway_tpu_torch.internals.keys import Pointer as PointerValue
    from pathway_tpu_torch.internals.json import Json as JsonValue

    _SIMPLE_WRAPS = {
        Any: ANY,
        ...: ANY,
        type(None): NONE,
        None: NONE,
        bool: BOOL,
        int: INT,
        np.int64: INT,
        np.int32: INT,
        float: FLOAT,
        np.float64: FLOAT,
        np.float32: FLOAT,
        str: STR,
        bytes: BYTES,
        PointerValue: POINTER,
        JsonValue: JSON,
        dict: JSON,
        datetime.datetime: DATE_TIME_NAIVE,
        datetime.timedelta: DURATION,
        np.ndarray: ANY_ARRAY,
    }


def wrap(input_type: Any) -> DType:
    """Convert a Python annotation / dtype literal into a DType."""
    if isinstance(input_type, DType):
        return input_type
    if not _SIMPLE_WRAPS:
        _build_wrap_table()
    if input_type in _SIMPLE_WRAPS:
        return _SIMPLE_WRAPS[input_type]
    origin = typing.get_origin(input_type)
    args = typing.get_args(input_type)
    if origin is typing.Union:
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == len(args):
            return ANY
        if len(non_none) == 1:
            return Optional(wrap(non_none[0]))
        return ANY
    if origin in (tuple, typing.Tuple):
        if len(args) == 2 and args[1] is Ellipsis:
            return List(wrap(args[0]))
        return Tuple(*[wrap(a) for a in args])
    if origin in (list, typing.List):
        return List(wrap(args[0]) if args else ANY)
    if origin is typing.Callable or input_type is typing.Callable:
        return Callable_()
    if isinstance(input_type, str):
        named = {
            "DateTimeNaive": DATE_TIME_NAIVE,
            "DateTimeUtc": DATE_TIME_UTC,
            "Duration": DURATION,
        }
        if input_type in named:
            return named[input_type]
    if input_type is datetime.datetime:
        return DATE_TIME_NAIVE
    try:
        npdt = np.dtype(input_type)
    except Exception:
        return ANY
    if np.issubdtype(npdt, np.bool_):
        return BOOL
    if np.issubdtype(npdt, np.integer):
        return INT
    if np.issubdtype(npdt, np.floating):
        return FLOAT
    if np.issubdtype(npdt, np.str_):
        return STR
    return ANY


def unoptionalize(dtype: DType) -> DType:
    return dtype.wrapped if isinstance(dtype, Optional) else dtype


def is_optional(dtype: DType) -> bool:
    return isinstance(dtype, Optional) or dtype in (NONE, ANY)


def dtype_issubclass(left: DType, right: DType) -> bool:
    """Is every `left` value a valid `right` value (lattice ≤)?"""
    if right is ANY or left is right or left == right:
        return True
    if left is NONE:
        return isinstance(right, Optional) or right is NONE
    if isinstance(left, Optional):
        return isinstance(right, Optional) and dtype_issubclass(
            left.wrapped, right.wrapped
        )
    if isinstance(right, Optional):
        return dtype_issubclass(left, right.wrapped)
    if left is INT and right is FLOAT:
        return True
    if left is BOOL and right is INT:
        return False
    if isinstance(left, (Tuple, List)) and right == ANY_TUPLE:
        return True
    if isinstance(left, Tuple) and isinstance(right, Tuple):
        return len(left.args) == len(right.args) and all(
            dtype_issubclass(l, r) for l, r in zip(left.args, right.args)
        )
    if isinstance(left, List) and isinstance(right, List):
        return dtype_issubclass(left.wrapped, right.wrapped)
    if isinstance(left, Array) and isinstance(right, Array):
        return True
    if isinstance(left, Pointer) and isinstance(right, Pointer):
        return True
    return False


def types_lca(left: DType, right: DType, raising: bool = False) -> DType:
    """Least common ancestor of two dtypes (used by if_else / concat / coalesce)."""
    if dtype_issubclass(left, right):
        return right
    if dtype_issubclass(right, left):
        return left
    if left is NONE:
        return Optional(right)
    if right is NONE:
        return Optional(left)
    if isinstance(left, Optional) or isinstance(right, Optional):
        inner = types_lca(unoptionalize(left), unoptionalize(right), raising=raising)
        return Optional(inner)
    if {left, right} == {INT, FLOAT}:
        return FLOAT
    if isinstance(left, Tuple) and isinstance(right, Tuple):
        if len(left.args) == len(right.args):
            return Tuple(*[types_lca(l, r) for l, r in zip(left.args, right.args)])
        return ANY_TUPLE
    if isinstance(left, (Tuple, List)) and isinstance(right, (Tuple, List)):
        return ANY_TUPLE
    if isinstance(left, Array) and isinstance(right, Array):
        return ANY_ARRAY
    if raising:
        raise TypeError(f"no common supertype of {left!r} and {right!r}")
    return ANY


def types_lca_many(*dtypes: DType, raising: bool = False) -> DType:
    out = NONE
    for dt in dtypes:
        out = types_lca(out, dt, raising=raising)
    return out


def coerce_value(value: Any, dtype: DType) -> Any:
    """Best-effort cast of a scalar to `dtype` (used by connectors/markdown parsing)."""
    if value is None:
        return None
    target = unoptionalize(dtype)
    if target is FLOAT and isinstance(value, (int, np.integer)):
        return float(value)
    if target is INT and isinstance(value, (float, np.floating)) and float(value).is_integer():
        return int(value)
    if isinstance(value, str) and target in (INT, FLOAT, BOOL):
        # textual connectors (csv/dsv) deliver strings; parse per schema
        # (best-effort: unparseable text passes through unchanged). The
        # bool vocabulary matches the DSV parser's (io/formats.py
        # _parse_typed, data_format.rs:403) so csv and dsv agree.
        try:
            if target is INT:
                return int(value)
            if target is FLOAT:
                return float(value)
            low = value.strip().lower()
            if low in ("true", "t", "yes", "y", "on", "1"):
                return True
            if low in ("false", "f", "no", "n", "off", "0"):
                return False
            return value
        except ValueError:
            return value
    if target is STR and not isinstance(value, str):
        return str(value)
    if target is BOOL and not isinstance(value, bool):
        return bool(value)
    return value


def normalize_scalar(value: Any) -> Any:
    """Normalize numpy scalars coming out of columnar storage to Python values."""
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.str_):
        return str(value)
    return value
