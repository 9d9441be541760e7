"""Scalar/columnar operation implementations for the expression compiler —
port of pathway_tpu/internals/operations.py.

Binary/unary ops per type, casts/conversions, and the dt/str/num method
registry. Implementations are scalar; the compiler maps them over batches
(numpy vectorization for numeric columns happens in the compiler). The
``.dt`` methods work on pandas Timestamps and need pandas, which the port
does not require: without it they raise ``NotImplementedError`` when the
expression is compiled (:func:`pandas_for_dt`).
"""

from __future__ import annotations

import datetime
import math
import operator
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.error import ERROR
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Pointer


def _matmul(a, b):
    return np.matmul(np.asarray(a), np.asarray(b))


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


def _ne(a, b):
    return not _eq(a, b)


BINARY_OPS: dict[str, Callable[[Any, Any], Any]] = {
    "+": operator.add,
    "-": operator.sub,
    "*": operator.mul,
    "/": operator.truediv,
    "//": operator.floordiv,
    "%": operator.mod,
    "**": operator.pow,
    "@": _matmul,
    "==": _eq,
    "!=": _ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "&": lambda a, b: (a & b) if not isinstance(a, bool) or not isinstance(b, bool) else (a and b),
    "|": lambda a, b: (a | b) if not isinstance(a, bool) or not isinstance(b, bool) else (a or b),
    "^": operator.xor,
}

UNARY_OPS: dict[str, Callable[[Any], Any]] = {
    "-": operator.neg,
    "~": lambda a: (not a) if isinstance(a, bool) else ~a,
}

def cast_value(value: Any, target: dt.DType) -> Any:
    if value is None or value is ERROR:
        return value
    t = dt.unoptionalize(target)
    if t is dt.INT:
        return int(value)
    if t is dt.FLOAT:
        return float(value)
    if t is dt.BOOL:
        return bool(value)
    if t is dt.STR:
        return to_string(value)
    return value


def convert_value(value: Any, target: dt.DType, unwrap: bool = False) -> Any:
    """Runtime conversion (as_int/as_float/... — works on Json/Any)."""
    if value is ERROR:
        return value
    if isinstance(value, Json):
        value = value.value
    if value is None:
        if unwrap:
            raise ValueError("cannot convert None")
        return None
    t = dt.unoptionalize(target)
    if t is dt.INT:
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            if isinstance(value, (float, np.floating)) and float(value).is_integer():
                return int(value)
            raise ValueError(f"cannot convert {value!r} to int")
        return int(value)
    if t is dt.FLOAT:
        if isinstance(value, bool) or not isinstance(value, (int, float, np.integer, np.floating)):
            raise ValueError(f"cannot convert {value!r} to float")
        return float(value)
    if t is dt.BOOL:
        if not isinstance(value, (bool, np.bool_)):
            raise ValueError(f"cannot convert {value!r} to bool")
        return bool(value)
    if t is dt.STR:
        if not isinstance(value, str):
            raise ValueError(f"cannot convert {value!r} to str")
        return value
    if t is dt.DURATION:
        if not isinstance(value, datetime.timedelta):
            raise ValueError(f"cannot convert {value!r} to Duration")
        return value
    return value


def to_string(value: Any) -> str:
    if isinstance(value, Json):
        return value.dumps()
    if isinstance(value, float) and value.is_integer() and not math.isinf(value):
        return repr(value)
    if isinstance(value, Pointer):
        return str(value)
    return str(value)


def get_item(obj: Any, index: Any, default: Any, check: bool) -> Any:
    if obj is ERROR or index is ERROR:
        return ERROR
    if obj is None:
        return default if check else None
    try:
        if isinstance(obj, Json):
            if check:
                got = obj.get(index, _MISSING)
                return default if got is _MISSING else got
            return obj[index]
        if isinstance(obj, np.ndarray):
            return dt.normalize_scalar(obj[index])
        return obj[index]
    except (KeyError, IndexError, TypeError):
        if check:
            return default
        raise


class _Missing:
    pass


_MISSING = _Missing()

# ---------------------------------------------------------------------------
# dt/str/num method registry — scalar implementations
# ---------------------------------------------------------------------------


def pandas_for_dt():
    """pandas, which every ``.dt`` method needs; the port runs without it
    (the chip machine has none), so a ``.dt`` expression raises here, at
    compile time, instead of turning every cell into ERROR."""
    try:
        import pandas
    except ImportError:
        raise NotImplementedError(
            "the .dt expression namespace needs pandas, which is not "
            "installed (ROADMAP queue 1, the engine's temporal slice)"
        ) from None
    return pandas


def _ts(v):
    """Normalize datetime-ish to pandas Timestamp."""
    pd = pandas_for_dt()
    if isinstance(v, pd.Timestamp):
        return v
    return pd.Timestamp(v)


def _td(v):
    pd = pandas_for_dt()
    if isinstance(v, pd.Timedelta):
        return v
    return pd.Timedelta(v)


def _strptime(s, fmt, contains_timezone=False):
    # pandas handles %z; naive otherwise
    return pandas_for_dt().Timestamp(datetime.datetime.strptime(s, fmt))


def _dt_timestamp(v, unit="ns"):
    ts = _ts(v)
    if ts.tzinfo is not None:
        ns = ts.value
    else:
        ns = ts.value
    div = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000}[unit]
    return ns // div if div > 1 else ns


def _from_timestamp(v, unit="ns"):
    return pandas_for_dt().Timestamp(v, unit=unit)


def _utc_from_timestamp(v, unit="ns"):
    return pandas_for_dt().Timestamp(v, unit=unit, tz="UTC")


METHODS: dict[str, Callable] = {
    # ---- generic
    "to_string": to_string,
    # ---- num
    "num.abs": abs,
    "num.round": lambda v, decimals=0: round(v, decimals) if decimals else (
        float(round(v)) if isinstance(v, float) else round(v)),
    "num.fill_na": lambda v, default: default
    if v is None or (isinstance(v, float) and math.isnan(v))
    else v,
    # ---- str
    "str.lower": lambda s: s.lower(),
    "str.upper": lambda s: s.upper(),
    "str.reversed": lambda s: s[::-1],
    "str.len": lambda s: len(s),
    "str.strip": lambda s, chars=None: s.strip(chars),
    "str.lstrip": lambda s, chars=None: s.lstrip(chars),
    "str.rstrip": lambda s, chars=None: s.rstrip(chars),
    "str.startswith": lambda s, p: s.startswith(p),
    "str.endswith": lambda s, p: s.endswith(p),
    "str.swapcase": lambda s: s.swapcase(),
    "str.title": lambda s: s.title(),
    "str.capitalize": lambda s: s.capitalize(),
    "str.casefold": lambda s: s.casefold(),
    "str.count": lambda s, sub, start=None, end=None: s.count(
        sub, start if start is not None else 0, end if end is not None else len(s)),
    "str.find": lambda s, sub, start=None, end=None: s.find(
        sub, start if start is not None else 0, end if end is not None else len(s)),
    "str.rfind": lambda s, sub, start=None, end=None: s.rfind(
        sub, start if start is not None else 0, end if end is not None else len(s)),
    "str.removeprefix": lambda s, p: s.removeprefix(p),
    "str.removesuffix": lambda s, p: s.removesuffix(p),
    "str.replace": lambda s, old, new, count=-1: s.replace(old, new, count),
    "str.split": lambda s, sep=None, maxsplit=-1: tuple(s.split(sep, maxsplit)),
    "str.rsplit": lambda s, sep=None, maxsplit=-1: tuple(s.rsplit(sep, maxsplit)),
    "str.slice": lambda s, start, end: s[start:end],
    "str.parse_int": lambda s, optional=False: _parse(int, s, optional),
    "str.parse_float": lambda s, optional=False: _parse(float, s, optional),
    "str.parse_bool": lambda s, true_values=("on", "true", "yes", "1"),
    false_values=("off", "false", "no", "0"), optional=False: _parse_bool(
        s, true_values, false_values, optional),
    # ---- dt (datetime components)
    "dt.nanosecond": lambda v: _ts(v).nanosecond + _ts(v).microsecond * 1000 * 0,
    "dt.microsecond": lambda v: _ts(v).microsecond,
    "dt.millisecond": lambda v: _ts(v).microsecond // 1000,
    "dt.second": lambda v: _ts(v).second,
    "dt.minute": lambda v: _ts(v).minute,
    "dt.hour": lambda v: _ts(v).hour,
    "dt.day": lambda v: _ts(v).day,
    "dt.month": lambda v: _ts(v).month,
    "dt.year": lambda v: _ts(v).year,
    "dt.weekday": lambda v: int(_ts(v).weekday()),
    "dt.timestamp": _dt_timestamp,
    "dt.strftime": lambda v, fmt: _ts(v).strftime(fmt),
    "dt.strptime": _strptime,
    "dt.from_timestamp": _from_timestamp,
    "dt.utc_from_timestamp": _utc_from_timestamp,
    "dt.to_utc": lambda v, from_tz: _ts(v).tz_localize(from_tz).tz_convert("UTC"),
    "dt.to_naive_in_timezone": lambda v, tz: _ts(v).tz_convert(tz).tz_localize(None),
    "dt.round": lambda v, dur: _ts(v).round(_td(dur)),
    "dt.floor": lambda v, dur: _ts(v).floor(_td(dur)),
    # ---- dt (duration accessors)
    "dt.nanoseconds": lambda v: _td(v).value,
    "dt.microseconds": lambda v: _td(v).value // 1_000,
    "dt.milliseconds": lambda v: _td(v).value // 1_000_000,
    "dt.seconds": lambda v: _td(v).value // 1_000_000_000,
    "dt.minutes": lambda v: _td(v).value // 60_000_000_000,
    "dt.hours": lambda v: _td(v).value // 3_600_000_000_000,
    "dt.days": lambda v: _td(v).value // 86_400_000_000_000,
    "dt.weeks": lambda v: _td(v).value // 604_800_000_000_000,
    "dt.add_duration_in_timezone": lambda v, dur, tz: (
        _ts(v).tz_localize(tz) + _td(dur)).tz_localize(None)
    if _ts(v).tzinfo is None
    else _ts(v) + _td(dur),
    "dt.subtract_duration_in_timezone": lambda v, dur, tz: (
        _ts(v).tz_localize(tz) - _td(dur)).tz_localize(None)
    if _ts(v).tzinfo is None
    else _ts(v) - _td(dur),
    "dt.subtract_date_time_in_timezone": lambda a, b, tz: (
        _ts(a).tz_localize(tz) - _ts(b).tz_localize(tz)),
}


def _parse(fn, s, optional):
    try:
        return fn(s.strip()) if isinstance(s, str) else fn(s)
    except (ValueError, TypeError):
        if optional:
            return None
        raise


def _parse_bool(s, true_values, false_values, optional):
    low = s.strip().lower() if isinstance(s, str) else s
    if low in true_values:
        return True
    if low in false_values:
        return False
    if optional:
        return None
    raise ValueError(f"cannot parse {s!r} as bool")
