"""Json value wrapper (pw.Json) — port of pathway_tpu/internals/json.py.

A thin immutable wrapper over parsed JSON with ``.as_int()``-style accessors
and ``[]`` item access, so JSON-typed cells round-trip through the engine as
one opaque value (stored in object columns on the host; never shipped to
the device).
"""

from __future__ import annotations

import json as _json
from typing import Any, Iterator


class Json:
    __slots__ = ("_value", "_dumps_cache")

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value._value
        self._value = value
        self._dumps_cache: str | None = None

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, s: str | bytes) -> "Json":
        return cls(_json.loads(s))

    @property
    def value(self) -> Any:
        return self._value

    def dumps(self) -> str:
        # cached: key derivation / fingerprinting serializes the same Json
        # cell at every exchange and groupby it flows through (the wrapper
        # is immutable by contract)
        if self._dumps_cache is None:
            self._dumps_cache = _json.dumps(
                self._value, sort_keys=True, default=_default)
        return self._dumps_cache

    # -- access ------------------------------------------------------------
    def __getitem__(self, item) -> "Json":
        v = self._value
        if isinstance(v, dict):
            if item not in v:
                raise KeyError(item)
            return Json(v[item])
        if isinstance(v, list):
            return Json(v[item])
        raise TypeError(f"Json value {v!r} is not indexable")

    def get(self, item, default=None):
        try:
            return self[item]
        except (KeyError, IndexError, TypeError):
            return default

    def __iter__(self) -> Iterator["Json"]:
        if isinstance(self._value, list):
            return (Json(v) for v in self._value)
        if isinstance(self._value, dict):
            return iter(self._value)
        raise TypeError("Json value is not iterable")

    def __len__(self) -> int:
        return len(self._value)

    def __contains__(self, item) -> bool:
        return item in self._value

    # -- converters (mirror pw.Json API) -----------------------------------
    def as_int(self) -> int:
        if isinstance(self._value, bool) or not isinstance(self._value, int):
            raise ValueError(f"Cannot convert {self!r} to int")
        return self._value

    def as_float(self) -> float:
        if isinstance(self._value, bool) or not isinstance(self._value, (int, float)):
            raise ValueError(f"Cannot convert {self!r} to float")
        return float(self._value)

    def as_str(self) -> str:
        if not isinstance(self._value, str):
            raise ValueError(f"Cannot convert {self!r} to str")
        return self._value

    def as_bool(self) -> bool:
        if not isinstance(self._value, bool):
            raise ValueError(f"Cannot convert {self!r} to bool")
        return self._value

    def as_list(self) -> list:
        if not isinstance(self._value, list):
            raise ValueError(f"Cannot convert {self!r} to list")
        return self._value

    def as_dict(self) -> dict:
        if not isinstance(self._value, dict):
            raise ValueError(f"Cannot convert {self!r} to dict")
        return self._value

    # -- dunder ------------------------------------------------------------
    def __eq__(self, other):
        if isinstance(other, Json):
            return self._value == other._value
        return self._value == other

    def __hash__(self):
        return hash(self.dumps())

    def __repr__(self):
        return f"pw.Json({self._value!r})"

    def __str__(self):
        return self.dumps()

    def __bool__(self):
        return bool(self._value)

    NULL: "Json"


Json.NULL = Json(None)


def _default(obj):
    import numpy as np

    if isinstance(obj, Json):
        return obj.value
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return str(obj)
