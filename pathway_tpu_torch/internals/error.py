"""Error value propagation — port of pathway_tpu/internals/error.py.

A cell whose computation failed becomes the ``ERROR`` sentinel; downstream
expressions propagate it; ``fill_error`` replaces it; errors stream into a
global error log instead of aborting the run.
"""

from __future__ import annotations

import threading


class _ErrorValue:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "Error"

    def __bool__(self):
        raise ValueError("cannot use pw Error value in a boolean context")

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return hash("pathway-tpu::Error")


ERROR = _ErrorValue()


def is_error(value) -> bool:
    return value is ERROR


class ErrorLog:
    """Collects (message, operator_name) error rows for the run."""

    def __init__(self):
        self._lock = threading.Lock()
        self.entries: list[dict] = []

    def log(self, message: str, operator: str = "", trace=None,
            kind: str = "cell") -> None:
        """``kind`` tells a cell's error from an engine thread's crash
        ("thread", engine/threads.py) or an absorbed engine failure
        ("engine", engine/streaming.py)."""
        with self._lock:
            self.entries.append({"message": message, "operator": operator,
                                 "trace": trace, "kind": kind})


_global_log = ErrorLog()


def global_error_log() -> ErrorLog:
    """The run-global error log (the JAX package's scoped logs,
    ``pw.local_error_log``, are not ported)."""
    return _global_log
