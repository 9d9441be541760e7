"""User-frame attribution for operator errors — port of
pathway_tpu/internals/trace.py.

Each Table operator captures the first stack frame *outside* the framework
at build time; when the engine later fails inside that operator, the error
carries a note pointing at the user's line, not the scheduler internals.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Trace:
    file_name: str
    line_number: int
    function: str
    line: str

    def __str__(self) -> str:
        return (f'  File "{self.file_name}", line {self.line_number}, '
                f"in {self.function}\n    {self.line}")


def trace_user_frame() -> Trace | None:
    """The innermost stack frame that is not framework code.

    Walks raw frames (sys._getframe) instead of traceback.extract_stack():
    Plan construction calls this once per operator, and extracting the whole
    stack with source lines per call would dominate graph-build time."""
    import linecache
    import sys

    frame = sys._getframe(1)
    pkg_prefix = _PKG_ROOT + os.sep
    while frame is not None:
        fname = os.path.abspath(frame.f_code.co_filename)
        if not fname.startswith(pkg_prefix) and "<frozen" not in fname:
            line = linecache.getline(fname, frame.f_lineno).strip()
            return Trace(frame.f_code.co_filename, frame.f_lineno,
                         frame.f_code.co_name, line)
        frame = frame.f_back
    return None


def add_trace_note(e: BaseException, trace: Trace | None,
                   operator: str = "") -> None:
    """Attach operator + user-frame context to an exception in place,
    preserving its type (PEP 678 notes; reference add_pathway_trace_note).
    Idempotent per operator."""
    note = f"in operator {operator!r}" if operator else "in engine operator"
    if trace is not None:
        note += f"\noccurred here:\n{trace}"
    if note not in getattr(e, "__notes__", ()):
        if hasattr(e, "add_note"):
            e.add_note(note)
        else:  # Python < 3.11: emulate PEP 678 storage
            notes = getattr(e, "__notes__", None)
            if notes is None:
                notes = []
                e.__notes__ = notes
            notes.append(note)


