"""Steady-state device-discipline sanitizer — port of
pathway_tpu/engine/device_sanitizer.py.

Once ``pw.warmup()`` has walked the bucket ladder and declared **steady
state**, a serving process must not pay a one-time set-up cost inside a
live tick, nor stall the host on the card without asking to: either one
is a silent latency cliff.

How the JAX package's two events map onto PyTorch on a GPU:

- **Compile → CUDA graph capture.** Eager torch compiles nothing; its
  one-time cost per shape is the capture of a CUDA graph. Every capture
  site reports to this module (:func:`note_capture`): today that is
  ``GraphedIngestStep`` (ops/knn.py), the int8 ragged ingest step. A
  capture after steady state is a violation, exactly as a post-warm-up
  XLA compile is one in the JAX package.
- **Implicit host→device transfer → implicit host sync.** A CPU operand
  of a CUDA op raises in torch, so torch has no implicit transfer. Its
  silent cliff is the implicit sync instead: ``.item()``, ``.cpu()``, a
  boolean mask, or a blocking copy out of pageable memory, which makes
  the host wait for the whole stream. So the JAX transfer guard becomes
  ``torch.cuda.set_sync_debug_mode``: "error" in raise mode (torch raises
  at the offending call) and "warn" in report mode, where each warning is
  counted and recorded as a violation. On a machine without a card the
  guard is a no-op and only the capture counts run.
- **Explicit fetches stay legal**, as an explicit ``device_put`` stays
  legal in the JAX package: a search's result copy to the host, an
  embedder's result and ``drain()`` run inside :func:`explicit_sync`,
  which lifts the guard for the block (nested and concurrent blocks
  share one lift) and never turns it off for good.

The env contract is the JAX package's:

- Default: nothing is guarded; every helper is a cheap no-op behind one
  env check (captures are still counted, for :func:`install_compile_counter`).
- ``PATHWAY_DEVICE_SANITIZER=1`` (or true/on/yes): :func:`arm` (called by
  ``pw.warmup``) opens the warm-up window, where captures count as
  warm-up; :func:`declare_steady_state` (``pw.warmup`` calls it at the
  end) makes any further capture raise :class:`DeviceDisciplineViolation`
  and sets the sync guard to "error".
- ``PATHWAY_DEVICE_SANITIZER=report`` (or warn): violations are recorded
  (:func:`violations`) and logged, never raised; the sync guard is "warn".

Maintenance windows (extent growth, re-warming) are legal capture sites:
wrap them in :func:`suspend_steady_state`; :func:`disarm` closes the
sanitizer for the rest of the process. ``pw.warmup`` itself suspends
while it walks the ladder. Benches count captures with the sanitizer off
through :func:`install_compile_counter`, and syncs over a window with
:func:`count_syncs` (report mode for that window only), as bench.py's
per-leg compile and transfer counts do.
"""

from __future__ import annotations

import contextlib
import logging
import os
import warnings

import torch

from pathway_tpu_torch.engine.locking import create_lock

logger = logging.getLogger(__name__)

__all__ = [
    "DeviceDisciplineViolation", "arm", "count_syncs",
    "declare_steady_state", "disarm", "explicit_sync", "in_steady_state",
    "install_compile_counter", "note_capture", "post_warmup_compiles",
    "sanitizer_enabled", "suspend_steady_state", "violations",
    "warmup_compiles",
]

#: the text of torch's warning (and error) for a synchronizing CUDA call
#: under ``set_sync_debug_mode``
_SYNC_MESSAGE = "synchronizing CUDA operation"


def sanitizer_enabled() -> bool:
    """Truthy ``PATHWAY_DEVICE_SANITIZER`` arms the sanitizer. Checked at
    arm/declare time — a run toggles by env, and the disabled path stays
    a no-op behind this one check."""
    return os.environ.get("PATHWAY_DEVICE_SANITIZER", "").strip().lower() \
        in ("1", "true", "on", "yes", "report", "warn")


def _raise_on_violation() -> bool:
    return os.environ.get("PATHWAY_DEVICE_SANITIZER", "").strip().lower() \
        not in ("report", "warn")


class DeviceDisciplineViolation(RuntimeError):
    """A CUDA graph capture (or an implicit host sync) landed inside the
    steady-state serving window — a latency cliff on a live tick that
    warm-up was supposed to have taken out."""


class _SanitizerState:
    """Process-wide bookkeeping; tests swap in a fresh one through
    :func:`_reset_for_tests`."""

    def __init__(self):
        self.mutex = create_lock("device_sanitizer.state")
        self.armed = False
        self.steady = False
        self.warmup_compiles = 0
        self.post_warmup_compiles = 0
        self.total_compiles = 0
        self.violation_log: list[dict] = []
        # the sync guard: the mode the sanitizer (or a sync count) holds,
        # the explicit_sync blocks open, and the syncs seen in report mode
        self.guard = "default"
        self.counting = 0
        self.lifts = 0
        self.syncs = 0


_STATE = _SanitizerState()


def _set_sync_debug_mode(mode: str) -> None:
    """torch's process-wide sync debug mode ("default", "warn", "error"),
    where there is a card to guard."""
    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(mode)


def _reset_for_tests() -> None:
    """Fresh counters and flags (unit tests only); also drops any guard
    left set, so one test's steady state cannot poison the next."""
    global _STATE
    _STATE = _SanitizerState()
    _set_sync_debug_mode("default")


def _record_violation(kind: str, message: str) -> None:
    with _STATE.mutex:
        _STATE.violation_log.append({"kind": kind, "message": message})
    if _raise_on_violation():
        raise DeviceDisciplineViolation(message)
    logger.error("device sanitizer: %s", message)


def violations() -> list[dict]:
    """Violations recorded so far (raise mode records before raising)."""
    with _STATE.mutex:
        return list(_STATE.violation_log)


def warmup_compiles() -> int:
    """CUDA graphs captured while armed but before steady state — the
    warm-up window's legitimate ladder walk."""
    return _STATE.warmup_compiles


def post_warmup_compiles() -> int:
    """CUDA graphs captured after :func:`declare_steady_state`."""
    return _STATE.post_warmup_compiles


def in_steady_state() -> bool:
    return _STATE.steady


def note_capture(what: str) -> None:
    """Called by every CUDA graph capture site just before it captures:
    counts the capture, and after steady state records a violation (raised
    in raise mode, before anything is captured)."""
    with _STATE.mutex:
        _STATE.total_compiles += 1
        if not _STATE.armed:
            return
        if not _STATE.steady:
            _STATE.warmup_compiles += 1
            return
        _STATE.post_warmup_compiles += 1
    _record_violation(
        "post-warmup-compile",
        f"CUDA graph capture ({what}) inside the steady-state serving "
        f"window — an unwarmed shape reached a graphed step; bucket the "
        f"dispatch or extend pw.warmup's ladder (wrap legitimate "
        f"maintenance captures in device_sanitizer.suspend_steady_state())")


def install_compile_counter():
    """A zero-argument callable giving the process-lifetime count of CUDA
    graph captures (no env gate, nothing ever raises). Per-leg capture
    counts diff it around the leg."""
    return lambda: _STATE.total_compiles


def _on_sync_warning(message, category, filename, lineno, file=None,
                     line=None):
    if _SYNC_MESSAGE not in str(message):
        return _showwarning_prev(message, category, filename, lineno, file,
                                 line)
    with _STATE.mutex:
        _STATE.syncs += 1
        steady = _STATE.steady
    if steady and sanitizer_enabled() and not _raise_on_violation():
        _record_violation(
            "implicit-sync",
            f"implicit host sync at {filename}:{lineno} inside the "
            f"steady-state serving window; upload through pinned staging, "
            f"keep the value on the device, or wrap an explicit fetch in "
            f"device_sanitizer.explicit_sync()")
    return None


_showwarning_prev = warnings.showwarning


def _hook_sync_warnings() -> None:
    """Route torch's sync warnings to the counter: each occurrence (an
    "always" filter in front) reaches ``_on_sync_warning``. Installed again
    whenever report mode starts, since ``warnings.catch_warnings`` blocks
    restore what they found."""
    global _showwarning_prev
    if warnings.showwarning is not _on_sync_warning:
        _showwarning_prev = warnings.showwarning
        warnings.showwarning = _on_sync_warning
    warnings.filterwarnings("always", message=f".*{_SYNC_MESSAGE}")


def _apply_guard() -> None:
    """Set torch's mode from the state (mutex held): the guard, unless an
    explicit_sync block is open, with a count raising "default" to
    "warn"."""
    mode = _STATE.guard
    if mode == "default" and _STATE.counting:
        mode = "warn"
    if _STATE.lifts:
        mode = "default"
    if mode == "warn":
        _hook_sync_warnings()
    _set_sync_debug_mode(mode)


def _set_guard(mode: str) -> None:
    with _STATE.mutex:
        _STATE.guard = mode
        _apply_guard()


@contextlib.contextmanager
def explicit_sync(why: str = ""):
    """An explicit fetch or wait (a search's result copy, an embedder's
    result, ``drain()``): the sync guard is lifted for the block and
    restored after it. Free when nothing is guarded."""
    with _STATE.mutex:
        if _STATE.guard == "default" and not _STATE.counting:
            guarded = False
        else:
            guarded = True
            _STATE.lifts += 1
            if _STATE.lifts == 1:
                _apply_guard()
    if not guarded:
        yield
        return
    try:
        yield
    finally:
        with _STATE.mutex:
            _STATE.lifts -= 1
            if _STATE.lifts == 0:
                _apply_guard()


class _SyncCount:
    def __init__(self, start: int):
        self.start = start
        self.count = 0


@contextlib.contextmanager
def count_syncs():
    """Count the implicit host syncs of a window (report mode for the
    window when nothing stricter is set; a raise-mode guard stays). Yields
    an object whose ``count`` is set when the block ends."""
    with _STATE.mutex:
        _STATE.counting += 1
        _apply_guard()
        counter = _SyncCount(_STATE.syncs)
    try:
        yield counter
    finally:
        with _STATE.mutex:
            _STATE.counting -= 1
            counter.count = _STATE.syncs - counter.start
            _apply_guard()


def arm() -> bool:
    """Open the warm-up window (captures count as warm-up until
    :func:`declare_steady_state`). Idempotent; no-op (returns False)
    unless ``PATHWAY_DEVICE_SANITIZER`` is set. ``pw.warmup`` calls this
    on entry."""
    if not sanitizer_enabled():
        return False
    with _STATE.mutex:
        _STATE.armed = True
        _STATE.steady = False
    _set_guard("default")
    return True


def declare_steady_state() -> bool:
    """Close the warm-up window: from here on a CUDA graph capture is a
    violation and implicit host syncs are guarded ("error" in raise mode,
    "warn" in report mode). ``pw.warmup`` calls this on completion;
    idempotent; no-op unless ``PATHWAY_DEVICE_SANITIZER`` is set."""
    if not sanitizer_enabled():
        return False
    with _STATE.mutex:
        _STATE.armed = True
        _STATE.steady = True
    _set_guard("error" if _raise_on_violation() else "warn")
    return True


def disarm() -> None:
    """Close the sanitizer in this process: out of steady state, the
    warm-up window closed and the sync guard dropped; counts and recorded
    violations stay. A later ``pw.warmup`` arms it again."""
    with _STATE.mutex:
        _STATE.armed = False
        _STATE.steady = False
    _set_guard("default")


@contextlib.contextmanager
def suspend_steady_state(why: str = ""):
    """Lift steady state for a legitimate maintenance window (extent
    growth, re-warming): captures inside the block count as warm-up, the
    sync guard is dropped, and steady state is declared again on exit.
    Free when not in steady state."""
    if not _STATE.steady:
        yield
        return
    logger.info("device sanitizer: steady state suspended%s",
                f" ({why})" if why else "")
    with _STATE.mutex:
        _STATE.steady = False
    _set_guard("default")
    try:
        yield
    finally:
        declare_steady_state()
