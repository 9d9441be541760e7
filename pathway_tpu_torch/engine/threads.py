"""Engine thread factory + the package-wide ``threading.excepthook`` —
port of pathway_tpu/engine/threads.py (its live-thread inventory and the
profiler's role lookup are not ported).

Every long-lived engine thread (device-bridge worker, connector readers,
the webserver's event loop, ``run_server(threaded=True)``) is created
through :func:`spawn`, named ``pathway-tpu-<role>``. The factory
installs a process-wide ``threading.excepthook`` (chained in front of the
previous hook, so stderr tracebacks still appear) that records an
uncaught exception in the global ErrorLog (kind="thread") and in
:func:`crashed_threads`: an engine thread never dies silently.

Connector reader crashes are not routed through the excepthook: the
reader's own wrapper (io/_datasource.py ``DataSource.start``) closes its
session with the error, and the streaming runtime re-raises it.
"""

from __future__ import annotations

import threading

__all__ = ["crash_epoch", "crashed_threads", "install_excepthook", "spawn"]

NAME_PREFIX = "pathway-tpu-"


# uncaught-exception records: {"thread": name, "error": "Type: msg"}.
# Appends are list.append (atomic); readers copy.
_CRASHES: list[dict] = []

_PREV_HOOK = None
_INSTALLED = False
_install_lock = threading.Lock()


def _pathway_excepthook(args) -> None:
    """Record an uncaught thread exception in the ErrorLog + crash list,
    then chain to the previous hook (default: stderr traceback)."""
    if args.exc_type is SystemExit:
        if _PREV_HOOK is not None:
            _PREV_HOOK(args)
        return
    name = args.thread.name if args.thread is not None else "<unknown>"
    err = f"{args.exc_type.__name__}: {args.exc_value}"
    _CRASHES.append({"thread": name, "error": err})
    try:
        from pathway_tpu_torch.internals.error import global_error_log

        global_error_log().log(
            f"uncaught exception in thread {name!r}: {err}",
            operator=f"thread:{name}", kind="thread")
    except Exception:
        pass  # the hook must never raise — that kills the report too
    if _PREV_HOOK is not None:
        _PREV_HOOK(args)


def install_excepthook() -> None:
    """Idempotently install the engine excepthook (chained). Called on
    first :func:`spawn`; StreamingRuntime calls it eagerly, so threads not
    made by the factory get crash accounting too."""
    global _PREV_HOOK, _INSTALLED
    with _install_lock:
        if _INSTALLED:
            return
        _PREV_HOOK = threading.excepthook
        threading.excepthook = _pathway_excepthook
        _INSTALLED = True


def spawn(target, *, name: str, daemon: bool = True, args: tuple = (),
          kwargs: dict | None = None, start: bool = True) -> threading.Thread:
    """Create (and by default start) an engine thread named
    ``pathway-tpu-<name>``, registered in the live inventory and covered by
    the excepthook."""
    install_excepthook()
    if not name.startswith("pathway-tpu"):
        name = NAME_PREFIX + name
    t = threading.Thread(target=target, args=args, kwargs=kwargs or {},
                         daemon=daemon, name=name)
    if start:
        t.start()
    return t


def crashed_threads(since: int = 0) -> list[dict]:
    """Uncaught-exception records since process start (or since the
    epoch ``since``, see :func:`crash_epoch`)."""
    return list(_CRASHES[since:])


def crash_epoch() -> int:
    """Marker for "crashes from now on", for :func:`crashed_threads`."""
    return len(_CRASHES)
