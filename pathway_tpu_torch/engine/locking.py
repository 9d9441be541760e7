"""Lock factories of pathway_tpu/engine/locking.py as plain ``threading``
locks. The lock sanitizer (PATHWAY_LOCK_SANITIZER) is not ported yet; the
``name`` argument is kept so call sites match the reference."""

from __future__ import annotations

import threading


def create_lock(name: str) -> threading.Lock:
    return threading.Lock()


def create_rlock(name: str) -> threading.RLock:
    return threading.RLock()


def create_condition(name: str) -> threading.Condition:
    return threading.Condition(threading.Lock())
