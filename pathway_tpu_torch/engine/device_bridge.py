"""Asynchronous device bridge: overlap host and device work across ticks —
port of pathway_tpu/engine/device_bridge.py.

The scheduler is bulk-synchronous per tick: with one thread, the sources,
parsers and pure-Python operators of tick t+1 cannot start until tick t's
encoder forward, index write and top-k have retired. This module is a
queue between the host stage and the device stage of the microbatch
engine.

Model: each tick's *device leg* — the downstream closure of every
device-bound operator, stepped in topological order — is submitted as one
FIFO job ("leg") to a single worker thread. The host thread immediately
proceeds to the next tick's host-side work. Because legs are executed
strictly in tick order by one worker, every operator still observes its
ticks in order and per-tick consistency is unchanged; the overlap is purely
between tick t's device leg and tick t+1..t+K's host legs.

Guarantees:

- **Bounded in-flight window**: at most ``max_inflight`` legs (queued +
  running) exist at any moment; ``submit`` blocks (backpressure) when the
  window is full, so a slow device cannot be out-run by the host.
- **Hard barrier**: ``barrier()`` returns only when every submitted leg has
  resolved. Callers place it before anything that externalizes state —
  end-of-stream flush and reading a tick's outputs.
- **Resolved-prefix watermark**: because legs retire strictly in tick
  order, the tick of the last resolved leg is the longest *resolved
  prefix* of submitted work. ``resolved_watermark()`` exposes it as a
  monotone counter; a failed leg freezes it.
- **Error propagation**: a leg that raises poisons the bridge; the pending
  queue is dropped (later ticks must not run on top of a failed one) and
  the *original* exception re-raises on the host thread at the next
  ``submit``/``barrier``, so ``except`` clauses match exactly as they do in
  synchronous mode. A CUDA error raised by a kernel wrapper in a leg
  therefore fails the run on the calling thread.

PyTorch keeps the grad mode, the current stream and the current device per
thread; the worker starts with the defaults (grad on, the default stream,
device 0). The encoder's weights need no grad and its forwards run under
``torch.no_grad()``, and the port's device code runs on the current
stream, the default stream on both threads, so a leg's work is ordered on
the card as it would be in line.

The window is configured with ``PATHWAY_DEVICE_INFLIGHT`` (default 2 —
double buffering; ``1`` disables pipelining entirely). With a flight
recorder (engine/flight_recorder.py) each leg records its queue wait and
execution, its in-flight marker names the tick while it runs, and a leg
that raises carries the recorder's tail as a note on its exception. Not
ported: the fault-injection points and the profiler's leg re-timing
(ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import os
import threading
import time as _time
import weakref
from collections import deque
from typing import Callable

from pathway_tpu_torch.engine.locking import create_condition

# live bridges (weak: a bridge dies with its scheduler): out-of-band
# observers read depth and the in-flight leg without a reference threaded
# through every layer
_LIVE: "weakref.WeakSet[DeviceBridge]" = weakref.WeakSet()


def live_bridge_snapshot() -> dict | None:
    """Stats + in-flight leg of any live bridge (None when no bridge
    exists). With several bridges, prefers one with a leg in flight."""
    best = None
    for b in list(_LIVE):
        snap = b.stats()
        snap["inflight"] = b.inflight()
        if snap["inflight"] is not None:
            return snap
        best = best or snap
    return best


def device_inflight_from_env() -> int:
    """The configured in-flight window (>=1); 1 means synchronous."""
    raw = os.environ.get("PATHWAY_DEVICE_INFLIGHT", "2")
    try:
        return max(1, int(raw))
    except ValueError:
        return 2


class DeviceBridge:
    """FIFO dispatch queue for per-tick device legs (see module doc)."""

    def __init__(self, max_inflight: int = 2, name: str = "device-bridge",
                 recorder=None):
        self.max_inflight = max(1, int(max_inflight))
        self.name = name
        # flight recorder: leg-level spans (queue-wait vs execute) and the
        # in-flight marker for post-mortems; None keeps them dead branches
        self.recorder = recorder
        self._current: tuple | None = None  # (tick, started_monotonic)
        # longest resolved prefix of submitted legs: the tick of the last
        # leg that retired cleanly. 0 = nothing resolved yet; frozen on
        # leg failure.
        self._watermark = 0
        # observer fired (outside the lock, on the worker thread) after
        # every watermark advance
        self.on_advance: Callable[[int], None] | None = None
        _LIVE.add(self)
        self._cv = create_condition("DeviceBridge._cv")
        self._queue: deque = deque()  # (tick, fn, submitted_at)
        self._running = False
        self._error: BaseException | None = None
        self._closed = False
        self._thread: threading.Thread | None = None
        self._waiters = 0  # host threads blocked in submit/barrier
        # -- instrumentation (read via stats()) ----------------------------
        self.legs_dispatched = 0
        self.legs_resolved = 0
        # legs that finished with no host thread waiting on the bridge at
        # any point of their execution: fully overlapped with host work
        self.legs_overlapped = 0
        self.queue_wait_ms = 0.0  # submit -> start, summed
        self.exec_ms = 0.0        # start -> finish, summed
        self.max_depth = 0
        # host time blocked on the bridge: in submit behind a full window,
        # and in barrier / wait_watermark
        self.submit_wait_ms = 0.0
        self.barrier_wait_ms = 0.0

    # ------------------------------------------------------------------
    def depth(self) -> int:
        with self._cv:
            return len(self._queue) + (1 if self._running else 0)

    def _wait(self) -> float:
        """One wait on the condition as a host waiter; returns its ms.
        Lock held."""
        self._waiters += 1
        t0 = _time.perf_counter()
        try:
            self._cv.wait()
        finally:
            self._waiters -= 1
        return (_time.perf_counter() - t0) * 1e3

    def submit(self, tick: int, fn: Callable[[], None]) -> None:
        """Enqueue one tick's device leg; blocks while the window is full.

        Raises the stored leg exception, if any — the host thread is the
        one that must observe device failures.
        """
        with self._cv:
            self._raise_if_error()
            if self._closed:
                raise RuntimeError("device bridge is closed")
            if self._thread is None:
                from pathway_tpu_torch.engine.threads import spawn

                self._thread = spawn(self._work, name=self.name)
            while (len(self._queue) + (1 if self._running else 0)
                   >= self.max_inflight):
                self.submit_wait_ms += self._wait()
                self._raise_if_error()
            self._queue.append((tick, fn, _time.perf_counter()))
            self.legs_dispatched += 1
            depth = len(self._queue) + (1 if self._running else 0)
            if depth > self.max_depth:
                self.max_depth = depth
            self._cv.notify_all()

    def barrier(self) -> None:
        """Block until every submitted leg has resolved; re-raise a leg
        failure. This is the hard consistency point before flushes and
        output reads."""
        with self._cv:
            while (self._queue or self._running) and self._error is None:
                self.barrier_wait_ms += self._wait()
            self._raise_if_error()

    def close(self, join_timeout: float = 10.0) -> None:
        """Drain remaining legs and stop the worker. Leg errors are NOT
        raised here (close runs in ``finally`` paths; errors surface via
        submit/barrier) — but they stay stored for a later barrier."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(join_timeout)

    def inflight(self) -> dict | None:
        """The leg currently executing: tick + seconds since it started
        (None when idle)."""
        cur = self._current
        if cur is None:
            return None
        return {"tick": cur[0],
                "since_s": round(_time.monotonic() - cur[1], 3)}

    def wait_watermark(self, tick: int) -> int:
        """Block until the resolved watermark reaches ``tick``; re-raise a
        leg failure. Unlike :meth:`barrier` this does not wait for the
        queue to drain, and it returns the (possibly short) frontier when
        the bridge goes idle or closed without reaching ``tick``."""
        with self._cv:
            while self._watermark < tick and self._error is None:
                if not self._queue and not self._running:
                    break  # idle/closed: nothing left to advance it
                self.barrier_wait_ms += self._wait()
            self._raise_if_error()
            return self._watermark

    def resolved_watermark(self) -> int:
        """Tick of the longest fully-resolved prefix of submitted legs
        (monotone; 0 before anything resolved)."""
        with self._cv:
            return self._watermark

    def error(self) -> BaseException | None:
        """The stored leg failure, if any (without raising)."""
        with self._cv:
            return self._error

    def stats(self) -> dict:
        with self._cv:
            resolved = self.legs_resolved
            return {
                "max_inflight": self.max_inflight,
                "depth": len(self._queue) + (1 if self._running else 0),
                "resolved_watermark": self._watermark,
                "legs_dispatched": self.legs_dispatched,
                "legs_resolved": resolved,
                "legs_overlapped": self.legs_overlapped,
                "overlap_ratio": (self.legs_overlapped / resolved
                                  if resolved else 0.0),
                "queue_wait_ms": round(self.queue_wait_ms, 3),
                "exec_ms": round(self.exec_ms, 3),
                "max_depth": self.max_depth,
                "submit_wait_ms": round(self.submit_wait_ms, 3),
                "barrier_wait_ms": round(self.barrier_wait_ms, 3),
            }

    # ------------------------------------------------------------------
    def _raise_if_error(self) -> None:
        if self._error is not None:
            raise self._error

    def _work(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:  # closed and drained
                    self._running = False
                    self._cv.notify_all()
                    return
                tick, fn, submitted_at = self._queue.popleft()
                self._running = True
                self._current = (tick, _time.monotonic())
                # a host thread already blocked on us? then this leg is
                # (at least partially) serialized with host work
                waited_at_start = self._waiters > 0
            rec = self.recorder
            recording = rec is not None and rec.enabled
            if recording:
                rec.mark_leg(tick)
            started = _time.perf_counter()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — must cross threads
                if recording:
                    # the poison carries the recorder's tail: the host
                    # thread re-raises this exact object, so the report
                    # names the operator and its user frame
                    from pathway_tpu_torch.engine.flight_recorder import \
                        attach_note

                    tail = rec.dump_tail()
                    if tail:
                        attach_note(
                            e, f"device leg poisoned at tick {tick}; "
                               f"flight recorder tail:\n{tail}")
                with self._cv:
                    self._error = e
                    self._running = False
                    self._current = None
                    # later ticks must not execute on top of a failed one
                    self._queue.clear()
                    self._cv.notify_all()
                continue  # keep serving barrier wake-ups until close
            finished = _time.perf_counter()
            if recording:
                rec.record_leg(tick, (started - submitted_at) * 1e3,
                               (finished - started) * 1e3)
                rec.clear_leg()
            with self._cv:
                self.queue_wait_ms += (started - submitted_at) * 1e3
                self.exec_ms += (finished - started) * 1e3
                self.legs_resolved += 1
                if not waited_at_start and self._waiters == 0:
                    self.legs_overlapped += 1
                # legs resolve strictly in tick order, so this leg's tick
                # IS the longest resolved prefix
                self._watermark = tick
                self._running = False
                self._current = None
                self._cv.notify_all()
            on_advance = self.on_advance
            if on_advance is not None:
                try:
                    on_advance(tick)
                except Exception:  # observer must never poison the bridge
                    pass
