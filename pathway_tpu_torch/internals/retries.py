"""Retry strategies of async UDF execution — port of
pathway_tpu/internals/retries.py.

The strategies expose two surfaces over the same schedule:

- ``delay_for_attempt(attempt)`` — the synchronous schedule: seconds to wait
  before retry number ``attempt`` (0-based); the unit-testable contract.
- ``invoke(fn, *args, **kwargs)`` — the async combinator wrapping a
  coroutine call with up to ``max_retries`` retries, sleeping the schedule
  between attempts. UDF executors consume this.

``ExponentialBackoffRetryStrategy`` supports a ``max_delay_ms`` cap and
full jitter (uniform over ``[0, capped_delay]``), seeded for deterministic
schedules under test.
"""

from __future__ import annotations

import asyncio
import random
from typing import Callable


class AsyncRetryStrategy:
    """Base strategy: subclasses define the schedule and retry budget."""

    async def invoke(self, fn: Callable, /, *args, **kwargs):
        raise NotImplementedError

    def delay_for_attempt(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt`` (0-based)."""
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, fn, /, *args, **kwargs):
        return await fn(*args, **kwargs)

    def delay_for_attempt(self, attempt: int) -> float:
        raise RuntimeError("NoRetryStrategy never retries")


class FixedDelayRetryStrategy(AsyncRetryStrategy):
    """Retry up to ``max_retries`` times with a constant pause between
    attempts."""

    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        self.max_retries = max_retries
        self.delay_ms = delay_ms

    def delay_for_attempt(self, attempt: int) -> float:
        return self.delay_ms / 1000

    async def invoke(self, fn, /, *args, **kwargs):
        for attempt in range(self.max_retries + 1):
            try:
                return await fn(*args, **kwargs)
            except asyncio.CancelledError:
                raise
            except Exception:
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(self.delay_for_attempt(attempt))
        raise RuntimeError("unreachable")


class ExponentialBackoffRetryStrategy(FixedDelayRetryStrategy):
    """Exponential schedule ``initial * factor**attempt``, capped at
    ``max_delay_ms``, with optional full jitter.

    Full jitter draws each delay uniformly from ``[0, capped_delay]`` —
    the schedule that de-synchronizes a fleet of failing connectors
    hammering one endpoint. Pass ``seed`` for a deterministic draw
    sequence (tests; reproducing an incident's timing).
    """

    def __init__(self, max_retries: int = 3, initial_delay_ms: int = 1000,
                 backoff_factor: float = 2.0,
                 max_delay_ms: int | None = None,
                 jitter: bool = False, seed: int | None = None):
        super().__init__(max_retries, initial_delay_ms)
        self.backoff_factor = backoff_factor
        self.max_delay_ms = max_delay_ms
        self.jitter = jitter
        self._rng = random.Random(seed)

    def delay_for_attempt(self, attempt: int) -> float:
        delay_ms = self.delay_ms * self.backoff_factor ** attempt
        if self.max_delay_ms is not None:
            delay_ms = min(delay_ms, self.max_delay_ms)
        if self.jitter:
            delay_ms = self._rng.uniform(0.0, delay_ms)
        return delay_ms / 1000
