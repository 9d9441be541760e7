"""UDF system: pw.udf decorator, executors, retries, caching — port of
pathway_tpu/internals/udfs.py.

Sync UDFs are dispatched once per engine batch (``batch=True``: whole
columns in, a list out); async UDFs gather a whole batch concurrently on
the shared event loop with capacity/timeout/retry. Caching: the
in-memory strategy, the pickle-file ``DiskCache`` (``DefaultCache``) and
the process-wide default cache, which ``VectorStoreServer.run_server(
with_cache=True)`` sets and every UDF prepared after it takes when it did
not pick its own strategy.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import inspect
import os
import pickle
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as ex


# ---------------------------------------------------------------------------
# retry strategies — one shared implementation with connector supervision
# (internals/retries.py; reference: udfs/retries.py). Re-exported here so
# ``pw.udfs.FixedDelayRetryStrategy`` et al. keep their historical home.
# ---------------------------------------------------------------------------

from pathway_tpu_torch.internals.retries import (  # noqa: F401
    AsyncRetryStrategy,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    NoRetryStrategy,
)


# ---------------------------------------------------------------------------
# cache strategies (reference: udfs/caches.py)
# ---------------------------------------------------------------------------

# process-wide default cache used by UDFs constructed without an explicit
# cache_strategy; activated by server run(with_cache=True, cache_backend=...)
# (reference: udfs/caches.py)
_DEFAULT_CACHE: "CacheStrategy | None" = None


def set_default_cache(strategy: "CacheStrategy | None") -> None:
    """Set the cache strategy applied to UDFs that did not pick their own.
    Applies to UDFs prepared after this call."""
    global _DEFAULT_CACHE
    _DEFAULT_CACHE = strategy


def get_default_cache() -> "CacheStrategy | None":
    return _DEFAULT_CACHE


class CacheStrategy:
    def wrap_async(self, fn: Callable) -> Callable:
        raise NotImplementedError

    def wrap_sync(self, fn: Callable) -> Callable:
        raise NotImplementedError

    @staticmethod
    def _key(name: str, args, kwargs) -> str:
        payload = pickle.dumps((name, args, tuple(sorted(kwargs.items()))),
                               protocol=4)
        return hashlib.blake2b(payload, digest_size=16).hexdigest()


class InMemoryCache(CacheStrategy):
    """Unbounded in-memory memoization (reference: async-lru based)."""

    def __init__(self, max_size: int | None = None):
        self.max_size = max_size
        self._store: dict[str, Any] = {}

    def wrap_sync(self, fn):
        name = getattr(fn, "__name__", "fn")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            if key in self._store:
                return self._store[key]
            result = fn(*args, **kwargs)
            self._put(key, result)
            return result

        return wrapper

    def wrap_async(self, fn):
        name = getattr(fn, "__name__", "fn")

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            if key in self._store:
                return self._store[key]
            result = await fn(*args, **kwargs)
            self._put(key, result)
            return result

        return wrapper

    def _put(self, key, value):
        if self.max_size is not None and len(self._store) >= self.max_size:
            self._store.pop(next(iter(self._store)))
        self._store[key] = value


class DiskCache(CacheStrategy):
    """Pickle-file cache under PATHWAY_PERSISTENT_STORAGE or ./Cache
    (reference: diskcache-based UDF cache wired into persistence)."""

    def __init__(self, name: str | None = None):
        self.name = name
        self._dir: str | None = None

    def _ensure_dir(self) -> str:
        if self._dir is None:
            base = os.environ.get("PATHWAY_PERSISTENT_STORAGE", "./Cache")
            self._dir = os.path.join(base, "udf_cache", self.name or "default")
            os.makedirs(self._dir, exist_ok=True)
        return self._dir

    def _path(self, key: str) -> str:
        return os.path.join(self._ensure_dir(), key + ".pkl")

    def _get(self, key):
        path = self._path(key)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return True, pickle.load(f)
        return False, None

    def _put(self, key, value):
        path = self._path(key)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(value, f)
        os.replace(path + ".tmp", path)

    def wrap_sync(self, fn):
        name = getattr(fn, "__name__", "fn")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            hit, val = self._get(key)
            if hit:
                return val
            result = fn(*args, **kwargs)
            self._put(key, result)
            return result

        return wrapper

    def wrap_async(self, fn):
        name = getattr(fn, "__name__", "fn")

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            key = self._key(name, args, kwargs)
            hit, val = self._get(key)
            if hit:
                return val
            result = await fn(*args, **kwargs)
            self._put(key, result)
            return result

        return wrapper


DefaultCache = DiskCache


# ---------------------------------------------------------------------------
# executors (reference: udfs/executors.py)
# ---------------------------------------------------------------------------

class Executor:
    kind = "auto"

    def __init__(self, *, capacity: int | None = None, timeout: float | None = None,
                 retry_strategy: AsyncRetryStrategy | None = None):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy


class AutoExecutor(Executor):
    kind = "auto"


class SyncExecutor(Executor):
    kind = "sync"


class AsyncExecutor(Executor):
    kind = "async"


class FullyAsyncExecutor(Executor):
    kind = "fully_async"

    def __init__(self, *, autocommit_duration_ms: int | None = 1500, **kw):
        super().__init__(**kw)
        self.autocommit_duration_ms = autocommit_duration_ms


def auto_executor(**kw) -> Executor:
    return AutoExecutor(**kw)


def sync_executor(**kw) -> Executor:
    return SyncExecutor(**kw)


def async_executor(*, capacity: int | None = None, timeout: float | None = None,
                   retry_strategy: AsyncRetryStrategy | None = None) -> Executor:
    return AsyncExecutor(capacity=capacity, timeout=timeout,
                         retry_strategy=retry_strategy)


def fully_async_executor(*, capacity: int | None = None,
                         timeout: float | None = None,
                         retry_strategy: AsyncRetryStrategy | None = None,
                         autocommit_duration_ms: int | None = 1500) -> Executor:
    return FullyAsyncExecutor(capacity=capacity, timeout=timeout,
                              retry_strategy=retry_strategy,
                              autocommit_duration_ms=autocommit_duration_ms)


def _wrap_async(fn, executor: Executor, cache_strategy: CacheStrategy | None):
    """Apply retry/timeout/capacity/cache layers to an async callable."""
    wrapped = fn
    if executor.retry_strategy is not None:
        strategy = executor.retry_strategy
        inner_r = wrapped

        @functools.wraps(fn)
        async def with_retry(*args, **kwargs):
            return await strategy.invoke(inner_r, *args, **kwargs)

        wrapped = with_retry
    if executor.timeout is not None:
        timeout = executor.timeout
        inner_t = wrapped

        @functools.wraps(fn)
        async def with_timeout(*args, **kwargs):
            return await asyncio.wait_for(inner_t(*args, **kwargs), timeout)

        wrapped = with_timeout
    if executor.capacity is not None:
        capacity = executor.capacity
        sem_holder: list = []
        inner_c = wrapped

        @functools.wraps(fn)
        async def with_capacity(*args, **kwargs):
            if not sem_holder:
                sem_holder.append(asyncio.Semaphore(capacity))
            async with sem_holder[0]:
                return await inner_c(*args, **kwargs)

        wrapped = with_capacity
    if cache_strategy is not None:
        wrapped = cache_strategy.wrap_async(wrapped)
    return wrapped


class UDF:
    """User-defined function usable in expressions: ``my_udf(t.a, t.b)``.

    Subclass and define ``__wrapped__``, or produce via the ``@pw.udf``
    decorator (reference: udfs/__init__.py:68).
    """

    def __init__(self, *, return_type: Any = None, deterministic: bool = False,
                 propagate_none: bool = False, executor: Executor | None = None,
                 cache_strategy: CacheStrategy | None = None,
                 max_batch_size: int | None = None, batch: bool = False,
                 device: bool = False):
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor or AutoExecutor()
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        # batch=True → __wrapped__ receives whole columns (lists) and
        # returns a list (columnar device/vectorized dispatch; sync only)
        self.batch = batch
        # device=True → the batch dispatch is accelerator work; the
        # hosting operator is marked device_bound (it runs in the tick's
        # device leg, on the device bridge's worker when the window is 2
        # or more). Kept as ``device_bound``, not as the
        # JAX package's ``device``: a port embedder's ``device`` is the
        # torch device it runs on.
        self.device_bound = device
        self._prepared: Callable | None = None

    # subclasses override
    def __wrapped__(self, *args, **kwargs):
        raise NotImplementedError

    @property
    def func(self) -> Callable:
        return type(self).__wrapped__.__get__(self)  # bound

    def _infer_return_type(self, fn) -> Any:
        if self.return_type is not None:
            return self.return_type
        try:
            import typing

            hints = typing.get_type_hints(fn)
        except Exception:
            return dt.ANY
        ret = hints.get("return")
        return ret if ret is not None else dt.ANY

    def _prepare(self):
        if self._prepared is not None:
            return self._prepared, self._is_async
        if self.cache_strategy is None:
            self.cache_strategy = get_default_cache()
        fn = self.func
        is_coro = inspect.iscoroutinefunction(fn) or inspect.iscoroutinefunction(
            getattr(fn, "__wrapped__", None))
        kind = self.executor.kind
        if kind == "auto":
            kind = "async" if is_coro else "sync"
        if kind in ("async", "fully_async"):
            if not is_coro:
                base = fn

                async def as_async(*args, **kwargs):
                    return base(*args, **kwargs)

                fn = as_async
            fn = _wrap_async(fn, self.executor, self.cache_strategy)
            self._is_async = True
        else:
            if is_coro:
                raise TypeError("sync executor cannot run a coroutine function")
            if self.cache_strategy is not None:
                fn = self.cache_strategy.wrap_sync(fn)
            self._is_async = False
        self._prepared = fn
        return fn, self._is_async

    def __call__(self, *args, **kwargs) -> ex.ColumnExpression:
        fn, is_async = self._prepare()
        ret = self._infer_return_type(self.func)
        cls: type = ex.ApplyExpression
        if isinstance(self.executor, FullyAsyncExecutor):
            cls = ex.FullyAsyncApplyExpression
        elif is_async:
            cls = ex.AsyncApplyExpression
        if self.batch and cls is not ex.ApplyExpression:
            raise TypeError("batch=True UDFs must be sync")
        return cls(
            fn, ret, *args,
            propagate_none=self.propagate_none,
            deterministic=self.deterministic,
            max_batch_size=self.max_batch_size,
            batch=self.batch,
            device=self.device_bound,
            **kwargs,
        )


class _FunctionUDF(UDF):
    def __init__(self, fn: Callable, **kwargs):
        super().__init__(**kwargs)
        self._fn = fn
        functools.update_wrapper(self, fn)

    @property
    def func(self) -> Callable:
        return self._fn


def udf(fun: Callable | None = None, /, *, return_type: Any = None,
        deterministic: bool = False, propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None, batch: bool = False,
        device: bool = False):
    """Decorator turning a Python function into a column UDF."""

    def wrapper(f):
        return _FunctionUDF(
            f, return_type=return_type, deterministic=deterministic,
            propagate_none=propagate_none, executor=executor,
            cache_strategy=cache_strategy, max_batch_size=max_batch_size,
            batch=batch, device=device,
        )

    if fun is not None:
        return wrapper(fun)
    return wrapper
