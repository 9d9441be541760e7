"""Dataflow-native semantic result cache with incremental delta
invalidation — port of pathway_tpu/engine/result_cache.py (pure Python and
numpy, copied; no JAX).

Query traffic repeats, and the engine knows something no bolt-on cache
does: exactly which rows changed each tick. This module caches
``query_as_of_now`` top-k replies keyed by a query fingerprint, and instead
of TTLs it invalidates **incrementally** from the same per-tick deltas that
maintain the index:

- a cached entry records the **page set its candidate scan touched** (the
  paged store's established-extent coverage, or every page of the
  contiguous slab — ops/knn.py reports it per search) plus its **k-th
  score**;
- an insert landing in a page the entry covered invalidates it only if the
  new row's distance **could beat the entry's k-th score** (conservative
  float margin — over-invalidation is just a miss, never a stale serve);
  an insert landing in a page the entry did NOT cover (an extent
  established after the fill) always invalidates — the scan never saw it;
- a **deletion invalidates by page membership alone**: if the deleted row
  lived in a covered page the entry dies; if it lived in an uncovered page
  the entry survives — sound, because the entry being alive means no
  post-fill insert beat its k-th score, so such a row cannot appear in it;
- an **update of a key already in the reply** invalidates regardless of
  score (the row it returned changed under it).

The beat test runs on the host in float32 and is only enabled for float32
indexes, whose card scores are full-fp32 products (``_device.
resolve_device`` turns TF32 off); int8/bfloat16 storage quantizes on the
device, so the kernel's score can diverge from the host distance by more
than rounding — those indexes (and device-resident adds, whose vectors
never visit the host) fall back to invalidate-on-any-insert, which given
the uncovered-page rule is ``invalidate_all``. Filtered queries and
revise-mode standing queries are never cached. Fingerprints and the beat
test read host arrays only: the cache never waits for the card.

Layering: ops/knn.py feeds the invalidator from add/remove,
engine/index_ops.py does lookup/fill and same-answer dedupe inside the
device leg, engine/streaming.py ticks the per-commit invalidation
accounting. Not ported: the router's fleet cache (``RouterResultCache``,
ROADMAP queue 1, step 7e), the QoS coalescing counters (step 7b) and the
``/metrics`` export of these statistics (step 7d).

Knobs: ``PATHWAY_RESULT_CACHE`` (default on; 0 disables),
``PATHWAY_RESULT_CACHE_ENTRIES`` (per-index LRU bound, default 1024).
"""

from __future__ import annotations

import hashlib
import os
import weakref
from collections import OrderedDict
from typing import Any, Iterable

import numpy as np

from pathway_tpu_torch.engine.locking import create_lock


def result_cache_enabled(override: bool | None = None) -> bool:
    if override is not None:
        return bool(override)
    return os.environ.get("PATHWAY_RESULT_CACHE", "1").lower() not in (
        "0", "false", "off", "no")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def fingerprint(vec: Any, limit: int) -> bytes:
    """Query fingerprint: blake2b over the canonical float32 vector bytes
    and the requested k. Metric/dtype are fixed per cache instance, so
    they need not be part of the key."""
    v = np.asarray(vec, dtype=np.float32).reshape(-1)
    h = hashlib.blake2b(digest_size=16)
    h.update(v.tobytes())
    h.update(int(limit).to_bytes(8, "little", signed=True))
    return h.digest()


class _Entry:
    __slots__ = ("reply", "pages", "kth", "qvec", "keys")

    def __init__(self, reply: tuple, pages: frozenset, kth: float | None,
                 qvec: np.ndarray | None):
        self.reply = reply
        self.pages = pages          # coverage at fill time (page ids)
        self.kth = kth              # None → shorter than k: always beatable
        self.qvec = qvec            # None → beat test unavailable
        self.keys = frozenset(k for k, _ in reply)


class ResultCache:
    """Per-index semantic result cache (owned by a KNN index instance).

    All public methods are safe to call from several threads at once; the
    mutation hooks are invoked by ops/knn.py while it holds the index
    lock, which is fine — this lock is always innermost."""

    def __init__(self, page_rows: int, *, metric: Any = None,
                 beat_test: bool = True, max_entries: int | None = None):
        self.page_rows = int(page_rows)
        self.metric = str(getattr(metric, "value", metric or "l2sq")).lower()
        self.beat_test = bool(beat_test)
        self.max_entries = (max_entries if max_entries is not None
                            else _env_int("PATHWAY_RESULT_CACHE_ENTRIES",
                                          1024))
        self._lock = create_lock("result_cache.entries")
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._page_index: dict[int, set[bytes]] = {}
        # monotonic index-version watermark: bumps once per commit tick
        # that changed the data (the router's fleet-hit validity token)
        self.version = 0
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.invalidations = 0
        self.evictions = 0
        self.ticks = 0
        self._tick_invalidations = 0
        self.last_tick_invalidations = 0
        register_cache(self)

    # -- read path ---------------------------------------------------------
    def lookup(self, fp: bytes) -> tuple | None:
        """Cached reply for ``fp`` or None (a miss). Hit moves the entry
        to the LRU head."""
        with self._lock:
            ent = self._entries.get(fp)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(fp)
            self.hits += 1
            return ent.reply

    def fill(self, fp: bytes, reply: tuple, pages: Iterable[int] | None,
             kth: float | None, qvec: Any = None) -> None:
        if pages is None:
            return  # index did not report coverage — cannot invalidate
        with self._lock:
            self._drop_locked(fp)
            if qvec is not None and self.beat_test:
                qvec = np.asarray(qvec, dtype=np.float32).reshape(-1)
            else:
                qvec = None
            ent = _Entry(tuple(reply), frozenset(pages), kth, qvec)
            self._entries[fp] = ent
            for p in ent.pages:
                self._page_index.setdefault(p, set()).add(fp)
            self.fills += 1
            while len(self._entries) > self.max_entries:
                old_fp, _ = next(iter(self._entries.items()))
                self._drop_locked(old_fp)
                self.evictions += 1

    # -- invalidation ------------------------------------------------------
    def _drop_locked(self, fp: bytes, *, count: bool = False) -> None:
        ent = self._entries.pop(fp, None)
        if ent is None:
            return
        for p in ent.pages:
            s = self._page_index.get(p)
            if s is not None:
                s.discard(fp)
                if not s:
                    del self._page_index[p]
        if count:
            self.invalidations += 1
            self._tick_invalidations += 1

    def _dist(self, qvec: np.ndarray, vecs: np.ndarray) -> np.ndarray:
        """Host-side distances matching ops/knn.py's reported convention
        (L2sq distance, or cosine distance 1-cos)."""
        if "cos" in self.metric:
            qn = qvec / (np.linalg.norm(qvec) + 1e-12)
            vn = vecs / (np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-12)
            return 1.0 - vn @ qn
        d = vecs - qvec[None, :]
        return np.einsum("ij,ij->i", d, d)

    @staticmethod
    def _margin(kth: float) -> float:
        # conservative float32 slack between the host distance and the
        # kernel's score arithmetic; over-invalidation is only a miss
        return max(1e-6, 1e-3 * (abs(kth) + 1.0))

    def on_insert_batch(self, slots: Any, keys: Iterable[Any],
                        vecs: Any = None) -> None:
        """A batch of rows was written host-side. ``slots`` are global slot
        ids; ``vecs`` the float32-coercible row matrix (None → no beat
        test, treat every covered insert as beating)."""
        if not self._entries:
            return
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        batch_pages = frozenset(
            int(p) for p in np.unique(slots // self.page_rows))
        key_set = frozenset(keys)
        if vecs is not None and self.beat_test:
            vecs = np.asarray(vecs, dtype=np.float32).reshape(len(slots), -1)
        else:
            vecs = None
        with self._lock:
            doomed = []
            for fp, ent in self._entries.items():
                if not batch_pages <= ent.pages:
                    # a page the entry's scan never saw took a row
                    doomed.append(fp)
                    continue
                if ent.keys & key_set:
                    doomed.append(fp)  # a returned row was overwritten
                    continue
                if ent.kth is None or ent.qvec is None or vecs is None:
                    doomed.append(fp)  # short reply / no beat test
                    continue
                dists = self._dist(ent.qvec, vecs)
                if float(dists.min()) <= ent.kth + self._margin(ent.kth):
                    doomed.append(fp)
            for fp in doomed:
                self._drop_locked(fp, count=True)

    def on_insert(self, slot: int, key: Any, vec: Any = None) -> None:
        if not self._entries:
            return
        self.on_insert_batch(np.asarray([slot]), (key,),
                             None if vec is None else
                             np.asarray(vec, dtype=np.float32).reshape(1, -1))

    def on_delete(self, slot: int, key: Any = None) -> None:
        """A row was removed: membership-only invalidation (entries whose
        coverage holds the page die; uncovered entries provably cannot
        contain the row — see module docstring)."""
        if not self._entries:
            return
        page = int(slot) // self.page_rows
        with self._lock:
            for fp in list(self._page_index.get(page, ())):
                self._drop_locked(fp, count=True)

    def invalidate_all(self) -> None:
        """Device-resident writes (add_batch_device / fused ingest) and
        other unattributable mutations: drop everything."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._page_index.clear()
            self.invalidations += n
            self._tick_invalidations += n

    # -- versioning / tick accounting -------------------------------------
    def note_data_tick(self) -> None:
        """The primary applied a data delta this commit tick — bump the
        index-version watermark (router fleet hits key on it)."""
        with self._lock:
            self.version += 1

    def note_commit_tick(self) -> None:
        """Per-commit accounting hook (engine/streaming.py): closes the
        invalidations/tick window."""
        with self._lock:
            self.ticks += 1
            self.last_tick_invalidations = self._tick_invalidations
            self._tick_invalidations = 0

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "hit_ratio": (self.hits / lookups) if lookups else 0.0,
                "version": self.version,
                "ticks": self.ticks,
                "last_tick_invalidations": self.last_tick_invalidations,
                "invalidations_per_tick": (
                    self.invalidations / self.ticks if self.ticks else 0.0),
            }


def maybe_result_cache(index: Any) -> "ResultCache | None":
    """Cache instance for a KNN index (or None when disabled). Geometry
    comes from the index's page allocator when paged, or the configured
    page size for the contiguous slab (``slot // page_rows`` is then a
    synthetic-but-consistent page id over the slab's address space)."""
    if not result_cache_enabled():
        return None
    pool = getattr(index, "_pool", None)
    if pool is not None:
        pr = pool.allocator.page_rows
    else:
        from pathway_tpu_torch.engine.paged_store import page_rows

        pr = page_rows()
    return ResultCache(
        pr, metric=getattr(index, "metric", None),
        beat_test=(getattr(index, "dtype", "float32") == "float32"))


# -- process-wide registry (mirrors paged_store's pool registry) ----------

_LIVE_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def register_cache(cache: Any) -> None:
    _LIVE_CACHES.add(cache)


def note_commit_ticks() -> None:
    """Per-commit hook for the streaming runtime: advance every live
    cache's invalidations/tick window."""
    for c in list(_LIVE_CACHES):
        c.note_commit_tick()


def live_cache_stats() -> dict | None:
    """Aggregate over every live result cache in the process (None when
    no cache exists)."""
    stats = [c.stats() for c in list(_LIVE_CACHES)]
    if not stats:
        return None
    out = {"caches": len(stats), "entries": 0, "hits": 0, "misses": 0,
           "fills": 0, "invalidations": 0, "evictions": 0, "version": 0,
           "ticks": 0, "last_tick_invalidations": 0}
    for st in stats:
        for k in ("entries", "hits", "misses", "fills", "invalidations",
                  "evictions", "ticks", "last_tick_invalidations"):
            out[k] += st[k]
        # the watermark is the max: any index mutation must flip it
        out["version"] = max(out["version"], st["version"])
    lookups = out["hits"] + out["misses"]
    out["hit_ratio"] = (out["hits"] / lookups) if lookups else 0.0
    out["invalidations_per_tick"] = (
        out["invalidations"] / out["ticks"] if out["ticks"] else 0.0)
    return out
