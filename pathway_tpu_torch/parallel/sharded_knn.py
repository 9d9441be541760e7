"""Mesh-sharded brute-force KNN — port of pathway_tpu/parallel/sharded_knn.py
(reference: BruteForceKNNIndex,
src/external_integration/brute_force_knn_integration.rs:22,187-229).

The vector slab is one logical space of ``n_shards * cap_per_shard`` slots
split over the mesh's data axis: each shard keeps its rows in tensors of
its own, on its own device (a device may hold several shards). A search
scores the queries against every shard with the port's kernels
(``ops/knn.py::search_extent``: K2 for a bf16 shard, K3 top-k for an int8
one, each at k <= ``K_MAX``; past it, the score kernels and the key
selection; a float32 shard through ``score_float_reference``), takes each
shard's top-k, and merges the candidates on the first shard's device — the
only traffic between devices is ``n_shards x B x k`` scores and slots, never
the slab. This is BASELINE.md config 5's index (multi-worker KNN over a
stream).

Held to the JAX package:

- the host bookkeeping is the JAX class's, slot for slot: the emptiest
  shard takes each new key, the per-shard LIFO free lists (contiguous
  slab), ``_grow``'s shard-local remap, the paged extents' growth without
  remap, ``page_stats``; the host mirror is exact float32;
- int8 rows are quantized on the host by ``_quantize_i8_np`` (a true
  divide by 127), never by K4, whose scales can differ from it by one ulp
  (ROADMAP queue 3, item 4);
- candidates merge as the JAX kernel merges them: a shard's extents first,
  then the shards, laid out shard-major per query, with equal scores in
  that layout's order (a stable descending sort, ``lax.top_k``'s).

One departure (ROADMAP queue 3, item 16): the JAX package scores a bf16
shard in float32, normalising rows and queries first (``_local_scores``);
the port scores it with K2, whose queries are cast to bf16 and whose rows
are scaled by ``rsqrt(||v||^2)`` — the unsharded port index's arithmetic,
so a sharded and an unsharded bf16 index rank alike.

``tenant`` / ``tenant_quotas`` tag and cap the paged index's pages in its
one allocator (``PageQuotaExceeded`` past the cap), as in the JAX package;
the contiguous sharded slab has no allocator and warns that it ignores a
quota.
"""

from __future__ import annotations

import logging
import math
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch._device import ReplicaShared, upload
from pathway_tpu_torch.engine import device_sanitizer
from pathway_tpu_torch.engine.locking import create_rlock
from pathway_tpu_torch.engine.paged_store import (PageAllocator,
                                                  PageQuotaExceeded,
                                                  paged_store_enabled,
                                                  quota_pages)
from pathway_tpu_torch.engine.paged_store import page_rows as _page_rows
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops.knn import (_CHUNK_ROWS, KnnMetric, _round_up,
                                       _topk_gather, passes_filter,
                                       search_extent)
from pathway_tpu_torch.parallel.mesh import DATA_AXIS, all_gather, get_mesh


def _quantize_i8_np(vals: np.ndarray):
    """Per-row symmetric int8 quantization on the host — a copy of the JAX
    package's ``ops/knn.py::_quantize_i8_np``, term by term: scale = max|v|
    / 127 (a true divide), codes round(v / scale) clipped to +-127, and the
    int-domain squared norm accumulated in int64."""
    v = vals.astype(np.float32)
    m = np.max(np.abs(v), axis=1)
    scale = np.maximum(m / 127.0, 1e-30).astype(np.float32)
    q = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
    qi = q.astype(np.int64)
    vsq = np.sum(qi * qi, axis=1).astype(np.float32)
    return q, scale, vsq


def slab_cap_per_shard(n_shards: int, reserved_space: int,
                       page_rows: int | None = None) -> int:
    """Per-shard slab capacity for a reservation of ``reserved_space`` rows:
    128-row aligned, and a whole number of pages under the paged store."""
    per = max(reserved_space // n_shards + 1, 1)
    per = max(128, _round_up(per, 128))
    if page_rows:
        per = _round_up(per, page_rows)
    return per


def pages_per_shard(n_shards: int, reserved_space: int,
                    page_rows: int) -> int:
    """What a reservation costs in pages per shard."""
    return slab_cap_per_shard(n_shards, reserved_space,
                              page_rows) // page_rows


def search_operand_layout(dtype: str) -> tuple[tuple[tuple, int], ...]:
    """``((sharded_axes, rank), ...)`` per search operand, in call order:
    queries, vectors, valid (+ scales, vsq for int8). ``sharded_axes``
    names the mesh axis of each leading dim (empty = replicated): the
    queries go whole to every shard, the slab and its side columns are
    split over the data axis."""
    base = (
        ((), 2),            # queries (B, D): replicated
        ((DATA_AXIS,), 3),  # vectors (S, C, D): slab dim over the data axis
        ((DATA_AXIS,), 2),  # valid (S, C)
    )
    if dtype == "int8":
        base = base + (
            ((DATA_AXIS,), 2),  # scales (S, C)
            ((DATA_AXIS,), 2),  # vsq (S, C)
        )
    return base


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


class _ShardExtent:
    """One sharded allocation: ``cap_per_shard`` rows per shard. Global
    slots [base + s*cap, base + (s+1)*cap) belong to shard s, whose rows
    live in ``vectors[s]`` / ``valid[s]`` (+ ``scales[s]`` / ``vsq[s]`` for
    int8) on that shard's device."""

    __slots__ = ("base", "cap_per_shard", "vectors", "valid", "scales",
                 "vsq")

    def __init__(self, base: int, cap_per_shard: int):
        self.base = base
        self.cap_per_shard = cap_per_shard
        self.vectors = None
        self.valid = None
        self.scales = None
        self.vsq = None

    @property
    def established(self) -> bool:
        return self.vectors is not None


class ShardedKnnIndex(ReplicaShared):
    """Exact KNN over a mesh-sharded vector slab.

    Slots form one logical space of size ``n_shards * cap_per_shard``;
    slot ``s`` lives on shard ``s // cap_per_shard``. Adds are balanced by
    allocating from the emptiest shard. ``ShardedKnnIndex(...)`` constructs
    :class:`PagedShardedKnnIndex` unless ``paged=False`` /
    ``PATHWAY_PAGED_STORE=0`` (this class: one contiguous slab a shard).
    """

    device_bound = True  # run in the tick's device leg (engine/graph.py)

    def __new__(cls, *args, **kwargs):
        if cls is ShardedKnnIndex and paged_store_enabled(kwargs.get("paged")):
            cls = PagedShardedKnnIndex
        return object.__new__(cls)

    def __init__(self, dimensions: int, *, mesh=None,
                 reserved_space: int = 0,
                 metric: KnnMetric | str = KnnMetric.L2SQ,
                 dtype: str = "float32", paged: bool | None = None,
                 page_rows: int | None = None, tenant: Any = None,
                 tenant_quotas: dict[Any, int] | None = None):
        if isinstance(metric, str):
            metric = KnnMetric(metric)
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported sharded knn dtype {dtype!r} "
                             "(use 'float32', 'bfloat16' or 'int8')")
        self.dim = int(dimensions)
        self.metric = metric
        self.dtype = dtype
        self._mesh = mesh if mesh is not None else get_mesh()
        self.n_shards = int(self._mesh.shape[DATA_AXIS])
        self._devices = self._mesh.shard_devices()
        self._lock = create_rlock("ShardedKnnIndex._lock")
        self._key_to_slot: dict[Pointer, int] = {}
        self._slot_to_key: dict[int, Pointer] = {}
        self._filter_data: dict[Pointer, Any] = {}
        self._dirty: set[int] = set()
        self._init_storage(reserved_space, page_rows=page_rows,
                           tenant=tenant, tenant_quotas=tenant_quotas)

    def _init_storage(self, reserved_space: int, *,
                      page_rows: int | None = None, tenant: Any = None,
                      tenant_quotas: dict[Any, int] | None = None) -> None:
        if tenant_quotas:
            # quota accounting lives in the page allocator; the contiguous
            # slab has none. Loud, not silent: a quota nothing enforces is
            # a configuration bug
            logging.getLogger("pathway_tpu_torch.paged_store").warning(
                "tenant_quotas are only enforced by the paged store — "
                "the contiguous sharded slab (PATHWAY_PAGED_STORE=0) "
                "ignores them")
        self.cap_per_shard = slab_cap_per_shard(self.n_shards,
                                                reserved_space)
        cap = self.total_capacity
        self._host_vectors = np.zeros((cap, self.dim), dtype=np.float32)
        self._host_valid = np.zeros((cap,), dtype=bool)
        # per-shard LIFO free lists
        self._free: list[list[int]] = [
            list(range((s + 1) * self.cap_per_shard - 1,
                       s * self.cap_per_shard - 1, -1))
            for s in range(self.n_shards)
        ]
        self._extents = [_ShardExtent(0, self.cap_per_shard)]

    @property
    def total_capacity(self) -> int:
        return self.n_shards * self.cap_per_shard

    def __len__(self) -> int:
        return len(self._key_to_slot)

    # -- storage hooks (the paged subclass swaps these) -----------------
    def _ensure_free(self, n: int) -> None:
        while sum(len(f) for f in self._free) < n:
            self._grow()

    def _release_slot(self, slot: int) -> None:
        self._free[slot // self.cap_per_shard].append(slot)

    # ------------------------------------------------------------------
    def _alloc_slot(self, key: Pointer) -> int:
        """Slot for ``key``, allocating from the emptiest shard (growing if
        every shard is full). Lock held."""
        slot = self._key_to_slot.get(key)
        if slot is None:
            shard = max(range(self.n_shards),
                        key=lambda s: len(self._free[s]))
            if not self._free[shard]:
                self._grow()
                shard = max(range(self.n_shards),
                            key=lambda s: len(self._free[s]))
            slot = self._free[shard].pop()
            self._key_to_slot[key] = slot
            self._slot_to_key[slot] = key
        return slot

    def _alloc_slots(self, keys: list[Pointer]) -> np.ndarray:
        """Slot per key, new keys allocated one by one (``_alloc_slot``)
        after capacity for all of them is ensured. Lock held."""
        n_new = len({k for k in keys if k not in self._key_to_slot})
        self._ensure_free(n_new)
        return np.fromiter(map(self._alloc_slot, keys), np.int64, len(keys))

    def add(self, key: Pointer, vector: Any,
            filter_data: Any | None = None) -> None:
        with self._lock:
            vec = np.asarray(vector, dtype=np.float32).reshape(-1)
            if vec.shape[0] != self.dim:
                raise ValueError(
                    f"vector dim {vec.shape[0]} != index dim {self.dim}")
            slot = self._alloc_slot(key)
            self._host_vectors[slot] = vec
            self._host_valid[slot] = True
            if filter_data is not None:
                self._filter_data[key] = filter_data
            self._dirty.add(slot)

    def add_batch(self, keys: list[Pointer], vectors,
                  filter_data: list[Any] | None = None) -> None:
        """Vectorized add; rows go to the emptiest shards. Capacity is
        ensured up front because the contiguous slab's ``_grow`` remaps
        slots: no grow may happen mid-allocation."""
        if len(keys) == 0:
            return
        vecs = np.asarray(vectors, dtype=np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"expected ({len(keys)}, {self.dim}) vectors, got "
                f"{vecs.shape}")
        if vecs.shape[0] != len(keys):
            raise ValueError(
                f"{len(keys)} keys but {vecs.shape[0]} vectors")
        if filter_data is not None and len(filter_data) != len(keys):
            raise ValueError(
                f"{len(keys)} keys but {len(filter_data)} filter_data entries")
        with self._lock:
            slots = self._alloc_slots(keys)
            if filter_data is not None:
                for key, data in zip(keys, filter_data):
                    if data is not None:
                        self._filter_data[key] = data
            self._host_vectors[slots] = vecs
            self._host_valid[slots] = True
            self._dirty.update(slots.tolist())

    def remove(self, key: Pointer) -> None:
        with self._lock:
            slot = self._key_to_slot.pop(key, None)
            if slot is None:
                return
            del self._slot_to_key[slot]
            self._filter_data.pop(key, None)
            self._host_valid[slot] = False
            self._release_slot(slot)
            self._dirty.add(slot)

    def _grow(self) -> None:
        """Double per-shard capacity; slot ids are remapped shard-locally
        and the device slab is uploaded again on the next flush."""
        old_per = self.cap_per_shard
        new_per = old_per * 2
        cap = self.n_shards * new_per
        new_vec = np.zeros((cap, self.dim), dtype=np.float32)
        new_valid = np.zeros((cap,), dtype=bool)
        remap: dict[int, int] = {}
        for s in range(self.n_shards):
            old_lo, new_lo = s * old_per, s * new_per
            new_vec[new_lo:new_lo + old_per] = \
                self._host_vectors[old_lo:old_lo + old_per]
            new_valid[new_lo:new_lo + old_per] = \
                self._host_valid[old_lo:old_lo + old_per]
            for i in range(old_per):
                remap[old_lo + i] = new_lo + i
        self._host_vectors = new_vec
        self._host_valid = new_valid
        self._key_to_slot = {k: remap[v] for k, v in self._key_to_slot.items()}
        self._slot_to_key = {remap[s]: k for s, k in self._slot_to_key.items()}
        self._free = [
            [remap[s] for s in shard_free] +
            list(range((i + 1) * new_per - 1, i * new_per + old_per - 1, -1))
            for i, shard_free in enumerate(self._free)
        ]
        self.cap_per_shard = new_per
        self._extents = [_ShardExtent(0, new_per)]
        self._dirty.clear()

    # -- device state ---------------------------------------------------
    def flush_device(self) -> None:
        """Push pending host-mirror changes to the shards now (the external
        index operator calls this after ingest-only ticks)."""
        with self._lock:
            self._flush_to_device()

    def _establish_extent(self, ext: _ShardExtent) -> None:
        """Zero tensors of one extent on every shard's device."""
        if ext.established:
            return
        C, D = ext.cap_per_shard, self.dim
        ext.vectors = [torch.zeros((C, D), dtype=_DTYPES[self.dtype],
                                   device=d) for d in self._devices]
        ext.valid = [torch.zeros((C,), dtype=torch.bool, device=d)
                     for d in self._devices]
        if self.dtype == "int8":
            ext.scales = [torch.zeros((C,), dtype=torch.float32, device=d)
                          for d in self._devices]
            ext.vsq = [torch.zeros((C,), dtype=torch.float32, device=d)
                       for d in self._devices]

    def _flush_to_device(self) -> None:
        ext = self._extents[0]
        if not ext.established:
            # first flush after creation or a grow: the whole mirror, as
            # the JAX package's device_put of the slab
            self._establish_extent(ext)
            self._dirty.clear()
            C = ext.cap_per_shard
            for s in range(self.n_shards):
                self._write_rows(ext, s, np.arange(C, dtype=np.int64),
                                 np.arange(s * C, (s + 1) * C,
                                           dtype=np.int64))
            return
        self._flush_dirty()

    def _flush_dirty(self) -> None:
        if not self._dirty:
            return
        idxs = np.fromiter(self._dirty, dtype=np.int64, count=len(self._dirty))
        self._dirty.clear()
        idxs.sort()
        for ext, local, pos in self._split_by_extent(idxs):
            C = ext.cap_per_shard
            sh = local // C
            for s in np.unique(sh):
                at = np.flatnonzero(sh == s)
                self._write_rows(ext, int(s), local[at] - s * C,
                                 idxs[pos[at]])

    def _split_by_extent(self, idxs: np.ndarray):
        for ext in self._extents:
            span = self.n_shards * ext.cap_per_shard
            in_ext = (idxs >= ext.base) & (idxs < ext.base + span)
            if not in_ext.any():
                continue
            pos = np.flatnonzero(in_ext)
            yield ext, idxs[pos] - ext.base, pos

    def _write_rows(self, ext: _ShardExtent, s: int, rows: np.ndarray,
                    slots: np.ndarray) -> None:
        """Write the mirror's rows at global ``slots`` (ascending) into
        shard ``s``'s rows ``rows`` of ``ext``, in chunks of at most
        ``_CHUNK_ROWS``: int8 quantized on the host (``_quantize_i8_np``),
        bf16 rounded on the device."""
        dev = self._devices[s]
        for c0 in range(0, len(rows), _CHUNK_ROWS):
            r, g = rows[c0:c0 + _CHUNK_ROWS], slots[c0:c0 + _CHUNK_ROWS]
            if g[-1] - g[0] == len(g) - 1:  # a run of slots: no gather
                vals = self._host_vectors[g[0]:g[-1] + 1]
                valid = self._host_valid[g[0]:g[-1] + 1]
            else:
                vals, valid = self._host_vectors[g], self._host_valid[g]
            loc = upload(torch.from_numpy(r), dev)
            if self.dtype == "int8":
                q, scale, vsq = _quantize_i8_np(vals)
                ext.vectors[s].index_copy_(
                    0, loc, upload(torch.from_numpy(q), dev))
                ext.scales[s].index_copy_(
                    0, loc, upload(torch.from_numpy(scale), dev))
                ext.vsq[s].index_copy_(
                    0, loc, upload(torch.from_numpy(vsq), dev))
            else:
                ext.vectors[s].index_copy_(0, loc, upload(
                    torch.from_numpy(vals), dev).to(_DTYPES[self.dtype]))
            ext.valid[s].index_copy_(
                0, loc, upload(torch.from_numpy(valid.copy()), dev))

    # -- search ---------------------------------------------------------
    def _device_topk(self, qmat: np.ndarray, fetch_k: int):
        """(scores, global slots) host arrays, best first. Each shard
        searches its extents (``search_extent``) and merges them; the
        shards' candidates meet on the first shard's device, laid out
        shard-major per query, and the best ``fetch_k`` of them are kept
        in that layout's order on equal scores. Lock held, device state
        flushed."""
        q_host = torch.from_numpy(qmat)
        q_on: dict[torch.device, torch.Tensor] = {}
        cand_s, cand_i = [], []
        for s, dev in enumerate(self._devices):
            if dev not in q_on:
                q_on[dev] = upload(q_host, dev)
            parts_s, parts_i = [], []
            for ext in self._extents:
                C = ext.cap_per_shard
                extras = ((ext.scales[s], ext.vsq[s])
                          if self.dtype == "int8" else ())
                ts, ti = search_extent(q_on[dev], ext.vectors[s],
                                       ext.valid[s], min(fetch_k, C),
                                       self.metric, extras)
                parts_s.append(ts)
                parts_i.append(ti + (ext.base + s * C))
            if len(parts_s) == 1:
                ss, si = parts_s[0], parts_i[0]
            else:  # this shard's extents first, as the JAX kernel does
                ss, si = _topk_gather(torch.cat(parts_s, dim=1),
                                      torch.cat(parts_i, dim=1),
                                      min(fetch_k, sum(
                                          p.shape[1] for p in parts_s)))
            cand_s.append(ss)
            cand_i.append(si)
        merge = self._devices[0]
        cs = all_gather(cand_s, merge, axis=1, tiled=True)
        ci = all_gather(cand_i, merge, axis=1, tiled=True)
        ms, mi = _topk_gather(cs, ci, min(fetch_k, cs.shape[1]))
        with device_sanitizer.explicit_sync("search results"):
            return ms.cpu().numpy(), mi.cpu().numpy()

    def search(self, queries: list[tuple]) -> list[tuple]:
        """Batched search: [(qkey, vector, limit, filter)] -> per query a
        tuple of (match_key, distance) pairs, best first (L2sq distance,
        or cosine distance 1 - cos_sim)."""
        if not queries:
            return []
        with self._lock:
            if not self._key_to_slot:
                return [() for _ in queries]
            self._flush_to_device()

            max_k = max(int(q[2] or 3) for q in queries)
            has_filter = any(q[3] is not None for q in queries)
            fetch_k = max(1, min(self.cap_per_shard,
                                 max_k * 4 if has_filter else max_k))
            qmat = np.stack([np.asarray(q[1], dtype=np.float32).reshape(-1)
                             for q in queries])
            top_scores, top_idx = self._device_topk(qmat, fetch_k)

            out = []
            for qi, (qkey, qvec, limit, filt) in enumerate(queries):
                limit = int(limit or 3)
                matches = []
                qnorm_sq = None
                for rank in range(top_scores.shape[1]):
                    score = top_scores[qi, rank]
                    if not math.isfinite(score):
                        break
                    key = self._slot_to_key.get(int(top_idx[qi, rank]))
                    if key is None:
                        continue
                    if filt is not None and not self._passes_filter(key, filt):
                        continue
                    if self.metric == KnnMetric.COS:
                        dist = 1.0 - float(score)
                    else:
                        if qnorm_sq is None:
                            q = np.asarray(qvec, dtype=np.float32).reshape(-1)
                            qnorm_sq = float(q @ q)
                        dist = max(0.0, qnorm_sq - float(score))
                    matches.append((key, dist))
                    if len(matches) >= limit:
                        break
                out.append(tuple(matches))
            return out

    def _passes_filter(self, key: Pointer, filt: Any) -> bool:
        return passes_filter(self._filter_data, key, filt)

    def drain(self) -> None:
        """Block until every queued device write has finished."""
        with self._lock, device_sanitizer.explicit_sync("drain"):
            for ext in self._extents:
                if ext.established:
                    for v in ext.valid:
                        v[:1].cpu()


class PagedShardedKnnIndex(ShardedKnnIndex):
    """ShardedKnnIndex over per-shard page tables (the default).

    Each shard's slab is a whole number of pages, tracked by one
    PageAllocator whose regions are (extent, shard) blocks. Growth appends
    a sharded extent, with no slot remapping and no upload of the extents
    already written. A search scores every extent shard by shard, merges a
    shard's extents, and only then merges across shards."""

    def _init_storage(self, reserved_space: int, *,
                      page_rows: int | None = None, tenant: Any = None,
                      tenant_quotas: dict[Any, int] | None = None) -> None:
        self._page_rows = _page_rows(page_rows)
        self._tenant = tenant
        quota_p = ({t: quota_pages(rows, self._page_rows)
                    for t, rows in tenant_quotas.items()}
                   if tenant_quotas else None)
        self.cap_per_shard = 0  # grows as extents are added
        self._extents: list[_ShardExtent] = []
        self._allocator = PageAllocator(self._page_rows, quota_p)
        # per-shard free-row counters: the emptiest-shard choice runs per
        # key, and a full allocator scan there is O(S*E) work a row. They
        # are exact without quotas; with quotas the allocator's scan
        # decides (quota headroom is global, a raw counter could overstate
        # a shard's availability)
        self._shard_free_rows = [0] * self.n_shards
        self.grow_events = 0
        self._host_vectors = np.zeros((0, self.dim), dtype=np.float32)
        self._host_valid = np.zeros((0,), dtype=bool)
        self._free = None  # slot accounting lives in the page allocator
        self._add_extent(slab_cap_per_shard(
            self.n_shards, reserved_space, self._page_rows))

    # -- extents ---------------------------------------------------------
    def _add_extent(self, cap_per_shard: int) -> None:
        base = self.total_capacity
        ext = _ShardExtent(base, cap_per_shard)
        eidx = len(self._extents)
        self._extents.append(ext)
        for s in range(self.n_shards):
            self._allocator.add_region(
                (eidx, s), base + s * cap_per_shard,
                cap_per_shard // self._page_rows)
            self._shard_free_rows[s] += cap_per_shard
        self.cap_per_shard += cap_per_shard
        cap = self.total_capacity
        new_vec = np.zeros((cap, self.dim), dtype=np.float32)
        new_vec[:len(self._host_vectors)] = self._host_vectors
        self._host_vectors = new_vec
        new_valid = np.zeros((cap,), dtype=bool)
        new_valid[:len(self._host_valid)] = self._host_valid
        self._host_valid = new_valid

    def _grow(self) -> None:
        """Online growth: one more sharded extent (its per-shard size
        doubles the per-shard total so far); extents, slot ids and the
        dirty set are untouched."""
        self.grow_events += 1
        self._add_extent(_round_up(self.cap_per_shard, self._page_rows))

    def page_stats(self) -> dict:
        with self._lock:
            st = self._allocator.stats()
            st.update({
                "capacity_rows": self.total_capacity,
                "extents": len(self._extents),
                "grow_events": self.grow_events,
                "shards": self.n_shards,
            })
            return st

    # -- slot allocation through per-shard page regions ------------------
    def _shard_regions(self, shard: int) -> list:
        return [(e, shard) for e in range(len(self._extents))]

    def _shard_of(self, slot: int) -> int:
        for ext in self._extents:
            if slot < ext.base + self.n_shards * ext.cap_per_shard:
                return (slot - ext.base) // ext.cap_per_shard
        raise IndexError(slot)

    def _shard_free(self, shard: int) -> int:
        if self._allocator.tenant_quota_pages is None:
            return self._shard_free_rows[shard]
        return self._allocator.free_slots_available(
            self._tenant, regions=self._shard_regions(shard))

    def _ensure_free(self, n: int) -> None:
        capped = self._allocator.quota_capped_slots(self._tenant)
        if capped is not None and capped < n:
            # growth cannot help: the tenant's quota, not the pool, is
            # the limit (and an unguarded loop would grow forever)
            raise PageQuotaExceeded(
                f"tenant {self._tenant!r} needs {n} slots but its page "
                f"quota caps it at {capped} more")
        while self._allocator.free_slots_available(self._tenant) < n:
            self._grow()

    def _release_slot(self, slot: int) -> None:
        self._allocator.release_slot(slot)
        self._shard_free_rows[self._shard_of(slot)] += 1

    def _alloc_slot(self, key: Pointer) -> int:
        slot = self._key_to_slot.get(key)
        if slot is None:
            # balance by emptiest shard, exactly like the slab path
            shard = max(range(self.n_shards), key=self._shard_free)
            if self._shard_free(shard) == 0:
                self._ensure_free(1)
                shard = max(range(self.n_shards), key=self._shard_free)
            slot = self._allocator.take_slot(
                self._tenant, regions=self._shard_regions(shard))
            self._shard_free_rows[shard] -= 1
            self._key_to_slot[key] = slot
            self._slot_to_key[slot] = key
        return slot

    def _alloc_slots(self, keys: list[Pointer]) -> np.ndarray:
        """Slot per key, as ``_alloc_slot`` key by key gives them, in bulk:
        the k-th new key goes to the shard whose free count is largest then
        (lowest shard on ties), so the new keys' shards are the first of
        the (free count, shard) pairs each shard passes through, ordered
        by count descending and shard ascending; each shard's slots are
        its regions' ``take_slots``. Lock held."""
        if self._allocator.tenant_quota_pages is not None:
            # quotas: the allocator decides each key's shard, key by key
            return super()._alloc_slots(keys)
        k2s = self._key_to_slot
        new = list(dict.fromkeys(k for k in keys if k not in k2s))
        self._ensure_free(len(new))
        m, free = len(new), self._shard_free_rows
        if m:
            levels = [np.arange(free[s], max(free[s] - m, 0), -1)
                      for s in range(self.n_shards)]
            shard_of = np.concatenate([np.full(len(lv), s)
                                       for s, lv in enumerate(levels)])
            seq = shard_of[np.lexsort((shard_of,
                                       -np.concatenate(levels)))[:m]]
            fresh = np.empty(m, dtype=np.int64)
            for s in range(self.n_shards):
                at = np.flatnonzero(seq == s)
                if len(at):
                    fresh[at] = self._allocator.take_slots(
                        len(at), self._tenant,
                        regions=self._shard_regions(s))
                    free[s] -= len(at)
            fresh_list = fresh.tolist()
            k2s.update(zip(new, fresh_list))
            self._slot_to_key.update(zip(fresh_list, new))
        return np.fromiter(map(k2s.__getitem__, keys), np.int64, len(keys))

    # -- device sync per extent ------------------------------------------
    def _flush_to_device(self) -> None:
        for ext in self._extents:
            self._establish_extent(ext)
        self._flush_dirty()
