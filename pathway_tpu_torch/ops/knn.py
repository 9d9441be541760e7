"""Device-resident brute-force KNN index over the paged store — port of
pathway_tpu/ops/knn.py.

Vectors live in page-aligned device extents (engine/paged_store.py); a
host mirror, key maps and dirty/stale slot sets batch incremental adds
and removes into few device writes. A search scores every established
extent (a bf16 or int8 extent in one fused score + top-k kernel; a float32
extent, or a k past ``K_MAX``, by a score kernel or a matrix product and
an exact selection of unique (score, slot) keys, chunked above
``_CHUNK_ROWS`` rows) and merges the per-extent candidates
on the host by (score desc, slot asc), exactly as the JAX package does.
``latency_probe`` times the device half of a search alone, as the JAX
package's does (bench.py's ``knn_p50_ms`` family).

Numerics held to the JAX package:

- scores are float32 for every slab dtype: bf16 rows and bf16 queries
  multiply with f32 sums, where JAX asks the MXU for f32 outputs of bf16
  inputs. Queries are rounded to the slab dtype first, as JAX casts them.
  A bfloat16 slab is searched by K2 (score + top-k in one kernel for k <=
  64, its score twin beyond, ops/knn_kernels.py); a float32 slab's
  product stays ``torch.matmul``, as the JAX package leaves it to XLA;
- ``dtype="int8"`` keeps rows quantized per row (scale = max|v| / 127)
  with an int-domain squared norm ``vsq`` beside each, written by K4, the
  quantizing scatter, and searched by K3 (score + top-k in one kernel
  for k <= 64, its score alone beyond) against bf16 queries
  (ops/knn_kernels.py); the host mirror stays exact float32, as in the
  JAX package;
- top-k keeps equal scores lowest slot first (``lax.top_k``'s order, which
  the host merge relies on): ``torch.topk`` of unique 64-bit (score,
  slot) keys (``knn_kernels.score_keys``), or K2's and K3's keys, which
  rank the same way.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the contiguous slab (``paged=False``), string (jmespath) filters,
tenants/quotas. The semantic result cache and operator snapshots are
absent."""

from __future__ import annotations

import enum
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch._device import PinnedStaging, resolve_device
from pathway_tpu_torch.engine.locking import create_rlock
from pathway_tpu_torch.engine.paged_store import (DevicePagePool,
                                                  paged_store_enabled)
from pathway_tpu_torch.internals.keys import Pointer
from pathway_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from pathway_tpu_torch.ops.knn_kernels import (K_MAX, key_rows, key_scores,
                                               quantize_scatter, score_bf16,
                                               score_float_reference,
                                               score_i8, score_keys,
                                               topk_bf16, topk_i8)


class KnnMetric(enum.Enum):
    L2SQ = "l2sq"
    COS = "cos"


_MIN_CAPACITY = 1024
# extents larger than this are scanned in chunks of this many rows
_CHUNK_ROWS = 1 << 19
# the route past K_MAX selects from several chunks' keys in one torch.topk
# call, up to this many queries' chunks of keys at a time (B=64: one chunk,
# B=1: 64). torch.topk sorts the rows of a call with at most 10 of them
# and selects by radix from 11 on, which an H100 does faster (PERF.md).
_SELECT_ROWS = 64


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to pathway_tpu_torch yet (ROADMAP.md, "
        "PyTorch/CUDA port queue)")


def passes_filter(filter_data: dict, key: Pointer, filt: Any) -> bool:
    """The metadata-filter predicate: callable filters are fail-closed.
    String (jmespath) filters are not ported yet."""
    if not callable(filt):
        raise _not_ported("string (jmespath) metadata filters")
    try:
        return bool(filt(filter_data.get(key)))
    except Exception:
        return False


def planned_capacity(reserved_space: int) -> int:
    """Slab capacity the index will allocate for a reservation — minimum
    floor, 128-row rounding, chunk alignment."""
    cap = max(_MIN_CAPACITY, _round_up(max(reserved_space, 1), 128))
    if cap > _CHUNK_ROWS:
        cap = _round_up(cap, _CHUNK_ROWS)
    return cap


def _slab_dtype(dtype: str) -> torch.dtype:
    if dtype == "float32":
        return torch.float32
    if dtype == "bfloat16":
        return torch.bfloat16
    if dtype == "int8":
        return torch.int8
    raise ValueError(f"unsupported knn dtype {dtype!r} "
                     "(use 'float32', 'bfloat16' or 'int8')")



def _topk(scores: torch.Tensor, k: int):
    """Top-k of each row, best first, equal scores lowest column first:
    ``torch.topk`` of the rows' unique (score, column) keys
    (``score_keys``), so exactly the first k columns of a stable
    descending sort, score bits included."""
    cols = torch.topk(score_keys(scores), k, dim=1).indices
    return torch.gather(scores, 1, cols), cols


def search_chunks(keys: Callable, n: int, k: int, q: torch.Tensor):
    """Top-k of ``n`` rows for the queries ``q`` (B, D), scored chunk by
    chunk: ``keys(c0, c1, out)`` writes the ``score_keys`` of chunk [c0,
    c1) (columns from 0) into ``out``, a (B, c1 - c0) int64 view on q's
    device. The k best keys of each ``_CHUNK_ROWS`` chunk, their rows made
    global (a key less c0 is the key of row c0 + its column), then the k
    best of those (``_chunked_search``: top-k per chunk and a merge, in
    lowest-row-first tie order). Chunks of one width are selected in
    groups of up to ``_SELECT_ROWS // B`` by one ``torch.topk`` call over
    the group's chunks x B rows, which holds no more keys than one chunk of
    ``_SELECT_ROWS`` queries. Returns (B, k) scores and rows."""
    B = q.shape[0]
    group = max(1, _SELECT_ROWS // max(B, 1))
    cand, c0 = [], 0
    while c0 < n:
        width = min(_CHUNK_ROWS, n - c0)
        starts = [c for c in range(c0, c0 + group * width, width)
                  if c + width <= n]
        buf = torch.empty((len(starts) * B, width), dtype=torch.int64,
                          device=q.device)
        for j, c in enumerate(starts):
            keys(c, c + width, buf[j * B:(j + 1) * B])
        kc = min(k, width)
        top = torch.topk(buf, kc, dim=1).values.view(len(starts), B, kc)
        # starts c0, c0 + width, ...: made on the device (a host list would
        # be a copy that waits for the card)
        top = top - (c0 + width * torch.arange(
            len(starts), device=q.device))[:, None, None]
        cand.append(top.permute(1, 0, 2).reshape(B, len(starts) * kc))
        c0 = starts[-1] + width
    # one chunk's k best are the answer; several chunks' are merged
    top = cand[0] if n <= _CHUNK_ROWS else \
        torch.topk(torch.cat(cand, dim=1), k, dim=1).values
    return key_scores(top), key_rows(top)


def _topk_gather(cand_s, cand_i, k: int):
    """The ``k`` best candidates of each row by score, best first, equal
    scores in column order, with their ids gathered beside them."""
    top_s, pos = _topk(cand_s, k)
    return top_s, torch.gather(cand_i, 1, pos)


def search_extent(queries, vectors, valid, k: int, metric: KnnMetric,
                  extras: tuple = ()):
    """(scores, local slots) of the ``k`` best rows of one extent for each
    query: (B, k) f32 and int64 tensors on the extent's device, best
    first, equal scores lowest slot first. Queries are cast to bf16 for an
    int8 or bf16 extent (the JAX package's ``_prep_queries``). For k <=
    ``K_MAX`` a bf16 extent is searched by K2 (``topk_bf16``) and an int8
    extent, which passes ``extras = (scales, vsq)``, by K3 top-k, each over
    the whole extent in one call. Otherwise (a filter's escalated fetch,
    or a float32 extent) ``search_chunks`` selects from each chunk's keys:
    K3's score (``score_i8``) for int8 and K2's score twin
    (``score_bf16``) for bf16 write them themselves; a float32 extent's
    come from ``score_float_reference``."""
    q = queries
    if metric == KnnMetric.COS:
        q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
    if vectors.dtype == torch.int8:
        q = q.to(torch.bfloat16).contiguous()
        scales, vsq = extras
        if k <= K_MAX:
            return topk_i8(q, vectors, scales, vsq, valid, metric.value, k)

        def keys(c0, c1, out):
            score_i8(q, vectors[c0:c1], scales[c0:c1], vsq[c0:c1],
                     valid[c0:c1], metric.value, out)
    elif vectors.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).contiguous()
        if k <= K_MAX:
            return topk_bf16(q, vectors, valid, metric.value, k)

        def keys(c0, c1, out):
            score_bf16(q, vectors[c0:c1], valid[c0:c1], metric.value, out)
    else:
        q = q.float()

        def keys(c0, c1, out):
            out.copy_(score_keys(score_float_reference(
                q, vectors[c0:c1], valid[c0:c1], metric.value)))
    return search_chunks(keys, vectors.shape[0], k, q)


def _fused_step_fn(producer: Callable, dtype: str, device: torch.device):
    """The producer + scatter step of a fused ingest: the producer's rows
    are written straight into one extent's device tensors, in place (the
    port's form of JAX's donated ``.at[].set``), with nothing returned to
    the host. ``step(ext, slots, *args)`` takes the extent and its local
    slots as a host int64 array; a slot >= the extent's rows is the
    sentinel of a ragged padding row and is dropped (JAX's
    ``mode="drop"``). int8 quantizes and writes through K4, which drops
    sentinels itself, with the slots uploaded from pinned staging; the
    float slabs select the in-range rows and ``index_copy_`` them."""

    if dtype == "int8":
        staging = PinnedStaging(device)

        def step_i8(ext, slots, *args) -> None:
            out = producer(*args)
            (loc,) = staging.upload((slots,))
            quantize_scatter(out.float().contiguous(), loc, None,
                             ext.vectors, ext.scales, ext.vsq, ext.valid)

        return step_i8

    def step(ext, slots, *args) -> None:
        out = producer(*args)
        keep = slots < ext.rows
        if not keep.all():
            idx = np.flatnonzero(keep)
            out = out[torch.from_numpy(idx).to(out.device)]
            slots = slots[idx]
        loc = torch.from_numpy(slots).to(ext.vectors.device)
        ext.vectors.index_copy_(0, loc, out.to(ext.vectors.dtype))
        ext.valid.index_fill_(0, loc, True)

    return step


# pinned upload sets of a graphed ingest step, per chunk shape: enough for
# the ~13 chunks of a 512-document ragged batch to be queued while the host
# packs the next batch
_STAGING_DEPTH = 32


class GraphedIngestStep:
    """The int8 fused-ingest step of a staged producer as one CUDA graph per
    chunk shape and extent: the port's counterpart of the JAX package's
    ``step_i8``, one donated ``jax.jit`` dispatch per ragged chunk.

    ``forward(model, *arrays) -> (n, dim)`` is the producer's device half
    (``EncoderEmbedder.ragged_device_forward``), a function of device
    tensors only. ``step(ext, slots, model, *arrays)`` copies the host
    arrays and the extent's local slots (the sentinel ``ext.rows`` in
    padding rows) into fixed device tensors through ``PinnedStaging``,
    then runs the body, ``forward`` and K4 into the extent, as a replay of
    the graph captured for (the arrays' shapes, the model, the extent's rows
    and the addresses of its four tensors). The first chunk of a key
    captures it, PyTorch's way: one eager run on a side stream, then the
    capture, into one memory pool that all the step's graphs share (no
    graph's memory outlives its replay: its inputs are the staged tensors,
    its outputs the extent). A grown or re-established extent has other
    addresses, so it gets a graph of its own and no replay writes through
    a stale pointer. A capture or replay error raises: there is no eager
    fallback on the card. On the CPU the body runs eagerly (``eager``).

    Counts: each replay adds to every kernel's launch count
    (``cuda_build.LAUNCH_COUNTS``) and to each ``counters`` entry (an
    ``(object, attribute)`` pair the body raises, such as the embedder's
    ``dispatches``) what the capture counted; the warm-up and the capture
    themselves count nothing. ``captures`` and ``replays`` count graphs
    captured and replayed."""

    def __init__(self, forward: Callable, device: torch.device,
                 counters: tuple = ()):
        self.forward = forward
        self.counters = tuple(counters)
        self.staging = PinnedStaging(device, depth=_STAGING_DEPTH)
        self.graphs: dict[tuple, tuple] = {}
        self.captures = 0
        self.replays = 0
        self._pool = None

    def _stage(self, slots, arrays) -> tuple[torch.Tensor, ...]:
        return self.staging.upload((*arrays, slots))

    def _body(self, model, ext, dev) -> None:
        out = self.forward(model, *dev[:-1])
        quantize_scatter(out.float().contiguous(), dev[-1], None,
                         ext.vectors, ext.scales, ext.vsq, ext.valid)

    def eager(self, ext, slots, model, *arrays) -> None:
        """The step without a graph: upload, then the body, launched
        eagerly."""
        self._body(model, ext, self._stage(slots, arrays))

    def __call__(self, ext, slots, model, *arrays) -> None:
        dev = self._stage(slots, arrays)

        def body() -> None:
            self._body(model, ext, dev)

        if not self._graphed(dev):
            body()
            return
        key = (tuple(t.shape for t in dev), id(model), ext.rows,
               ext.vectors.data_ptr(), ext.scales.data_ptr(),
               ext.vsq.data_ptr(), ext.valid.data_ptr())
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(body, dev[0].device)
            self.captures += 1
        graph, adds = entry
        graph.replay()
        for obj, attr, n in adds:
            setattr(obj, attr, getattr(obj, attr) + n)
        self.replays += 1

    @staticmethod
    def _graphed(dev) -> bool:
        return dev[0].device.type == "cuda"

    def _counts(self) -> dict:
        pairs = [(c, "launches") for c in LAUNCH_COUNTS] + list(
            self.counters)
        return {(id(o), a): (o, a, getattr(o, a)) for o, a in pairs}

    def _capture(self, body: Callable, device: torch.device) -> tuple:
        """(graph, [(object, attribute, count per replay)]) of ``body``;
        every count is left as it was before the warm-up (a count created
        during the warm-up started from 0)."""
        before = self._counts()
        self._warm(body, device)
        mid = self._counts()
        graph = self._record(body)
        adds = []
        for key, (obj, attr, now) in self._counts().items():
            n = now - (mid[key][2] if key in mid else 0)
            if n:
                adds.append((obj, attr, n))
            setattr(obj, attr, before[key][2] if key in before else 0)
        return graph, adds

    @staticmethod
    def _warm(body: Callable, device: torch.device) -> None:
        """One eager run on a side stream: lazy set-up (cuBLAS handles,
        kernel libraries, the shared-memory opt-in) before the capture."""
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)

    def _record(self, body: Callable):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            body()
        return graph


class BruteForceKnnIndex:
    """Incremental exact KNN over device-resident vectors.

    add/remove mutate a host mirror and enqueue dirty slots; search
    flushes pending updates to the device, then scores and ranks on the
    device. ``BruteForceKnnIndex(...)`` constructs a
    :class:`PagedKnnIndex`, the paged store being the only storage ported.
    """

    # read by ExternalIndexOperator.device_bound, as in the JAX package
    device_bound = True

    def __new__(cls, *args, **kwargs):
        if cls is BruteForceKnnIndex:
            if not paged_store_enabled(kwargs.get("paged")):
                raise _not_ported("the contiguous slab (paged=False / "
                                  "PATHWAY_PAGED_STORE=0)")
            cls = PagedKnnIndex
        return object.__new__(cls)

    def __init__(self, dimensions: int, *, reserved_space: int = 0,
                 metric: KnnMetric | str = KnnMetric.L2SQ,
                 dtype: str = "float32",
                 device: str | torch.device = "cuda",
                 paged: bool | None = None, page_rows: int | None = None,
                 tenant: Any = None,
                 tenant_quotas: dict[Any, int] | None = None):
        if tenant is not None or tenant_quotas:
            raise _not_ported("tenants and page quotas")
        if isinstance(metric, str):
            metric = KnnMetric(metric)
        self.dim = int(dimensions)
        self.metric = metric
        self.dtype = dtype
        self._slab_dtype = _slab_dtype(dtype)
        self._is_int8 = dtype == "int8"
        # int8 quantizes on the device; its host mirror stays exact
        # float32 (authoritative for re-upload and exact host reads)
        self._mirror_dtype = torch.float32 if self._is_int8 \
            else self._slab_dtype
        self.device = resolve_device(device)
        self._lock = create_rlock("BruteForceKnnIndex._lock")
        self._key_to_slot: dict[Pointer, int] = {}
        self._slot_to_key: dict[int, Pointer] = {}
        self._filter_data: dict[Pointer, Any] = {}
        self._dirty: set[int] = set()    # host → device pending
        self._stale: set[int] = set()    # device → host pending
        self._init_storage(reserved_space, page_rows=page_rows)

    # ------------------------------------------------------------------
    # maintenance (called on data diffs)
    # ------------------------------------------------------------------
    def _alloc_slots(self, keys: list[Pointer]) -> np.ndarray:
        """Slot per key, allocating (and growing) for new keys. Lock held."""
        n_new = len({k for k in keys if k not in self._key_to_slot})
        self._ensure_free(n_new)
        return self._fused_take_slots(keys)

    def add(self, key: Pointer, vector: Any,
            filter_data: Any | None = None) -> None:
        self.add_batch([key], np.asarray(vector).reshape(1, -1),
                       None if filter_data is None else [filter_data])

    def set_filter_data(self, keys: list[Pointer],
                        filter_data: list[Any] | None) -> None:
        """Record per-key metadata-filter payloads (None entries skipped)."""
        if filter_data is None:
            return
        if len(filter_data) != len(keys):
            raise ValueError(
                f"{len(keys)} keys but {len(filter_data)} filter_data entries")
        with self._lock:
            fd = self._filter_data
            for key, data in zip(keys, filter_data):
                if data is not None:
                    fd[key] = data

    def add_batch(self, keys: list[Pointer], vectors,
                  filter_data: list[Any] | None = None) -> None:
        """Vectorized add: one device write for a whole batch of rows."""
        if len(keys) == 0:
            return
        vecs = np.asarray(vectors, dtype=np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"expected ({len(keys)}, {self.dim}) vectors, got {vecs.shape}")
        if vecs.shape[0] != len(keys):
            raise ValueError(
                f"{len(keys)} keys but {vecs.shape[0]} vectors")
        self.set_filter_data(keys, filter_data)
        with self._lock:
            slots = self._alloc_slots(keys)
            idx = torch.from_numpy(slots)
            # the mirror holds rows at the slab's precision (exact f32 for
            # int8), as the JAX package's host mirror does
            self._host_vectors[idx] = torch.from_numpy(vecs).to(
                self._mirror_dtype)
            self._host_valid[idx] = True
            slot_list = slots.tolist()
            self._dirty.update(slot_list)
            self._stale.difference_update(slot_list)  # host write wins

    def add_batch_device(self, keys: list[Pointer], vectors: torch.Tensor,
                         filter_data: list[Any] | None = None) -> None:
        """Device-to-device add: ``vectors`` is an (n, dim) tensor already
        on the index's device (e.g. fresh encoder output). The extents are
        updated in place and the host mirror is marked stale (synced only
        when a host-side read needs it)."""
        if len(keys) == 0:
            return
        if vectors.ndim != 2 or vectors.shape[1] != self.dim or \
                vectors.shape[0] != len(keys):
            raise ValueError(
                f"expected ({len(keys)}, {self.dim}) device vectors, got "
                f"{tuple(vectors.shape)}")
        if vectors.device != self.device:
            raise ValueError(f"vectors on {vectors.device}, index on "
                             f"{self.device}")
        self.set_filter_data(keys, filter_data)
        with self._lock:
            slots = self._alloc_slots(keys)
            self._flush_to_device()  # establish extents before writing
            self._scatter(slots, vectors,
                          torch.ones(len(keys), dtype=torch.bool,
                                     device=self.device))
            self._host_valid[torch.from_numpy(slots)] = True
            slot_list = slots.tolist()
            self._stale.update(slot_list)
            self._dirty.difference_update(slot_list)  # device write wins

    def make_fused_ingest(self, producer: Callable):
        """Fuse a producer (e.g. the encoder forward pass) with the
        extent write: the producer's output rows go straight into the
        device extent, never to the host.

        ``producer(*args) -> (n, dim)`` tensor on the index's device.
        Returns ``ingest(keys, *args, n_rows=None) -> bool``: False, with
        nothing done, when the batch cannot be placed in one extent (it
        updates rows spread over several) — the caller then takes the
        two-step ``add_batch_device`` path. ``n_rows`` is the producer's
        row count when it exceeds ``len(keys)`` (a ragged chunk pads its
        documents): the padding rows get sentinel slots and are dropped.
        New keys allocate pages in one extent, or a fresh extent."""
        return self._ingest_fn(_fused_step_fn(producer, self.dtype,
                                              self.device))

    def make_graphed_ingest(self, forward: Callable, counters: tuple = ()):
        """The int8 fused ingest of a staged producer, each chunk one
        replay of a CUDA graph (:class:`GraphedIngestStep`, whose object is
        the returned function's ``step``). ``forward(model, *device
        arrays)`` is the producer's device half; the returned ``ingest(keys,
        model, *host_arrays, n_rows=None) -> bool`` behaves as
        :meth:`make_fused_ingest`'s."""
        if not self._is_int8:
            raise ValueError("the graphed ingest step writes int8 extents")
        step = GraphedIngestStep(forward, self.device, counters)
        ingest = self._ingest_fn(step)
        ingest.step = step
        return ingest

    def _ingest_fn(self, step: Callable) -> Callable:
        def ingest(keys: list[Pointer], *args,
                   n_rows: int | None = None) -> bool:
            with self._lock:
                return self._fused_ingest(step, keys, args, n_rows)

        return ingest

    def _fused_take_slots(self, keys: list[Pointer],
                          take: Callable | None = None) -> np.ndarray:
        """Slot per key (existing or freshly taken). Lock held; capacity
        for the new keys has already been ensured."""
        slots = np.empty(len(keys), dtype=np.int64)
        k2s, s2k = self._key_to_slot, self._slot_to_key
        take = take or self._take_slot
        for i, key in enumerate(keys):
            slot = k2s.get(key)
            if slot is None:
                slot = take()
                k2s[key] = slot
                s2k[slot] = key
            slots[i] = slot
        return slots

    @staticmethod
    def _pad_slots(slots: np.ndarray, n_rows: int | None,
                   sentinel: int) -> np.ndarray:
        """Slots for a producer of ``n_rows`` rows: ragged chunks pad
        their documents, and the padding rows get ``sentinel`` (out of
        range: the fused step drops them)."""
        if n_rows is not None and n_rows > len(slots):
            slots = np.concatenate([
                slots, np.full(n_rows - len(slots), sentinel, np.int64)])
        return slots

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
            self._stale.discard(slot)

    def __len__(self) -> int:
        return len(self._key_to_slot)

    def flush_device(self) -> None:
        """Push pending host-mirror changes to the device now."""
        with self._lock:
            self._flush_to_device()

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def search(self, queries: list[tuple]) -> list[tuple]:
        """Batched search: [(qkey, vector, limit, filter)] →
        per query a tuple of (match_key, score) pairs, best first.
        Scores follow the reference convention: L2sq distance (lower=better,
        reported as distance) or cosine distance 1-cos_sim."""
        if not queries:
            return []
        with self._lock:
            if not self._key_to_slot:
                return [() for _ in queries]
            self._flush_to_device()
            max_k = max(int(q[2] or 3) for q in queries)
            # over-fetch when filters present so post-filtering still fills
            # k; the chunked search's per-chunk top-k bounds the fetch
            has_filter = any(q[3] is not None for q in queries)
            fetch_cap = self._fetch_cap()
            fetch_k = min(fetch_cap, max_k * 4 if has_filter else max_k)
            fetch_k = max(fetch_k, 1)
            qmat = torch.from_numpy(np.stack(
                [np.asarray(q[1], dtype=np.float32).reshape(-1)
                 for q in queries])).to(self.device)

            while True:
                top_scores, top_idx = self._device_topk_parts(qmat, fetch_k)

                out = []
                exhausted = True
                for qi, (qkey, qvec, limit, filt) in enumerate(queries):
                    limit = int(limit or 3)
                    matches = []
                    qnorm_sq = None
                    ranks_seen = 0
                    for rank in range(fetch_k):
                        score = top_scores[qi, rank]
                        if not math.isfinite(score):
                            break
                        ranks_seen += 1
                        slot = int(top_idx[qi, rank])
                        key = self._slot_to_key.get(slot)
                        if key is None:
                            continue
                        if filt is not None and not self._passes_filter(
                                key, filt):
                            continue
                        if self.metric == KnnMetric.COS:
                            dist = 1.0 - float(score)
                        else:
                            if qnorm_sq is None:
                                q = np.asarray(qvec,
                                               dtype=np.float32).reshape(-1)
                                qnorm_sq = float(q @ q)
                            dist = max(0.0, qnorm_sq - float(score))
                        matches.append((key, dist))
                        if len(matches) >= limit:
                            break
                    if len(matches) < limit and ranks_seen == fetch_k:
                        # a selective filter ate the whole candidate list
                        # and more live slots remain: escalate the fetch
                        exhausted = False
                    out.append(tuple(matches))
                if exhausted or not has_filter:
                    return out
                if fetch_k >= fetch_cap:
                    # a filter so selective that it eats the largest fetch
                    # falls back to an exact host-side pass over the mirror
                    return [
                        r if len(r) >= int(q[2] or 3) or q[3] is None
                        else self._exhaustive_filtered_search(
                            q[1], int(q[2] or 3), q[3])
                        for q, r in zip(queries, out)
                    ]
                fetch_k = min(fetch_cap, fetch_k * 4)

    def _exhaustive_filtered_search(self, qvec, limit: int, filt):
        """Exact filtered top-k over the host mirror (lock held)."""
        self._sync_mirror()
        keys = [k for k in self._key_to_slot if self._passes_filter(k, filt)]
        if not keys:
            return ()
        slots = torch.tensor([self._key_to_slot[k] for k in keys])
        vecs = self._host_vectors[slots].float().numpy()
        q = np.asarray(qvec, dtype=np.float32).reshape(-1)
        if self.metric == KnnMetric.COS:
            qn = q / (np.linalg.norm(q) + 1e-12)
            vn = vecs / (np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-12)
            dists = 1.0 - vn @ qn
        else:
            dists = np.sum((vecs - q[None, :]) ** 2, axis=1)
        order = np.argsort(dists, kind="stable")[:limit]
        return tuple((keys[int(i)], float(dists[int(i)])) for i in order)

    def latency_probe(self, *, batch_size: int = 1, k: int = 10,
                      reps: int = 32, seed: int = 0) -> float:
        """Device time per search batch, in ms: the JAX package's
        ``latency_probe`` (bench.py's ``knn_p50_ms`` at batch_size 1 and
        ``knn_batch64_ms`` at 64).

        ``reps`` searches of distinct resident queries (uniform in [-1, 1)
        from ``seed``, uploaded once) are queued back to back on the current
        stream, each folded into a device-side accumulator, with no host
        sync between them, after one warm pass of the same searches; the
        wall time from the first to one synchronize after the last, over
        ``reps``. Host merge and result copies are not part of it."""
        with self._lock:
            if not self._key_to_slot:
                raise ValueError("empty index")
            self._flush_to_device()
            run, operands = self._probe_searcher(k)
            rng = np.random.default_rng(seed)
            qpool = torch.from_numpy(rng.random(
                (reps, batch_size, self.dim), dtype=np.float32) * 2.0 - 1.0
            ).to(self.device)

            def probe():
                acc = torch.zeros((), dtype=torch.float32,
                                  device=self.device)
                for i in range(reps):
                    ts, ti = run(qpool[i], operands)
                    acc = acc + ts.sum() + ti.sum().float()
                return acc

            float(probe())  # warm
            t0 = time.perf_counter()
            acc = probe()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            total = time.perf_counter() - t0
            float(acc)
            return total / reps * 1e3

    def _passes_filter(self, key: Pointer, filt: Any) -> bool:
        return passes_filter(self._filter_data, key, filt)


class PagedKnnIndex(BruteForceKnnIndex):
    """BruteForceKnnIndex over the paged device store.

    Device memory is a :class:`DevicePagePool` of page-aligned extents; the
    host page table maps slots to (page, offset). Growth appends an extent
    (existing extents are never re-uploaded), the fused ingest grows by
    allocating pages in one extent or a fresh extent, frees return pages
    to the allocator, and search runs per extent with a host merge by
    (score desc, slot asc). The host mirror is one contiguous CPU tensor
    indexed by global slot.
    """

    def _init_storage(self, reserved_space: int, *,
                      page_rows: int | None = None) -> None:
        self._pool = DevicePagePool(
            self.dim, reserved_space=reserved_space,
            rows_per_page=page_rows, lock=self._lock)
        self._host_vectors = torch.zeros((self._pool.capacity, self.dim),
                                         dtype=self._mirror_dtype)
        self._host_valid = torch.zeros((self._pool.capacity,),
                                       dtype=torch.bool)

    @property
    def capacity(self) -> int:
        return self._pool.capacity

    def page_stats(self) -> dict:
        with self._lock:
            return self._pool.stats()

    # -- slot allocation through the page table -------------------------
    def _ensure_free(self, n: int) -> None:
        self._pool.ensure_free(n)
        self._extend_mirror()

    def _take_slot(self) -> int:
        return self._pool.allocator.take_slot()

    def _release_slot(self, slot: int) -> None:
        self._pool.allocator.release_slot(slot)

    def _extend_mirror(self) -> None:
        """Track pool capacity in the host mirror (host-side only: device
        extents are untouched)."""
        cap = self._pool.capacity
        old = self._host_vectors.shape[0]
        if cap <= old:
            return
        new_vec = torch.zeros((cap, self.dim), dtype=self._mirror_dtype)
        new_vec[:old] = self._host_vectors
        self._host_vectors = new_vec
        new_valid = torch.zeros((cap,), dtype=torch.bool)
        new_valid[:old] = self._host_valid
        self._host_valid = new_valid

    # -- device state per extent ----------------------------------------
    def _establish_extent(self, ext) -> None:
        """Zero device tensors for one extent (allocated on the device, no
        host transfer); rows arrive by in-place writes only. int8 extents
        also carry per-row ``scales`` and ``vsq`` (float32)."""
        if ext.established:
            return
        ext.vectors = torch.zeros((ext.rows, self.dim),
                                  dtype=self._slab_dtype, device=self.device)
        ext.valid = torch.zeros((ext.rows,), dtype=torch.bool,
                                device=self.device)
        if self._is_int8:
            ext.scales = torch.zeros((ext.rows,), dtype=torch.float32,
                                     device=self.device)
            ext.vsq = torch.zeros((ext.rows,), dtype=torch.float32,
                                  device=self.device)

    def _scatter(self, idxs: np.ndarray, vals: torch.Tensor,
                 valid_vals: torch.Tensor) -> None:
        """Write rows (device tensors) at global slots ``idxs``, in place;
        int8 quantizes them through K4."""
        groups = list(self._pool.split_by_extent(idxs))
        for ext, local, pos in groups:
            self._establish_extent(ext)
            if len(groups) == 1:
                vsub, valsub = vals, valid_vals
            else:
                p = torch.from_numpy(pos).to(self.device)
                vsub, valsub = vals[p], valid_vals[p]
            loc = torch.from_numpy(local).to(self.device)
            if self._is_int8:
                quantize_scatter(vsub.float().contiguous(), loc, valsub,
                                 ext.vectors, ext.scales, ext.vsq, ext.valid)
                continue
            ext.vectors.index_copy_(0, loc, vsub.to(self._slab_dtype))
            ext.valid.index_copy_(0, loc, valsub)

    def _flush_to_device(self) -> None:
        if not self._dirty:
            return
        idxs = np.fromiter(self._dirty, dtype=np.int64)
        self._dirty.clear()
        scatter_rows: list[np.ndarray] = []
        for ext, local, pos in self._pool.split_by_extent(idxs):
            if not ext.established and not self._is_int8 \
                    and len(pos) * 2 >= ext.rows:
                # bulk load of a fresh extent: one dense upload of its
                # mirror range — rows outside the dirty set are zeros with
                # valid False (int8 rows are quantized on the device, so
                # they always take the scatter)
                rng = slice(ext.base, ext.base + ext.rows)
                ext.vectors = self._host_vectors[rng].to(self.device)
                ext.valid = self._host_valid[rng].to(self.device)
            else:
                scatter_rows.append(idxs[pos])
        if scatter_rows:
            rows = np.concatenate(scatter_rows)
            r = torch.from_numpy(rows)
            self._scatter(rows, self._host_vectors[r].to(self.device),
                          self._host_valid[r].to(self.device))

    def _sync_mirror(self) -> None:
        """Pull device-authoritative rows back into the host mirror (lock
        held); needed before host-side exact reads."""
        if not self._stale:
            return
        idxs = np.fromiter(self._stale, dtype=np.int64)
        self._stale.clear()
        for ext, local, pos in self._pool.split_by_extent(idxs):
            if not ext.established:
                continue
            loc = torch.from_numpy(local).to(self.device)
            rows = ext.vectors[loc]
            if self._is_int8:  # dequantize: codes x scale, in float32
                rows = rows.float() * ext.scales[loc][:, None]
            self._host_vectors[torch.from_numpy(idxs[pos])] = rows.cpu()

    # -- search over the page table --------------------------------------
    def _fetch_cap(self) -> int:
        return min(self.capacity, _CHUNK_ROWS)

    def _extent_extras(self, ext) -> tuple:
        if self._is_int8:
            return (ext.scales, ext.vsq)
        return ()

    def _device_topk_parts(self, qmat, fetch_k: int):
        """(scores, global slots) as host arrays, exactly ``fetch_k``
        columns, best first. Lock held, device state flushed."""
        parts = []
        for ext in self._pool.extents:
            if not ext.established:
                continue  # never written → no valid rows to score
            k_e = min(fetch_k, ext.rows, _CHUNK_ROWS)
            ts, ti = search_extent(qmat, ext.vectors, ext.valid, k_e,
                                   self.metric, self._extent_extras(ext))
            parts.append((ts.cpu().numpy(), ti.cpu().numpy() + ext.base))
        if not parts:
            B = int(qmat.shape[0])
            return (np.full((B, fetch_k), -np.inf, np.float32),
                    np.zeros((B, fetch_k), np.int64))
        if len(parts) == 1 and parts[0][0].shape[1] == fetch_k:
            return parts[0]
        # merge per-extent candidates: stable argsort on descending score
        # keeps lowest-slot-first tie order (candidates are laid out in
        # global slot order: extents by base, ties by ascending local slot)
        cand_s = np.concatenate([p[0] for p in parts], axis=1)
        cand_i = np.concatenate([p[1] for p in parts], axis=1)
        order = np.argsort(-cand_s, axis=1, kind="stable")[:, :fetch_k]
        top_s = np.take_along_axis(cand_s, order, axis=1)
        top_i = np.take_along_axis(cand_i, order, axis=1)
        if top_s.shape[1] < fetch_k:
            # capacity counts not-yet-established extents, so the
            # established candidates can undershoot an escalated fetch_k —
            # pad to the contract width (-inf rows read as exhausted)
            pad = fetch_k - top_s.shape[1]
            top_s = np.pad(top_s, ((0, 0), (0, pad)),
                           constant_values=-np.inf)
            top_i = np.pad(top_i, ((0, 0), (0, pad)))
        return top_s, top_i

    def _probe_searcher(self, k: int):
        """``(run, operands)``, ``run(q, operands) -> (scores, global
        slots)``: the device side of one search of (B, dim) queries, as
        ``latency_probe`` times it. Each established extent is searched for
        its min(k, rows, ``_CHUNK_ROWS``) best, and the parts merge on the
        device by a stable descending sort (``lax.top_k``'s order over
        parts laid out in slot order); nothing syncs the host."""
        exts = [e for e in self._pool.extents if e.established]
        ks = [min(k, e.rows, _CHUNK_ROWS) for e in exts]
        bases = [e.base for e in exts]
        operands = tuple((e.vectors, self._extent_extras(e), e.valid)
                         for e in exts)
        metric = self.metric

        def run(q, operands):
            ts_all, ti_all = [], []
            for k_e, base, (vectors, extras, valid) in zip(ks, bases,
                                                          operands):
                ts, ti = search_extent(q, vectors, valid, k_e, metric,
                                       extras)
                ts_all.append(ts)
                ti_all.append(ti + base)
            if len(ts_all) == 1:
                return ts_all[0], ti_all[0]
            cand_s = torch.cat(ts_all, dim=1)
            cand_i = torch.cat(ti_all, dim=1)
            return _topk_gather(cand_s, cand_i, min(k, cand_s.shape[1]))

        return run, operands

    def drain(self) -> None:
        """Block until every queued device write has finished."""
        with self._lock:
            for ext in self._pool.extents:
                if ext.established:
                    ext.valid[:1].cpu()

    # -- fused ingest: grow by allocating pages/extents -------------------
    def _fused_ingest(self, step, keys: list[Pointer], args,
                      n_rows: int | None) -> bool:
        alloc = self._pool.allocator
        n_new = len({k for k in keys if k not in self._key_to_slot})
        ext_ids = {self._pool.extent_index_of(self._key_to_slot[k])
                   for k in keys if k in self._key_to_slot}
        if len(ext_ids) > 1:
            # one step writes into ONE extent; a batch updating rows
            # already spread across extents takes the two-step path
            return False
        if ext_ids:
            eidx = next(iter(ext_ids))
        else:
            eidx = max(range(len(self._pool.extents)),
                       key=lambda e: alloc.free_slots_available(regions=[e]))
            if alloc.free_slots_available(regions=[eidx]) < n_new:
                # online growth: a fresh extent sized for the batch — the
                # extents already written are untouched
                self._pool.grow(min_rows=n_new)
                self._extend_mirror()
                eidx = len(self._pool.extents) - 1
        if alloc.free_slots_available(regions=[eidx]) < n_new:
            # updated rows pin an extent too full for the new ones: checked
            # BEFORE any slot is assigned, so no key mapping leaks
            return False
        self._flush_to_device()
        ext = self._pool.extents[eidx]
        self._establish_extent(ext)
        slots = self._fused_take_slots(
            keys, take=lambda: alloc.take_slot(regions=[eidx]))
        step(ext, self._pad_slots(slots - ext.base, n_rows, ext.rows), *args)
        self._host_valid[torch.from_numpy(slots)] = True
        slot_list = slots.tolist()
        self._stale.update(slot_list)
        self._dirty.difference_update(slot_list)
        return True


class DeviceEmbeddingKnnIndex:
    """External index whose add/search take raw TEXT: tokenization runs on
    the host, the encoder forward on the device, and the fresh embeddings
    are written straight into the device extents — they never visit the
    host.

    ``embedder`` must expose ``encode_batch_device(texts) -> (B, dim)``
    tensor on the index's device; with ``pack_tokens`` and
    ``device_producer`` too (EncoderEmbedder has them) ingest takes the
    fused encode + write path. A ragged embedder (``ragged`` true, with
    ``pack_ragged`` and ``ragged_device_producer``) takes one fused call
    per packed chunk, whose padding rows are dropped.
    """

    # read by ExternalIndexOperator.device_bound, as in the JAX package
    device_bound = True

    def __init__(self, embedder, inner: BruteForceKnnIndex):
        dev = getattr(embedder, "device", inner.device)
        if torch.device(dev) != inner.device:
            raise ValueError(f"embedder on {dev}, index on {inner.device}")
        self.embedder = embedder
        self.inner = inner
        self._fused = None
        self._ragged = bool(getattr(embedder, "ragged", False))
        if self._ragged and inner.dtype == "int8" and \
                hasattr(embedder, "ragged_device_forward"):
            # one graph replay per chunk (the JAX package's donated step)
            self._fused = inner.make_graphed_ingest(
                embedder.ragged_device_forward,
                counters=((embedder, "dispatches"),))
        elif self._ragged and hasattr(embedder, "ragged_device_producer"):
            self._fused = inner.make_fused_ingest(
                embedder.ragged_device_producer)
        elif hasattr(embedder, "pack_tokens") and \
                hasattr(embedder, "device_producer"):
            self._fused = inner.make_fused_ingest(embedder.device_producer)

    def _add_fused(self, keys: list[Pointer], texts: list[str]) -> bool:
        """The fused ingest; False when a batch (or, ragged, one of its
        chunks) cannot be placed in one extent."""
        emb = self.embedder
        if not self._ragged:
            ids, lens = emb.pack_tokens(texts)
            return self._fused(keys, emb.model, ids, lens)
        d0 = 0
        for args, n_docs, n_pad in emb.pack_ragged(texts):
            if not self._fused(keys[d0:d0 + n_docs], emb.model, *args,
                               n_rows=n_pad):
                return False
            d0 += n_docs
        return True

    def add_batch(self, keys: list[Pointer], texts,
                  filter_data: list[Any] | None = None) -> None:
        texts = [str(t) for t in texts]
        if self._fused is not None and self._add_fused(keys, texts):
            self.inner.set_filter_data(keys, filter_data)
            return
        # the batch spans extents: encode, then the growable device add
        # (it re-adds every key, so a partly fused ragged batch ends
        # consistent)
        vecs = self.embedder.encode_batch_device(texts)
        self.inner.add_batch_device(keys, vecs, filter_data)

    def add(self, key: Pointer, text, filter_data: Any | None = None) -> None:
        self.add_batch([key], [text],
                       None if filter_data is None else [filter_data])

    def remove(self, key: Pointer) -> None:
        self.inner.remove(key)

    def flush_device(self) -> None:
        self.inner.flush_device()

    def drain(self) -> None:
        self.inner.drain()

    def __len__(self) -> int:
        return len(self.inner)

    def search(self, queries: list[tuple]) -> list[tuple]:
        if not queries:
            return []
        qvecs = self.embedder.embed_batch([str(q[1]) for q in queries])
        return self.inner.search(
            [(qkey, qvecs[i], limit, filt)
             for i, (qkey, _text, limit, filt) in enumerate(queries)])
