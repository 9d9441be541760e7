"""Paged device vector store: device page pool + host-side page table —
port of pathway_tpu/engine/paged_store.py.

Device memory is allocated in page-aligned **extents** that are never
moved or copied once created; a host-side page table maps logical slots
to (page, offset). Growth appends an extent, frees return pages to a free
list, and the fused ingest scatters into one extent in place. The slot
each key gets is the JAX package's, page for page. Pages carry a tenant
tag with optional per-tenant page quotas (``PageQuotaExceeded`` past the
cap): the allocation unit for many small indexes sharing one card.

Not ported: the process-wide stats registry that feeds ``/metrics``
(ROADMAP queue 1, step 7d). Callers hold the owning index's lock around
every pool call — the pool itself is not synchronized.
"""

from __future__ import annotations

import os
from typing import Hashable

import numpy as np

_DEFAULT_PAGE_ROWS = 1024


class PageQuotaExceeded(RuntimeError):
    """A tenant asked for pages beyond its configured quota. Growth cannot
    help (the quota, not the pool, is the limit), so this escapes instead
    of looping the grow path."""


def paged_store_enabled(override: bool | None = None) -> bool:
    """Paged device storage is the default; ``PATHWAY_PAGED_STORE=0``
    selects the contiguous slab (ops/knn.py ``BruteForceKnnIndex``)."""
    if override is not None:
        return bool(override)
    return os.environ.get("PATHWAY_PAGED_STORE", "1").lower() not in (
        "0", "false", "off", "no")


def page_rows(override: int | None = None) -> int:
    """Rows per page. Must be a power of two in [128, 2^19] so pages tile
    the chunked search's chunk size (ops/knn.py ``_CHUNK_ROWS``)."""
    rows = override if override is not None else int(
        os.environ.get("PATHWAY_PAGE_ROWS", _DEFAULT_PAGE_ROWS))
    if rows < 128 or rows > (1 << 19) or rows & (rows - 1):
        raise ValueError(
            f"page_rows must be a power of two in [128, {1 << 19}]; got "
            f"{rows} (PATHWAY_PAGE_ROWS)")
    return rows


def quota_pages(quota_rows: int, rows_per_page: int) -> int:
    """Pages a row quota buys — rounded UP, so a non-page-aligned quota
    over-grants."""
    return -(-int(quota_rows) // rows_per_page)


class _Page:
    __slots__ = ("pid", "base", "region", "free", "live", "tenant")

    def __init__(self, pid: int, base: int, region: Hashable, rows: int):
        self.pid = pid
        self.base = base          # global row id of offset 0
        self.region = region      # extent index, or (extent, shard)
        self.free = list(range(rows - 1, -1, -1))  # LIFO offsets
        self.live = 0
        self.tenant: Hashable | None = None


class PageAllocator:
    """Host-side page table: slot allocation within fixed-size pages.

    Pages belong to a *region* (the device extent — or (extent, shard)
    block for the mesh-sharded store) fixed at registration, and are
    claimed by a *tenant* on first allocation. A page with live rows is
    "open" for its tenant; a page whose last row is freed returns to its
    region's free list (tenant tag cleared) — the reuse that keeps
    occupancy bounded under ingest/delete churn.

    Global row ids are contiguous across regions and every region base is
    page-aligned, so ``slot // page_rows`` IS the page id.
    """

    def __init__(self, rows_per_page: int,
                 tenant_quotas: dict[Hashable, int] | None = None):
        self.page_rows = int(rows_per_page)
        self.pages: list[_Page] = []
        # region → LIFO of unclaimed page ids; insertion order preserved
        self._free_pages: dict[Hashable, list[int]] = {}
        # (tenant, region) → page ids with free slots, claimed by tenant
        self._open: dict[tuple, list[int]] = {}
        self.tenant_pages: dict[Hashable, int] = {}
        # quotas in PAGES (callers convert rows via quota_pages)
        self.tenant_quota_pages: dict[Hashable, int] | None = (
            dict(tenant_quotas) if tenant_quotas else None)
        self.live_rows = 0

    # -- registration -------------------------------------------------------
    def add_region(self, region: Hashable, base: int, n_pages: int) -> None:
        if base % self.page_rows:
            raise ValueError(
                f"region base {base} not aligned to page_rows "
                f"{self.page_rows}")
        pids = []
        for i in range(n_pages):
            pid = len(self.pages)
            self.pages.append(_Page(
                pid, base + i * self.page_rows, region, self.page_rows))
            pids.append(pid)
        # LIFO free list: reversed so lower page ids are taken first
        self._free_pages.setdefault(region, []).extend(reversed(pids))

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    @property
    def n_free_pages(self) -> int:
        return sum(len(v) for v in self._free_pages.values())

    # -- quota accounting ---------------------------------------------------
    def quota_remaining_pages(self, tenant: Hashable) -> int | None:
        """Pages ``tenant`` may still claim (None = unlimited)."""
        if self.tenant_quota_pages is None:
            return None
        quota = self.tenant_quota_pages.get(tenant)
        if quota is None:
            return None
        return max(0, quota - self.tenant_pages.get(tenant, 0))

    def quota_capped_slots(self, tenant: Hashable) -> int | None:
        """Upper bound on slots ``tenant`` can ever reach from here
        (open-page slack + quota'd fresh pages), growth included. None =
        unbounded."""
        rem = self.quota_remaining_pages(tenant)
        if rem is None:
            return None
        return self._slack(tenant, None) + rem * self.page_rows

    def _slack(self, tenant: Hashable, region_ok) -> int:
        return sum(
            len(self.pages[pid].free)
            for (t, r), pids in self._open.items()
            if t == tenant and (region_ok is None or r in region_ok)
            for pid in pids)

    # -- allocation ---------------------------------------------------------
    def free_slots_available(self, tenant: Hashable = None,
                             regions: list[Hashable] | None = None) -> int:
        """Slots obtainable WITHOUT growing the pool: the tenant's open
        pages' slack plus unclaimed pages (quota-capped), optionally
        restricted to ``regions``."""
        region_ok = None if regions is None else set(regions)
        fresh = sum(
            len(pids) for r, pids in self._free_pages.items()
            if region_ok is None or r in region_ok)
        rem = self.quota_remaining_pages(tenant)
        if rem is not None:
            fresh = min(fresh, rem)
        return self._slack(tenant, region_ok) + fresh * self.page_rows

    def take_slot(self, tenant: Hashable = None,
                  regions: list[Hashable] | None = None) -> int:
        """Allocate one slot for ``tenant`` (claiming a fresh page when its
        open pages are full). Raises PageQuotaExceeded / RuntimeError when
        nothing is available — callers ensure_free first."""
        region_ok = None if regions is None else set(regions)
        page = self._open_page(tenant, region_ok) or \
            self._claim_page(tenant, region_ok)
        return self._take_from(page)

    def take_slots(self, n: int, tenant: Hashable = None,
                   regions: list[Hashable] | None = None) -> np.ndarray:
        """The slots of ``n`` successive ``take_slot(tenant, regions)``
        calls, in order, taken a page at a time (a quota runs out at the
        same slot as it would one call at a time)."""
        region_ok = None if regions is None else set(regions)
        out = []
        while n:
            page = self._open_page(tenant, region_ok) or \
                self._claim_page(tenant, region_ok)
            k = min(n, len(page.free))
            # take_slot pops offsets from the end of the page's free list
            out.append(page.base + np.array(page.free[:-k - 1:-1],
                                            dtype=np.int64))
            del page.free[-k:]
            page.live += k
            self.live_rows += k
            n -= k
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    def _open_page(self, tenant: Hashable, region_ok) -> _Page | None:
        """The open page of ``tenant`` with a free slot that ``take_slot``
        takes from next (dropping filled pages from the open lists as it
        goes), or None."""
        for key in list(self._open.keys()):
            t, r = key
            if t != tenant or (region_ok is not None and r not in region_ok):
                continue
            pids = self._open[key]
            while pids:
                page = self.pages[pids[-1]]
                if page.free:
                    return page
                pids.pop()  # page filled up — no longer open
            del self._open[key]
        return None

    def _claim_page(self, tenant: Hashable, region_ok) -> _Page:
        rem = self.quota_remaining_pages(tenant)
        if rem is not None and rem <= 0:
            raise PageQuotaExceeded(
                f"tenant {tenant!r} page quota "
                f"({self.tenant_quota_pages[tenant]} pages x "
                f"{self.page_rows} rows) exhausted")
        for r, pids in self._free_pages.items():
            if pids and (region_ok is None or r in region_ok):
                page = self.pages[pids.pop()]
                page.tenant = tenant
                page.free = list(range(self.page_rows - 1, -1, -1))
                self.tenant_pages[tenant] = \
                    self.tenant_pages.get(tenant, 0) + 1
                self._open.setdefault((tenant, r), []).append(page.pid)
                return page
        raise RuntimeError(
            "no free pages — pool.ensure_free was not called before "
            "take_slot")

    def _take_from(self, page: _Page) -> int:
        off = page.free.pop()
        page.live += 1
        self.live_rows += 1
        return page.base + off

    def release_slot(self, slot: int) -> None:
        page = self.pages[slot // self.page_rows]
        page.free.append(slot - page.base)
        page.live -= 1
        self.live_rows -= 1
        key = (page.tenant, page.region)
        if page.live == 0:
            # page drained: back to the region's free list, for ANY tenant
            pids = self._open.get(key)
            if pids is not None:
                if page.pid in pids:
                    pids.remove(page.pid)
                if not pids:
                    del self._open[key]
            self.tenant_pages[page.tenant] = \
                self.tenant_pages.get(page.tenant, 1) - 1
            page.tenant = None
            page.free = []
            self._free_pages.setdefault(page.region, []).append(page.pid)
        else:
            # a partially freed page becomes allocatable again for its
            # tenant
            pids = self._open.setdefault(key, [])
            if page.pid not in pids:
                pids.append(page.pid)

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        live_pages = self.n_pages - self.n_free_pages
        return {
            "page_rows": self.page_rows,
            "pages_total": self.n_pages,
            "pages_free": self.n_free_pages,
            "pages_live": live_pages,
            "live_rows": self.live_rows,
            "occupancy": (self.live_rows / (live_pages * self.page_rows)
                          if live_pages else 0.0),
            "tenants": {
                str(t): n for t, n in self.tenant_pages.items() if n > 0},
        }


class Extent:
    """One device allocation of the pool: ``rows`` vector slots starting at
    global row ``base``. Device tensors are established lazily by the
    owning index (ops/knn.py); once established they are only updated in
    place — never copied or re-uploaded on growth. An int8 index also
    keeps each row's quantization ``scales`` and int-domain squared norm
    ``vsq`` (float32, one per row)."""

    __slots__ = ("base", "rows", "vectors", "valid", "scales", "vsq")

    def __init__(self, base: int, rows: int):
        self.base = base
        self.rows = rows
        self.vectors = None
        self.valid = None
        self.scales = None
        self.vsq = None

    @property
    def established(self) -> bool:
        return self.vectors is not None


def _aligned_rows(rows: int, rows_per_page: int) -> int:
    """Extent sizing: page multiple, and a chunk multiple past the chunked
    search's threshold."""
    from pathway_tpu_torch.ops.knn import _CHUNK_ROWS, _round_up

    rows = _round_up(max(rows, 1), rows_per_page)
    if rows > _CHUNK_ROWS:
        rows = _round_up(rows, _CHUNK_ROWS)
    return rows


class DevicePagePool:
    """Extent list + page allocator for one logical vector store.

    Growth appends an extent at least as large as everything allocated so
    far (doubling → O(log N) extents → O(log N) per-extent searches and
    merge width), sized up to cover large single requests.
    """

    def __init__(self, dim: int, *, reserved_space: int = 0,
                 rows_per_page: int | None = None,
                 tenant_quotas: dict[Hashable, int] | None = None,
                 lock=None):
        from pathway_tpu_torch.ops.knn import planned_capacity

        self.dim = int(dim)
        pr = page_rows(rows_per_page)
        quota_p = (
            {t: quota_pages(rows, pr) for t, rows in tenant_quotas.items()}
            if tenant_quotas else None)
        self.allocator = PageAllocator(pr, quota_p)
        self.extents: list[Extent] = []
        self.grow_events = 0
        # the owning index's lock: stats() readers take it too
        self._owner_lock = lock
        self._add_extent(_aligned_rows(planned_capacity(reserved_space), pr))

    # -- extents ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return sum(e.rows for e in self.extents)

    def _add_extent(self, rows: int) -> Extent:
        ext = Extent(self.capacity, rows)
        self.extents.append(ext)
        self.allocator.add_region(
            len(self.extents) - 1, ext.base,
            rows // self.allocator.page_rows)
        return ext

    def grow(self, min_rows: int = 0) -> Extent:
        """Online growth: ONE new extent (device memory established lazily,
        as zeros, on the next flush) — existing extents are not moved,
        copied or re-uploaded."""
        rows = _aligned_rows(max(min_rows, self.capacity),
                             self.allocator.page_rows)
        self.grow_events += 1
        return self._add_extent(rows)

    def _check_quota(self, n: int, tenant: Hashable) -> None:
        capped = self.allocator.quota_capped_slots(tenant)
        if capped is not None and capped < n:
            raise PageQuotaExceeded(
                f"tenant {tenant!r} needs {n} slots but its page quota "
                f"caps it at {capped} more")

    def ensure_free(self, n: int, tenant: Hashable = None) -> None:
        """Guarantee ``n`` take_slot calls for ``tenant`` succeed."""
        self._check_quota(n, tenant)
        while self.allocator.free_slots_available(tenant) < n:
            self.grow()

    def reserve_rows(self, n: int, tenant: Hashable = None) -> None:
        """One-shot pre-size for a known bulk load: a single extent
        covering the whole deficit instead of ensure_free's doubling
        cascade."""
        self._check_quota(n, tenant)
        deficit = n - self.allocator.free_slots_available(tenant)
        if deficit > 0:
            self.grow(min_rows=deficit)

    # -- slot → extent mapping ---------------------------------------------
    def extent_index_of(self, slot: int) -> int:
        for i, ext in enumerate(self.extents):
            if slot < ext.base + ext.rows:
                return i
        raise IndexError(f"slot {slot} beyond pool capacity {self.capacity}")

    def split_by_extent(self, slots: np.ndarray):
        """Group global slots by extent: yields (extent, local_rows,
        positions) where ``positions`` indexes back into ``slots``."""
        slots = np.asarray(slots, dtype=np.int64)
        for ext in self.extents:
            in_ext = (slots >= ext.base) & (slots < ext.base + ext.rows)
            if not in_ext.any():
                continue
            pos = np.flatnonzero(in_ext)
            yield ext, (slots[pos] - ext.base), pos

    def touched_page_ids(self) -> frozenset:
        """The page-touch set of a search over this pool right now: every
        page of every established extent (a search scans whole extents
        under their valid masks; extents never established hold no rows
        and are skipped). The semantic result cache
        (engine/result_cache.py) records it per entry — an insert into a
        page outside it landed where the entry's scan never read.
        Callers hold the owning index's lock."""
        pr = self.allocator.page_rows
        pages: set[int] = set()
        for ext in self.extents:
            if not ext.established:
                continue
            first = ext.base // pr
            pages.update(range(first, first + ext.rows // pr))
        return frozenset(pages)

    def stats(self) -> dict:
        if self._owner_lock is not None:
            with self._owner_lock:
                return self._stats_locked()
        return self._stats_locked()

    def _stats_locked(self) -> dict:
        st = self.allocator.stats()
        st.update({
            "capacity_rows": self.capacity,
            "extents": len(self.extents),
            "grow_events": self.grow_events,
        })
        return st
