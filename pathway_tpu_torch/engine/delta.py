"""Diff-delta representation, the engine's unit of data motion — port of
pathway_tpu/engine/delta.py.

A *delta* is a consolidated multiset of ``(key, row, diff)`` changes at one
logical timestamp. Tables are keyed — at most one live row per key — so
arrangements are plain ``dict[key -> row]`` and consolidation sums diffs
per (key, row-fingerprint). Rows are Python tuples on the host.
"""

from __future__ import annotations

from typing import Iterable, Iterator

from pathway_tpu_torch.internals.keys import Pointer, hash_values

Entry = tuple  # (Pointer, tuple_row, int_diff)


def row_fingerprint(row: tuple) -> int:
    """Equality-compatible digest of a row (handles ndarray cells)."""
    try:
        return hash(row)
    except TypeError:
        return int(hash_values(*row))


class Delta:
    """A consolidated batch of (key, row, diff) updates."""

    __slots__ = ("entries",)

    def __init__(self, entries: list[Entry] | None = None):
        self.entries: list[Entry] = entries if entries is not None else []

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        return bool(self.entries)

    def __iter__(self) -> Iterator[Entry]:
        return iter(self.entries)

    def append(self, key: Pointer, row: tuple, diff: int) -> None:
        self.entries.append((key, row, diff))

    def extend(self, entries: Iterable[Entry]) -> None:
        self.entries.extend(entries)

    def consolidate(self) -> "Delta":
        if len(self.entries) <= 1:
            return self
        # fast path: all keys distinct (map/source outputs over unique rows)
        # — nothing can cancel, so skip the per-row fingerprinting
        seen: set = set()
        distinct = True
        for key, _, diff in self.entries:
            if key in seen or diff == 0:
                distinct = False
                break
            seen.add(key)
        if distinct:
            return self
        acc: dict[tuple[Pointer, int], list] = {}
        for key, row, diff in self.entries:
            k = (key, row_fingerprint(row))
            slot = acc.get(k)
            if slot is None:
                acc[k] = [key, row, diff]
            else:
                slot[2] += diff
        return Delta([(k, r, d) for k, r, d in acc.values() if d != 0])

    def keys_list(self) -> list[Pointer]:
        return [k for k, _, _ in self.entries]


class Arrangement:
    """Materialized current state of a keyed table: key -> row.

    ``update`` applies a consolidated delta: an insertion sets the key's
    row, a retraction removes it if it is the row stored.
    """

    __slots__ = ("rows",)

    def __init__(self):
        self.rows: dict[Pointer, tuple] = {}

    def get(self, key: Pointer):
        return self.rows.get(key)

    def update(self, delta: Delta) -> None:
        for key, row, diff in delta.entries:
            if diff > 0:
                self.rows[key] = row
            elif diff < 0:
                cur = self.rows.get(key)
                if cur is not None and row_fingerprint(cur) == row_fingerprint(row):
                    del self.rows[key]


def upsert_delta(arrangement: Arrangement, key: Pointer, new_row: tuple | None,
                 out: Delta) -> None:
    """Emit retraction of the current row (if any) + insertion of new_row."""
    cur = arrangement.rows.get(key)
    if cur is not None:
        if new_row is not None and row_fingerprint(cur) == row_fingerprint(new_row):
            return
        out.append(key, cur, -1)
    if new_row is not None:
        out.append(key, new_row, 1)
