"""Universes — key-set identity of tables — port of
pathway_tpu/internals/universe.py.

Relations (subset / equality / disjointness) live in the process-wide
``UniverseSolver`` (internals/universe_solver.py) and are decided by
query-time transitive closure, so a promise recorded on a parent holds
for subuniverses created before OR after the promise.
"""

from __future__ import annotations

import itertools

from pathway_tpu_torch.internals.universe_solver import GLOBAL_SOLVER

_ids = itertools.count()


class Universe:
    __slots__ = ("id", "__weakref__")

    def __init__(self):
        self.id = next(_ids)
        GLOBAL_SOLVER.register(self)

    def subuniverse(self) -> "Universe":
        u = Universe()
        GLOBAL_SOLVER.add_subset(u.id, self.id)
        return u

    def is_subset_of(self, other: "Universe") -> bool:
        return GLOBAL_SOLVER.is_subset(self.id, other.id)

    def is_equal_to(self, other: "Universe") -> bool:
        return self is other or GLOBAL_SOLVER.are_equal(self.id, other.id)

    def is_disjoint_from(self, other: "Universe") -> bool:
        return GLOBAL_SOLVER.are_disjoint(self.id, other.id)

    def promise_is_subset_of(self, other: "Universe") -> None:
        GLOBAL_SOLVER.add_subset(self.id, other.id)

    def promise_is_disjoint_from(self, other: "Universe") -> None:
        GLOBAL_SOLVER.add_disjoint(self.id, other.id)

    def __repr__(self):
        return f"<Universe {self.id}>"
