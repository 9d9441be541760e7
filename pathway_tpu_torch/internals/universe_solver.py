"""Universe relation solver — port of pathway_tpu/internals/universe_solver.py.

Reference: python/pathway/internals/universe_solver.py — a python-sat
constraint solver deciding subset/equality relations between universes
(key sets), powering ``with_universe_of`` validation and same-universe
operator checks. Only three kinds of facts are ever asserted (subset,
equality = two subsets, disjointness) and only those are queried, so a
relation graph with query-time transitive closure decides the asserted
entailments without a SAT dependency:

- subset: reachability in the directed superset graph;
- equality: subset both ways;
- disjointness: declared pairs, inherited downward (a ⊆ x, b ⊆ y,
  x ⊥ y ⇒ a ⊥ b).

One deliberate approximation vs the reference solver: union results
(concat/update_rows) record only the LOWER bounds input ⊆ result — the
upper bound "result ⊆ S whenever every input ⊆ S" is not derived, so
such checks fall back to runtime-keyed behavior instead of static proof.

Query-time closure also fixes the eager-snapshot design this replaces:
a promise recorded on a parent universe now holds for subuniverses
created EARLIER, matching the reference solver's behavior.
"""

from __future__ import annotations

import weakref

_PRUNE_EVERY = 4096  # fact insertions between garbage sweeps


class UniverseSolver:
    def __init__(self):
        self._supersets: dict[int, set[int]] = {}
        self._disjoint: set[frozenset] = set()
        # live Universe objects by id — dead ones get spliced out of the
        # relation graph (reachability-preserving), so a long-lived
        # process doesn't accumulate relations for dead pipelines forever
        self._registry: "weakref.WeakValueDictionary[int, object]" = (
            weakref.WeakValueDictionary())
        self._adds_since_prune = 0

    def reset(self) -> None:
        """Drop all relations — called by ParseGraph.clear()."""
        self._supersets.clear()
        self._disjoint.clear()
        self._adds_since_prune = 0

    def register(self, universe) -> None:
        self._registry[universe.id] = universe

    def _prune(self) -> None:
        """Splice garbage-collected universes out of the graph while
        preserving every entailment between LIVE universes: a dead node's
        incoming edges are rewired to its outgoing set, and disjoint
        pairs naming it are conservatively re-attributed to its
        predecessors (a ⊆ x†, x† ⊥ y still implies a ⊥ y)."""
        live = set(self._registry.keys())
        dead = [uid for uid in list(self._supersets) if uid not in live]
        for d in dead:
            outs = self._supersets.pop(d, set())
            outs.discard(d)
            preds = [sub for sub, sups in self._supersets.items()
                     if d in sups]
            for sub in preds:
                sups = self._supersets[sub]
                sups.discard(d)
                sups |= outs
            if self._disjoint:
                stale = [p for p in self._disjoint if d in p]
                for pair in stale:
                    self._disjoint.discard(pair)
                    (other,) = tuple(pair - {d}) or (d,)
                    for sub in preds:
                        self._disjoint.add(frozenset((sub, other)))
        self._adds_since_prune = 0

    # -- facts ------------------------------------------------------------
    def add_subset(self, sub_id: int, sup_id: int) -> None:
        self._supersets.setdefault(sub_id, set()).add(sup_id)
        self._adds_since_prune += 1
        if self._adds_since_prune >= _PRUNE_EVERY:
            self._prune()

    def add_equal(self, a_id: int, b_id: int) -> None:
        self.add_subset(a_id, b_id)
        self.add_subset(b_id, a_id)

    def add_disjoint(self, a_id: int, b_id: int) -> None:
        self._disjoint.add(frozenset((a_id, b_id)))

    # -- queries ----------------------------------------------------------
    def _ancestors(self, uid: int) -> set[int]:
        seen = {uid}
        stack = [uid]
        while stack:
            for sup in self._supersets.get(stack.pop(), ()):
                if sup not in seen:
                    seen.add(sup)
                    stack.append(sup)
        return seen

    def is_subset(self, sub_id: int, sup_id: int) -> bool:
        return sup_id in self._ancestors(sub_id)

    def are_equal(self, a_id: int, b_id: int) -> bool:
        return a_id == b_id or (
            self.is_subset(a_id, b_id) and self.is_subset(b_id, a_id))

    def are_disjoint(self, a_id: int, b_id: int) -> bool:
        if not self._disjoint:
            return False
        anc_a = self._ancestors(a_id)
        anc_b = self._ancestors(b_id)
        for pair in self._disjoint:
            x, y = tuple(pair) if len(pair) == 2 else (next(iter(pair)),) * 2
            if (x in anc_a and y in anc_b) or (y in anc_a and x in anc_b):
                return True
        return False


GLOBAL_SOLVER = UniverseSolver()
