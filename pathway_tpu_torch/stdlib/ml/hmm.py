"""Hidden-Markov-Model stream decoding — port of pathway_tpu/stdlib/ml/hmm.py
(reference: python/pathway/stdlib/ml/hmm.py:11 create_hmm_reducer).

``create_hmm_reducer(graph)`` returns an accumulator class for
``pw.reducers.udf_reducer``: each new observation extends a running Viterbi
decode over the HMM described by a networkx-style ``DiGraph`` whose nodes
carry ``calc_emission_log_ppb(observation)`` and whose edges carry
``log_transition_ppb``; ``graph.graph["start_nodes"]`` lists initial states.
The emitted value is the most-likely state path (optionally only its last
``num_results_kept`` states), re-decoded incrementally as the stream grows —
so downstream sees retract/re-emit diffs whenever new evidence rewrites
history, exactly the reference's update-stream behavior.

Implementation is beam-search Viterbi over explicit per-state paths (the
framework keeps whole paths instead of backpointer frames: simpler, and the
beam bound keeps it O(beam) per step)."""

from __future__ import annotations

import math

from pathway_tpu_torch.internals.reducers_frontend import BaseCustomAccumulator


def create_hmm_reducer(graph, beam_size: int | None = None,
                       num_results_kept: int | None = None):
    nodes = list(graph.nodes())
    start_nodes = graph.graph.get("start_nodes", nodes)
    emission = {n: graph.nodes[n]["calc_emission_log_ppb"] for n in nodes}
    transitions: dict = {n: [] for n in nodes}
    for u, v, data in graph.edges(data=True):
        transitions[u].append((v, data["log_transition_ppb"]))
    beam = beam_size if beam_size is not None else len(nodes) + 1

    class HmmAccumulator(BaseCustomAccumulator):
        def __init__(self, observation):
            self.observation = observation
            # best[state] = (log_ppb, path tuple ending at state)
            self.best: dict = {}
            for s in start_nodes:
                lp = emission[s](observation)
                if lp is not None and not math.isinf(lp):
                    self.best[s] = (lp, (s,))
            self._trim()

        @classmethod
        def from_row(cls, row):
            [observation] = row
            return cls(observation)

        def _trim(self):
            if len(self.best) > beam:
                kept = sorted(self.best.items(), key=lambda kv: -kv[1][0])[:beam]
                self.best = dict(kept)

        def update(self, other: "HmmAccumulator") -> None:
            # `other` carries one new observation: score every reachable
            # next-state against it
            obs = other.observation
            new_best: dict = {}
            for state, (lp, path) in self.best.items():
                for nxt, t_lp in transitions[state]:
                    e_lp = emission[nxt](obs)
                    if e_lp is None or math.isinf(e_lp):
                        continue
                    cand = lp + t_lp + e_lp
                    if nxt not in new_best or cand > new_best[nxt][0]:
                        new_best[nxt] = (cand, path + (nxt,))
            self.best = new_best
            self.observation = obs
            self._trim()

        def compute_result(self):
            if not self.best:
                return ()
            _lp, path = max(self.best.values(), key=lambda v: v[0])
            if num_results_kept is not None:
                path = path[-num_results_kept:]
            return path

    return HmmAccumulator
