"""Fuzzy joins over feature overlap — port of
pathway_tpu/stdlib/ml/smart_table_ops.py
(reference: python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py —
fuzzy_match_tables:106, smart_fuzzy_match:199, fuzzy_self_match:249,
fuzzy_match:265, fuzzy_match_with_hint:282).

Rows are matched by shared text features (word tokens or letters) weighted
inversely by global frequency; a pair survives when it is the heaviest
match for BOTH its endpoints (mutual-best), which is the reference's greedy
matching criterion expressed with incremental groupby/argmax instead of an
imperative pass — every step is a Table op, so matches update live as
either side changes."""

from __future__ import annotations

import math
import re
from enum import IntEnum

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import reducers_frontend as reducers
from pathway_tpu_torch.internals.table import Table


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = 0
    TOKENIZE = 1
    LETTERS = 2


class FuzzyJoinNormalization(IntEnum):
    NONE = 0
    WEIGHT = 1
    LOGWEIGHT = 2


_TOKEN_RE = re.compile(r"[\w']+")


def _gen_features(value, generation: FuzzyJoinFeatureGeneration) -> tuple:
    text = "" if value is None else str(value).lower()
    if generation in (FuzzyJoinFeatureGeneration.AUTO,
                      FuzzyJoinFeatureGeneration.TOKENIZE):
        feats = tuple(_TOKEN_RE.findall(text))
        if feats or generation == FuzzyJoinFeatureGeneration.TOKENIZE:
            return feats
    return tuple(ch for ch in text if not ch.isspace())


def _flatten_features(feats: Table) -> Table:
    flat = feats.flatten(feats.fs)
    return flat.select(node=flat.node, feature=flat.fs)


def fuzzy_match(left_col: ex.ColumnReference, right_col: ex.ColumnReference,
                feature_generation=FuzzyJoinFeatureGeneration.AUTO,
                normalization=FuzzyJoinNormalization.WEIGHT,
                _exclude_identity: bool = False) -> Table:
    """Mutual-best pairs (left id, right id, weight) between two columns."""
    lt, rt = left_col.table, right_col.table
    lfeat = _flatten_features(lt.select(
        node=lt.id,
        fs=ex.apply(lambda v: tuple(sorted(set(_gen_features(
            v, feature_generation)))), left_col)))
    rfeat = _flatten_features(rt.select(
        node=rt.id,
        fs=ex.apply(lambda v: tuple(sorted(set(_gen_features(
            v, feature_generation)))), right_col)))

    # global feature frequency over both sides → inverse weight
    all_feats = lfeat.concat_reindex(rfeat)
    counts = all_feats.groupby(all_feats.feature).reduce(
        feature=all_feats.feature, cnt=reducers.count())

    if normalization == FuzzyJoinNormalization.LOGWEIGHT:
        weight_fn = lambda c: 1.0 / (1.0 + math.log(c))
    elif normalization == FuzzyJoinNormalization.NONE:
        weight_fn = lambda c: 1.0
    else:
        weight_fn = lambda c: 1.0 / c

    pairs = lfeat.join(rfeat, lfeat.feature == rfeat.feature).select(
        left=lfeat.node, right=rfeat.node, feature=lfeat.feature)
    pairs = pairs.join(counts, pairs.feature == counts.feature).select(
        left=pairs.left, right=pairs.right,
        w=ex.apply(weight_fn, counts.cnt))
    scores = pairs.groupby(pairs.left, pairs.right).reduce(
        left=pairs.left, right=pairs.right, weight=reducers.sum(pairs.w))
    if _exclude_identity:
        # self-match: a row's trivially-perfect match with itself must not
        # shadow its real partners
        scores = scores.filter(ex.apply(lambda l, r: l != r,
                                        scores.left, scores.right))

    # mutual-best: the pair must be its left node's argmax AND its right's
    best_l = scores.groupby(scores.left).reduce(
        best=reducers.argmax(scores.weight))
    best_r = scores.groupby(scores.right).reduce(
        best=reducers.argmax(scores.weight))
    chosen_l = best_l.select(pair=best_l.best)
    chosen_r = best_r.select(pair=best_r.best)
    mutual = chosen_l.join(chosen_r, chosen_l.pair == chosen_r.pair).select(
        pair=chosen_l.pair)
    winners = scores.having(mutual.pair)
    return winners.select(left=winners.left, right=winners.right,
                          weight=winners.weight)


def smart_fuzzy_match(left_col: ex.ColumnReference,
                      right_col: ex.ColumnReference, **kwargs) -> Table:
    return fuzzy_match(left_col, right_col, **kwargs)


def fuzzy_self_match(table: Table, col: ex.ColumnReference,
                     **kwargs) -> Table:
    """Match a table against itself, excluding identity and mirror pairs."""
    copy = table.copy()
    res = fuzzy_match(table[col.name] if isinstance(col, ex.ColumnReference)
                      else table[col], copy[col.name],
                      _exclude_identity=True, **kwargs)
    return res.filter(ex.apply(lambda l, r: int(l) < int(r),
                               res.left, res.right))


def _concat_text(table: Table) -> Table:
    cols = [table[c] for c in table.column_names()]
    return table.select(full=ex.apply(
        lambda *vs: " ".join("" if v is None else str(v) for v in vs), *cols))


def fuzzy_match_tables(left: Table, right: Table, *, by_hand_match=None,
                       feature_generation=FuzzyJoinFeatureGeneration.AUTO,
                       normalization=FuzzyJoinNormalization.WEIGHT) -> Table:
    """Row-level fuzzy join: all columns concatenated to one text feature
    source per row (reference _concatenate_columns + fuzzy_match)."""
    lt = _concat_text(left)
    rt = _concat_text(right)
    result = fuzzy_match(lt.full, rt.full,
                         feature_generation=feature_generation,
                         normalization=normalization)
    if by_hand_match is not None:
        result = fuzzy_match_with_hint(result, by_hand_match)
    return result


def fuzzy_match_with_hint(matches: Table, by_hand_match: Table) -> Table:
    """Override automatic matches with hand-curated (left, right, weight)
    pairs: hand pairs win for any left node they mention."""
    hand_lefts = by_hand_match.select(left=by_hand_match.left)
    jr = matches.join_left(hand_lefts, matches.left == hand_lefts.left)
    flags = jr.select(left=matches.left, right=matches.right,
                      weight=matches.weight, hand=hand_lefts.left)
    auto = flags.filter(ex.IsNoneExpression(flags.hand)).select(
        left=flags.left, right=flags.right, weight=flags.weight)
    hand = by_hand_match.select(left=by_hand_match.left,
                                right=by_hand_match.right,
                                weight=by_hand_match.weight)
    return auto.concat_reindex(hand)
