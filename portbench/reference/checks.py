"""The comparison that decides ``correct``, and its limits.

Each number compared stands beside its limit. ``invalid`` and ``missing``
are exact counts (limit 0). The recall floors are the configuration's own
(``recall_floor``: the upstream's recall@10 >= 0.95). The three distance
gaps have limits set between two readings on the card (PERF.md): the
largest that sound runs of the program gave over a dozen seeds or more,
and the smallest that the control (the reference in TF32; for the int8
candidates, in int4) gave.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["DIST_GAP", "EDGE_DIST_GAP", "CAND_GAP", "check", "correct", "invalid_kinds", "invalid_answers", "recall",
           "lines"]

# the widest gap between a distance that a search answer carries and the
# float64 cosine distance of its query and row (cosine distance units)
DIST_GAP = 6e-6
# the widest gap between a stored edge distance of the grown graph and the
# float64 squared L2 of the two unit rows it joins
EDGE_DIST_GAP = 2.5e-5
# the widest gap between an int8 candidate's distance as the search returns
# it and the exact squared L2 of the reference's own int8 codes of its query
# and row (squared int8 code units: a unit row's components times 127)
CAND_GAP = 200.0


def check(name: str, value: float, limit: float, *, at_most: bool = True) -> dict:
    """One number beside its limit; NaN never holds."""
    value = float(value)
    holds = (value <= limit) if at_most else (value >= limit)
    return {"name": name, "value": value, "limit": float(limit), "at_most": at_most,
            "holds": bool(holds) and not math.isnan(value)}


def correct(checks: list[dict]) -> bool:
    return bool(checks) and all(c["holds"] for c in checks)


def invalid_kinds(ids: np.ndarray, dists: np.ndarray, n: int, k: int,
                  allowed: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """Per answer [Q], each way it can break its guarantee: fewer than k
    ids (-1 or +inf padding: ``short``), an id outside [0, n), a repeated
    id, distances out of order, an id its query's filter does not allow
    (``allowed`` [Q, k] bool)."""
    pad = (ids == -1) & ~np.isfinite(dists)
    with np.errstate(invalid="ignore"):  # inf - inf between two padding slots
        order = (np.diff(np.where(pad, np.inf, dists), axis=1) < 0).any(1)
    kinds = {
        "short": pad.any(1) | (ids.shape[1] != k),
        "out_of_range": (((ids < 0) | (ids >= n)) & ~pad).any(1),
        "repeated": np.zeros(ids.shape[0], dtype=bool),
        "out_of_order": order | (~np.isfinite(dists) & ~pad).any(1),
        "outside_filter": np.zeros(ids.shape[0], dtype=bool),
    }
    srt = np.sort(np.where(pad, -1 - np.arange(ids.shape[1]), ids), axis=1)
    kinds["repeated"] = (srt[:, 1:] == srt[:, :-1]).any(1)
    if allowed is not None:
        kinds["outside_filter"] = (~allowed & ~pad).any(1)
    return kinds


def invalid_answers(ids: np.ndarray, dists: np.ndarray, n: int, k: int,
                    allowed: np.ndarray | None = None) -> int:
    """Answers [Q, k] that do not hold k distinct ids of rows in [0, n)
    with finite, ascending distances (and, with ``allowed`` [Q, k] bool,
    every id allowed by its query's filter)."""
    kinds = invalid_kinds(ids, dists, n, k, allowed)
    return int(np.logical_or.reduce(list(kinds.values())).sum())


def recall(got: np.ndarray, want: np.ndarray) -> float:
    """Mean share of each row of ``want`` (the exact top-k) found in the
    same row of ``got``."""
    k = want.shape[1]
    hits = [len(set(g.tolist()) & set(w.tolist()) - {-1}) for g, w in zip(got, want)]
    return float(np.sum(hits)) / (k * len(want))


def lines(checks: list[dict]) -> list[str]:
    """The numbers compared, one a line, each beside its limit."""
    return [f"check {c['name']} {c['value']:.9g} {'<=' if c['at_most'] else '>='} "
            f"{c['limit']:.9g} {'holds' if c['holds'] else 'FAILS'}" for c in checks]
