"""The comparison that decides ``correct``.

The program's first rounds (driven at set-up through the window's own
``Federation.step``) against the plain reference's rounds from the same
weights and documents:

* ``loss_gap``: over the checked rounds, the largest ``|loss - ref| /
  |ref|`` of the round's reported loss;
* ``first_delta_gap``: per leaf, the norm of the global weights' change
  in the first round (the combined message the server step applies) on
  each side; the worst leaf's ``|norm - ref norm| / max(ref norm, median
  leaf's ref norm)``;
* ``change_gap``: the same for the change after the last checked round;
* ``first_delta_median_gap``, ``change_median_gap``: the median over the
  leaves of the same per-leaf gaps, steady where single leaves are not
  (top-k's kept set flips on near-ties under fp32 reordering, and a flip
  moves a small leaf's norm far more than a large one's).

A cell compares the numbers its ``limits`` name; the others are printed
as readings.

Leaves whose reference change in the first round is under a thousandth
of the median leaf's are left out of both norm gaps: round-off alone
moves them.  A number that is not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence, Tuple

NUMBERS = ("loss_gap", "first_delta_gap", "change_gap",
           "first_delta_median_gap", "change_median_gap")


def kept_leaves(ref_first: Mapping[str, float]) -> List[str]:
    med = statistics.median(ref_first.values())
    return [k for k, v in ref_first.items() if v >= 1e-3 * med]


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              keep: Sequence[str]) -> Dict[str, float]:
    """Per leaf, ``|norm - ref norm| / max(ref norm, median leaf's)``."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def worst_leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                   keep: Sequence[str]) -> Tuple[float, str]:
    gaps = leaf_gaps(prog, ref, keep)
    if not all(math.isfinite(g) for g in gaps.values()):
        return math.inf, next(k for k, g in gaps.items()
                              if not math.isfinite(g))
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median_leaf_gap(prog, ref, keep) -> float:
    gaps = list(leaf_gaps(prog, ref, keep).values())
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return statistics.median(gaps)


def numbers(prog: Mapping[str, object], ref: Mapping[str, object]
            ) -> Dict[str, object]:
    """The compared numbers, with the leaves they were read on."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    loss_gap = max(losses) if all(math.isfinite(x) for x in losses) \
        else math.inf
    keep = kept_leaves(ref["first"])
    first, first_leaf = worst_leaf_gap(prog["first"], ref["first"], keep)
    change, change_leaf = worst_leaf_gap(prog["change"], ref["change"], keep)
    return {"loss_gap": loss_gap, "first_delta_gap": first,
            "change_gap": change,
            "first_delta_median_gap": median_leaf_gap(prog["first"],
                                                      ref["first"], keep),
            "change_median_gap": median_leaf_gap(prog["change"],
                                                 ref["change"], keep),
            "first_delta_leaf": first_leaf,
            "change_leaf": change_leaf,
            "left_out": sorted(set(ref["first"]) - set(keep))}


def judge(nums: Mapping[str, object], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number the limits name finite and within its limit,
    {name: {value, limit}})."""
    out, ok = {}, True
    for name in limits:
        v, lim = float(nums[name]), float(limits[name])
        ok = ok and math.isfinite(v) and v <= lim
        out[name] = {"value": v, "limit": lim}
    return ok, out
