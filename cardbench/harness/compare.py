"""The comparison that decides a training cell's ``correct``: the
program's first steps against the plain reference's from the same
weights and batches.

Each number is a gap, taken by the worst step or leaf:
- ``loss_gap``: the largest |loss_p - loss_r| / loss_r over the steps;
- ``grad_norm_gap``: |g_p - g_r| / g_r of step 1's global gradient norm;
- ``grad_gap``: the largest |n_p - n_r| / max(n_r, median n_r) over the
  leaves, n the norm of a leaf's step-1 gradient after clipping, as the
  optimizer's first moment holds it;
- ``change_gap``: the same over the leaves' change after the last step,
  leaving out a leaf whose reference gradient is under a thousandth of
  the median leaf's (its change is round-off alone)."""
from __future__ import annotations

import math
import statistics

TINY_GRAD = 1e-3


def _worst(gaps) -> float:
    """The largest gap; a NaN or an infinity reads inf."""
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return _worst(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                  for k in keys)


def numbers(prog: dict, ref: dict) -> dict:
    """The gaps between two summaries (``loss``, ``grad_norm``, ``grad``,
    ``change``); a summary that lacks a leaf or a step reads inf."""
    if (set(prog["grad"]) != set(ref["grad"]) or
            len(prog["loss"]) != len(ref["loss"])):
        return {k: math.inf for k in ("loss_gap", "grad_norm_gap",
                                      "grad_gap", "change_gap")}
    med = statistics.median(ref["grad"].values())
    moved = [k for k in ref["grad"] if ref["grad"][k] >= TINY_GRAD * med]
    out = {
        "loss_gap": _worst(abs(p - r) / abs(r)
                           for p, r in zip(prog["loss"], ref["loss"])),
        "grad_norm_gap": _worst([abs(prog["grad_norm"] - ref["grad_norm"]) /
                                 ref["grad_norm"]]),
        "grad_gap": _leaf_gap(prog["grad"], ref["grad"], ref["grad"]),
        "change_gap": _leaf_gap(prog["change"], ref["change"], moved),
    }
    return out


def judge(nums: dict, limits: dict) -> bool:
    """Every number within its limit (a number with no limit fails)."""
    return all(k in limits and v <= limits[k] for k, v in nums.items())


def lines(nums: dict, limits: dict) -> list:
    return [f"check {k} {v!r} limit {limits.get(k)!r}"
            for k, v in nums.items()]
