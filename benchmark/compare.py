"""The comparisons that decide ``correct``: each number beside its limit.

Training: the program's first steps against the reference's on the same
weights and rows, by three numbers, each a gap between two readings
measured against the reference's:

  loss_gap    the largest |loss_p − loss_r| / |loss_r| over the steps;
  grad_gap    the worst leaf's |‖g_p‖ − ‖g_r‖| / max(‖g_r‖, median leaf's
              ‖g_r‖), g the clipped first gradient as Adam received it;
  change_gap  the same of ‖p_n − p_0‖ after the checked steps, over the
              leaves whose reference gradient is at least a thousandth of
              the median leaf's (a leaf with no gradient moves under Adam
              by round-off alone);

and ``rows_wrong``, the rows of the checked batches that differ from the
rows the benchmark rebuilds from its own corpus (limit 0).
"""

from __future__ import annotations

import math
import statistics

ZERO_GRAD_SHARE = 1e-3


def _worst_leaf(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    if set(prog) != set(ref):
        return math.inf
    median = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        worst = max(worst, gap) if math.isfinite(gap) else math.inf
    return worst


def leaf_gaps(prog: dict, ref: dict) -> list:
    """[(gap, leaf)] of one kind of reading, worst first (for the log)."""
    median = statistics.median(ref.values())
    gaps = ((abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30), k) for k in ref if k in prog)
    return sorted(((g if math.isfinite(g) else math.inf, k) for g, k in gaps), reverse=True)


def training(prog: dict, ref: dict, limits: dict, rows_wrong: int = 0) -> dict:
    """{name: (value, limit)}."""
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = math.inf
    else:
        loss_gap = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
                       for p, r in zip(prog["loss"], ref["loss"]))
    median_g = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= ZERO_GRAD_SHARE * median_g]
    values = {"rows_wrong": float(rows_wrong), "loss_gap": loss_gap,
              "grad_gap": _worst_leaf(prog["grad"], ref["grad"], ref["grad"]),
              "change_gap": _worst_leaf(prog["change"], ref["change"], moving)}
    return {k: (v, limits.get(k)) for k, v in values.items()}


def passed(checks: dict) -> bool:
    return all(lim is not None and math.isfinite(v) and v <= lim
               for v, lim in checks.values())
