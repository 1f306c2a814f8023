"""The comparison that decides ``correct``: the numbers compared, each
against its limit from the cell's file under ``bench/limits/``.

Training (the first ``check_steps`` steps, which set-up drives through the
window's own step and feed): the first step's loss; the first gradient as
the optimizer gets it (clipped; read from its first moment after one
step), by norm and element by element on a sample of each leaf's
elements drawn from the seed (the relative L2 distance to the
reference's: a norm averages the rounding of a lower precision away);
the change of the parameters over the steps, by norm.  A norm is judged
by the gap between the program's and the reference's, over the
reference's norm of that same leaf, so that a small leaf left unmoved, or
given no gradient, reads 1 however small it is.  Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out.  The later steps' losses are not compared: they
swing with Adam's sign-like first step, as far for the float8 control as
for a sound run.

Serving: for each sampled request, the gap by which the served token's
reference logit lies below the reference's best, and the relative L2
distance of the logits the engine sampled it from to the reference's;
the widest gap and the largest distance count.
"""

from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3           # a gradient under this share of the median leaf's


def leaf_gaps(prog: dict, ref: dict) -> dict[str, tuple[float, float]]:
    """{leaf: (gradient gap, change gap)}, each gap between the two norms
    over the reference's norm of the leaf, for the leaves the comparison
    keeps (a gradient of at least ``NOUGHT`` of the median leaf's)."""
    g, c = ref["grad_norm"], ref["change_norm"]
    med = statistics.median(g.values())
    return {p: (abs(prog["grad_norm"][p] - g[p]) / max(g[p], 1e-30),
                abs(prog["change_norm"][p] - c[p]) / max(c[p], 1e-30))
            for p in sorted(g) if g[p] >= NOUGHT * med}


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref``: {"loss": [step losses], "grad_norm": {leaf:
    norm}, "grad_sample": {leaf: sampled elements}, "change_norm": {leaf:
    norm}} -> the compared numbers."""
    gaps = leaf_gaps(prog, ref)
    a, b = prog["grad_sample"], ref["grad_sample"]
    grad_err = max(float((a[p] - b[p]).norm() / b[p].norm().clamp(min=1e-30))
                   for p in gaps)
    return {"loss1_gap": abs(prog["loss"][0] - ref["loss"][0])
            / abs(ref["loss"][0]),
            "grad_gap": max(g for g, _ in gaps.values()),
            "grad_err": grad_err,
            "change_gap": max(c for _, c in gaps.values())}


def logit_gap(ref_logits, served: int) -> float:
    """How far the served token's reference logit lies below the best."""
    return float(ref_logits.max() - ref_logits[served])


def logit_err(logits, ref_logits) -> float:
    """Relative L2 distance of the logits a token was sampled from to the
    reference's."""
    d = logits.float() - ref_logits
    return float(d.norm() / ref_logits.norm())


def judge(numbers: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks
