"""The comparison that decides ``correct``: the numbers the program's
output is held to, each against its limit from ``limits/<cell>.json``.

Training (the two calls that set-up makes through the window's own
``run_steps``: the first, eager and captured, from the benchmark's
weights; the second, the first replay, from the state the first left;
the reference follows the second from that state):

- ``loss_gap``: the largest relative gap of a step's loss over the
  second call;
- ``grad_gap``: the median leaf's gap between the norms of the program's
  and the reference's Adam first moment after the second call (the
  gradients as the optimizer holds them);
- ``change_gap``: the median leaf's gap between the norms of the change
  of the weights over the second call;
- ``change_worst_gap``: the same for the worst leaf;
- ``start_loss_gap``: the relative gap of the first call's first loss
  (the forward and loss at the benchmark's weights).

A leaf's gap is ``| |a| - |r| |`` over the larger of ``|r|`` and the
median leaf's ``|r|``.  Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
(:func:`moving_leaves`).  The worst leaf, of the moment and of the
change, is as a rule a small one whose gradient is a sum that cancels
(the input layer's, a bias), and the state that the first call leaves
sets how far bfloat16 rounding moves such sums: the reference itself in
bfloat16 reads as the program does there.  So both are taken at the
median leaf, and the worst leaf's change is reported beside them.  The rest
of the first call is not compared: its 32 steps at the schedule's peak
rate carry a rounding difference in step 1 into gaps of order one.  A
cell's limits file names the numbers it compares; a number it does not
name is reported with no limit.

Scoring: ``prob_max_gap`` and ``prob_mean_gap``, the largest and the
largest mean absolute gap of an edge's probability over the sampled
events, real edges only.
"""

from __future__ import annotations

import math
import statistics


STILL = 1e-3


def _norm(t) -> float:
    return float(t.detach().double().norm())


def moving_leaves(ref_grad: dict) -> list:
    """Leaves whose reference gradient is at least ``STILL`` times the
    median leaf's."""
    norms = {k: _norm(v) for k, v in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= STILL * med]


def _diff(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def train_details(first: dict, second: dict, ref1: dict,
                  ref2: dict) -> dict:
    """What the training numbers are worked out from. ``first``/``second``:
    the program's calls (``losses`` and the state after them: ``params``
    and ``adam``); ``ref1``: the reference's first step from the
    benchmark's weights; ``ref2``: :func:`port_bench.reference.follow`
    over the second call's steps from the state ``first`` left.  Returns
    the first step's loss and the second call's, program and reference,
    and for each moving leaf the norms of Adam's first moment after the
    second call and of the change over it: program, reference, and their
    difference's."""
    keep = moving_leaves(ref2["exp_avg"])
    p1 = first["params"]
    m_p, m_r = second["adam"]["exp_avg"], ref2["exp_avg"]
    d_p, d_r = _diff(second["params"], p1), _diff(ref2["params"], p1)
    return dict(
        start=[float(first["losses"][0]), float(ref1["losses"][0])],
        losses=[[float(a), float(b)]
                for a, b in zip(second["losses"], ref2["losses"])],
        leaves={k: dict(m=[_norm(m_p[k]), _norm(m_r[k]),
                           _norm(m_p[k] - m_r[k])],
                        d=[_norm(d_p[k]), _norm(d_r[k]),
                           _norm(d_p[k] - d_r[k])]) for k in keep})


def _gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gaps(leaves: dict, part: str, pick) -> float:
    """``pick`` (max: the worst leaf; the median) of the leaves' gaps of
    norms of ``part``."""
    med = statistics.median(v[part][1] for v in leaves.values())
    return pick([abs(v[part][0] - v[part][1]) / max(v[part][1], med, 1e-30)
                 for v in leaves.values()])


def train_numbers(details: dict) -> dict:
    """The numbers compared, from :func:`train_details`."""
    return dict(
        loss_gap=_finite(max(_gap(a, b) for a, b in details["losses"])),
        grad_gap=_finite(_leaf_gaps(details["leaves"], "m", statistics.median)),
        change_gap=_finite(_leaf_gaps(details["leaves"], "d",
                                      statistics.median)),
        change_worst_gap=_finite(_leaf_gaps(details["leaves"], "d", max)),
        start_loss_gap=_finite(_gap(*details["start"])))


def prob_numbers(pairs) -> dict:
    """``pairs``: ``(program's probabilities, reference's)`` of each
    sampled event over its real edges."""
    mx = mean = 0.0
    for got, want in pairs:
        d = (got.double() - want.double().to(got.device)).abs()
        mx = max(mx, float(d.max()))
        mean = max(mean, float(d.mean()))
    return dict(prob_max_gap=_finite(mx), prob_mean_gap=_finite(mean))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number that ``limits`` names at or
    under its limit (none named: not correct); the others are reported
    with no limit."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    compared = [c for c in checks.values() if c["limit"] is not None]
    ok = bool(compared) and all(c["value"] <= c["limit"] for c in compared)
    return ok, checks
