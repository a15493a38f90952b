"""What the training checks share: the gaps of a learner's leaves against the
reference's, leaf by leaf, as norms.

A gap is |program's norm - reference's norm| over max(the reference's norm of
that leaf, the median leaf's), so that a leaf whose norm is all but zero is
held to the scale of the others.
"""
from __future__ import annotations

import statistics


def gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor)


def leaf_gaps(start: dict, got_m: dict, got_p: dict, want_m: dict, want_p: dict):
    """(grad_gap, change_gap).  `*_m`: the Adam first moments of the leaves
    Adam steps, after the first checked iteration; `*_p`: every leaf after
    the last; `start`: the leaves before the first.  grad_gap is the widest
    gap of a moment's norm; change_gap the widest of a leaf's change from
    the start, leaving out the Adam leaves whose reference moment is under a
    thousandth of the median leaf's (they move by rounding alone)."""
    m_norm = {k: float(x.norm()) for k, x in want_m.items()}
    m_med = statistics.median(m_norm.values())
    grad_gap = max(gap(float(got_m[k].norm()), m_norm[k], m_med) for k in m_norm)
    moved = [k for k in want_p if k not in m_norm or m_norm[k] >= 1e-3 * m_med]
    d_want = {k: float((want_p[k] - start[k]).norm()) for k in moved}
    d_med = statistics.median(d_want.values())
    change_gap = max(gap(float((got_p[k] - start[k]).norm()), d_want[k], d_med) for k in moved)
    return grad_gap, change_gap
