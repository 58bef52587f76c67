"""The reference's top-N selection and the comparison that decides
``correct`` for a returned sample.

A sample is ``n`` rows (parameters, distance): the rows of smallest
distance among all the simulations of a call (or of an SMC round), each
parameter row as the prior or the proposal drew it.  The reference keeps
its ``n + MARGIN`` best rows, so that a row which rounding moves across
the n-th distance still finds its partner, and reads three numbers:

- ``theta_gap``: for each returned row, the nearest of the reference's rows
  by the largest parameter difference in units of the prior's range; the
  largest such gap.  A row that is not one of the best simulations, or
  whose parameters were computed otherwise, stands apart;
- ``dist_gap``: the largest difference between a returned row's distance
  and its partner's, over the reference's n-th distance;
- ``rows_missed``: the reference's best ``n - MARGIN`` rows that no
  returned row matches within :data:`MATCH` (a dropped or skipped
  simulation).
"""

from __future__ import annotations

import math

import torch

MARGIN = 64
#: a returned row matches a reference row within this parameter gap, in
#: units of the prior's range: far above rounding (the two draw the same
#: uniforms; sound runs on an H100 read at most 6e-8), far below the
#: spacing of the returned rows (about 1e-3)
MATCH = 1e-4


class TopRows:
    """The ``k`` rows of smallest distance seen so far (float64)."""

    def __init__(self, k):
        self.k = k
        self.theta = None
        self.d = None

    def add(self, theta, d):
        d = torch.where(torch.isnan(d), math.inf, d.to(torch.float64))
        theta = theta.to(torch.float64)
        if self.d is not None:
            d = torch.cat([self.d, d])
            theta = torch.cat([self.theta, theta])
        k = min(self.k, d.numel())
        top = torch.topk(d, k, largest=False, sorted=True)
        self.d, self.theta = top.values, theta[top.indices]


def compare(theta, d, ref, n, scales):
    """The three numbers of a returned sample (``theta`` (n, P), ``d``
    (n,)) against the reference's :class:`TopRows` ``ref``."""
    device = ref.d.device
    theta = torch.as_tensor(theta, dtype=torch.float64, device=device)
    d = torch.as_tensor(d, dtype=torch.float64, device=device)
    if theta.shape[0] != n:
        return {"theta_gap": math.inf, "dist_gap": math.inf,
                "rows_missed": float(n)}
    s = torch.as_tensor(scales, dtype=torch.float64, device=device)
    gaps, nearest = [], []
    for block in torch.split(theta, 1024):
        g = ((block[:, None, :] - ref.theta[None, :, :]).abs() / s).amax(-1)
        v, i = g.min(dim=1)
        gaps.append(v)
        nearest.append(i)
    gap, nearest = torch.cat(gaps), torch.cat(nearest)
    d_n = float(ref.d[n - 1])
    dist_gap = float(((d - ref.d[nearest]).abs() / d_n).max())
    matched = torch.zeros(ref.d.numel(), dtype=torch.bool, device=device)
    matched[nearest[gap <= MATCH]] = True
    missed = int((~matched[:max(n - MARGIN, 0)]).sum())
    return {"theta_gap": float(gap.max()),
            "dist_gap": dist_gap if math.isfinite(dist_gap) else math.inf,
            "rows_missed": float(missed)}
