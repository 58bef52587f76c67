"""Order statistics shared by the zoo's summaries, with the JAX package's
float32 arithmetic (``jnp.quantile`` and ``jnp.nanquantile`` along axis 1,
linear interpolation).  ``torch.quantile`` is not used: it refuses inputs
above 2^24 elements, which a batch of the toad model exceeds."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantiles", "nanquantiles", "batch_param"]


def batch_param(v, batch_size, device):
    """A parameter as a float32 ``(batch_size,)`` tensor on ``device``."""
    return torch.broadcast_to(
        torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1),
        (batch_size,))


def quantiles(x, q):
    """``jnp.quantile(x, q, axis=1)``: shape (len(q), batch); a row with a
    NaN gives NaN."""
    n = x.shape[1]
    xs = torch.sort(x, dim=1).values
    xs = torch.where(torch.isnan(xs).any(dim=1, keepdim=True), torch.nan, xs)
    pos = np.asarray(q, np.float32) * np.float32(n - 1)
    low = np.clip(np.floor(pos), 0, n - 1).astype(int)
    high = np.clip(np.ceil(pos), 0, n - 1).astype(int)
    w_high = pos - np.floor(pos)
    w_low = np.float32(1) - w_high
    return torch.stack([xs[:, lo] * float(wl) + xs[:, hi] * float(wh)
                        for lo, hi, wl, wh in zip(low, high, w_low, w_high)])


def nanquantiles(x, q):
    """``jnp.nanquantile(x, q, axis=1)``: NaNs are left out of each row,
    and a row of NaNs gives NaN; shape (len(q), batch)."""
    xs = torch.sort(x, dim=1).values          # NaNs sort last
    counts = (~torch.isnan(x)).sum(dim=1).to(torch.float32)
    out = []
    for qi in np.asarray(q, np.float32):
        pos = float(qi) * (counts - 1)
        low, high = torch.floor(pos), torch.ceil(pos)
        w_high = pos - low
        w_low = 1 - w_high
        top = counts - 1
        low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
        high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
        lv = xs.gather(1, low.long()[:, None])[:, 0]
        hv = xs.gather(1, high.long()[:, None])[:, 0]
        out.append(lv * w_low + hv * w_high)
    return torch.stack(out)
