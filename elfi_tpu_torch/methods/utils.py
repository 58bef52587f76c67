"""Helpers of the method layer (counterpart of
:mod:`elfi_tpu.methods.utils`): host-side bookkeeping in numpy, as in the
JAX package, and the SMC proposal :class:`GMDistribution` on tensors."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.distributions import solve_lower_rows
from ..utils import capture
from ..utils.profiling import annotate

__all__ = [
    "arr2d_to_batch", "batch_to_arr2d", "ceil_to_batch_size",
    "normalize_weights", "compute_ess", "weighted_var",
    "weighted_sample_quantile", "sample_quantile", "GMDistribution",
    "PreparedGM",
    "numgrad", "flat_array_to_dict", "resolve_sigmas",
    "sample_object_to_dict", "numpy_to_python_type",
]


def arr2d_to_batch(x, names):
    """(n, d) array -> batch dict keyed by sorted parameter names."""
    x = np.atleast_2d(x)
    if x.shape[1] != len(names):
        raise ValueError(f"Array width {x.shape[1]} != len(names) {len(names)}")
    return {name: x[:, i] for i, name in enumerate(names)}


def batch_to_arr2d(batch, names):
    """Batch dict -> (n, d) array, columns in ``names`` order."""
    if not names:
        return np.empty((0, 0))
    cols = []
    for n in names:
        c = np.asarray(batch[n])
        cols.append(c.reshape(c.shape[0], -1) if c.ndim > 1 else c[:, None])
    return np.concatenate(cols, axis=1)


def ceil_to_batch_size(n, batch_size):
    return int(batch_size * np.ceil(n / batch_size))


def normalize_weights(weights):
    w = np.atleast_1d(np.asarray(weights, np.float64))
    s = w.sum()
    if s == 0:
        raise ValueError("All weights are zero")
    return w / s


def compute_ess(weights):
    """Kish effective sample size."""
    w = normalize_weights(weights)
    return 1.0 / np.sum(w ** 2)


def weighted_var(x, weights=None):
    """Unbiased weighted variance per dimension."""
    x = np.atleast_2d(np.asarray(x, np.float64).reshape(len(x), -1))
    if weights is None:
        return np.var(x, axis=0, ddof=1)
    w = normalize_weights(weights)
    mean = np.sum(w[:, None] * x, axis=0)
    return np.sum(w[:, None] * (x - mean) ** 2, axis=0) / (1 - np.sum(w ** 2))


def weighted_sample_quantile(x, alpha, weights=None):
    """alpha-quantile of a weighted sample: smallest x whose cumulative
    normalized weight reaches alpha."""
    x = np.asarray(x, np.float64).ravel()
    order = np.argsort(x)
    xs = x[order]
    if weights is None:
        w = np.full(len(x), 1.0 / len(x))
    else:
        w = normalize_weights(np.asarray(weights).ravel()[order])
    cum = np.cumsum(w)
    idx = int(np.searchsorted(cum, alpha, side="left"))
    return float(xs[min(idx, len(xs) - 1)])


sample_quantile = weighted_sample_quantile


def flat_array_to_dict(names, arr):
    """1-D parameter vector -> {name: scalar-array}."""
    arr = np.atleast_1d(arr)
    return {name: np.atleast_1d(arr[i]) for i, name in enumerate(names)}


def resolve_sigmas(parameter_names, sigma_proposals=None, bounds=None):
    """Resolve Metropolis proposal stds; default 1/10 of bound lengths."""
    if sigma_proposals is None:
        if bounds is None:
            raise ValueError("Either sigma_proposals or bounds is required")
        return np.array([(b[1] - b[0]) / 10 for b in bounds])
    if isinstance(sigma_proposals, dict):
        return np.array([sigma_proposals[n] for n in parameter_names])
    return np.asarray(sigma_proposals)


def numgrad(fn, x, h=1e-5):
    """Numeric central-difference gradient, kept for API parity; prefer
    autograd."""
    x = np.asarray(x, np.float64).ravel()
    g = np.zeros_like(x)
    for i in range(len(x)):
        e = np.zeros_like(x)
        e[i] = h
        g[i] = (fn(x + e) - fn(x - e)) / (2 * h)
    return g


#: most prior-support redraw rounds of one proposal draw
_MAX_REDRAWS = 1000


class PreparedGM(NamedTuple):
    """A mixture as :meth:`GMDistribution.prepare` puts it on a device:
    float32 ``means`` (m, d), the Cholesky factor ``L`` (d, d) of the
    shared covariance, and normalised ``weights`` (m,)."""
    means: torch.Tensor
    L: torch.Tensor
    weights: torch.Tensor


class GMDistribution:
    """Gaussian mixture with shared covariance, the SMC proposal, on
    tensors in float32.

    ``means``: (m, d); ``cov``: (d, d) shared; ``weights``: (m,).  The
    port's :meth:`rvs` serves the eager fused and the batch-at-a-time SMC
    rounds; a captured chunk draws through :meth:`rvs_masked` (the JAX
    package has ``rvs`` and ``rvs_traced``).  :meth:`prepare` puts a
    mixture on the device once, so a round's draws copy nothing from the
    host and factor nothing again.
    """

    @staticmethod
    def prepare(means, cov=1, weights=None, device=None):
        """The mixture as a :class:`PreparedGM` on ``device`` (default:
        the device of ``means`` if it is a tensor, else the CPU).
        ``cholesky_ex`` does not wait for the device to check the factor,
        as ``torch.linalg.cholesky`` does on CUDA."""
        if device is None and isinstance(means, torch.Tensor):
            device = means.device
        means = torch.atleast_2d(torch.as_tensor(means, dtype=torch.float32,
                                                 device=device))
        m, d = means.shape
        cov = torch.as_tensor(cov, dtype=torch.float32, device=means.device)
        if cov.ndim < 2:
            cov = torch.eye(d, device=means.device) * cov
        if weights is None:
            weights = torch.full((m,), 1.0 / m, device=means.device)
        else:
            w = torch.as_tensor(weights, dtype=torch.float32,
                                device=means.device)
            weights = w / torch.sum(w)
        return PreparedGM(means, torch.linalg.cholesky_ex(cov).L, weights)

    @staticmethod
    def _draw(prepared, size, generator):
        means, L, weights = prepared
        comp = torch.multinomial(weights, size, replacement=True,
                                 generator=generator)
        z = torch.randn((size, means.shape[1]), generator=generator,
                        device=means.device)
        return means[comp] + z @ L.T

    @classmethod
    def rvs(cls, means, cov=1, weights=None, size=1, prior_logpdf=None,
            generator=None):
        """Draw ``size`` proposal points on ``generator``'s device.

        ``means`` may also be a :class:`PreparedGM` (then ``cov`` and
        ``weights`` are ignored).  With ``prior_logpdf`` (a function on
        tensors), rows outside the prior support are drawn again from the
        same generator, at most 1000 rounds; each round reads one flag back
        to the host."""
        if generator is None:
            raise ValueError("GMDistribution.rvs requires a torch.Generator")
        prepared = means if isinstance(means, PreparedGM) else cls.prepare(
            means, cov, weights, device=generator.device)
        if prior_logpdf is None:
            return cls._draw(prepared, size, generator)
        return cls.rvs_counted(prepared, size, prior_logpdf, generator)[0]

    @classmethod
    def rvs_counted(cls, prepared, size, prior_logpdf, generator):
        """:meth:`rvs` of a :class:`PreparedGM` under ``prior_logpdf``:
        (the draws, the redraw rounds the loop took).  A batch that took
        ``k`` rounds is what :meth:`rvs_masked` gives, flag set, at
        ``rounds >= k``."""
        out = cls._draw(prepared, size, generator)
        for rounds in range(_MAX_REDRAWS):
            ok = torch.isfinite(prior_logpdf(out)) \
                & torch.isfinite(out).all(dim=1)
            with annotate("elfi.host_read"):
                inside = bool(ok.all())
            if inside:
                return out, rounds
            out = torch.where(ok[:, None], out,
                              cls._draw(prepared, size, generator))
        raise RuntimeError(
            "Could not draw proposal points inside the prior support")

    @classmethod
    def rvs_masked(cls, prepared, size, prior_logpdf, generator, rounds,
                   counter=None):
        """:meth:`rvs` with at most ``rounds`` redraw rounds, the
        counterpart of the JAX package's ``rvs_traced``: the first draw,
        then rounds of which each replaces the rows still outside the
        prior's support, each run only while some row is outside
        (:func:`~elfi_tpu_torch.utils.capture.run_if`: in a CUDA graph an
        IF node, round ``k + 1``'s inside round ``k``'s, so no host read;
        eagerly a host read a round).  Returns (the draws, a 0-d flag that
        every row is inside).  Each round draws from the generator's next
        offsets, so the rounds the eager loop takes draw what it draws, and
        a round after every row is inside would change nothing: where the
        flag is set the draws are :meth:`rvs`'s, bit for bit.  Each round
        that runs adds 1 to ``counter``, a 0-d int64 tensor, if given."""
        out = cls._draw(prepared, size, generator)

        def inside(o, into=None):
            return torch.logical_and(torch.isfinite(prior_logpdf(o)),
                                     torch.isfinite(o).all(dim=1), out=into)

        # written in place: a graph reads them after the rounds' nodes
        ok = inside(out)

        def outside():
            return ~ok.all()

        def redraw(k):
            torch.where(ok[:, None], out,
                        cls._draw(prepared, size, generator), out=out)
            inside(out, into=ok)
            if counter is not None:
                counter.add_(1)
            if k + 1 < rounds:
                capture.run_if(outside, lambda: redraw(k + 1))

        if rounds > 0:
            capture.run_if(outside, lambda: redraw(0))
        return out, ok.all()

    @classmethod
    def logpdf(cls, x, means, cov=1, weights=None):
        """Mixture log-density of ``x`` (n, d) as a float32 tensor, on the
        device of the prepared mixture (``means`` may be a
        :class:`PreparedGM`)."""
        means, L, weights = means if isinstance(means, PreparedGM) else \
            cls.prepare(means, cov, weights,
                        device=x.device if isinstance(x, torch.Tensor)
                        else None)
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32,
                                             device=means.device))
        d = means.shape[1]
        sol = solve_lower_rows(L, x[:, None, :] - means[None, :, :])
        quad = torch.sum(sol * sol, dim=-1)                 # (n, m)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        lognorm = -0.5 * (d * math.log(2 * math.pi) + logdet)
        comp = lognorm - 0.5 * quad + torch.log(weights)[None, :]
        return torch.logsumexp(comp, dim=1)

    @classmethod
    def pdf(cls, x, means, cov=1, weights=None):
        return torch.exp(cls.logpdf(x, means, cov, weights))


def sample_object_to_dict(data, elem, skip=""):
    """Flatten a result object's attributes into ``data`` for JSON export:
    ``outputs`` and ``skip`` are omitted, ``meta`` entries are inlined."""
    omit = {"outputs", skip}
    for key, val in vars(elem).items():
        if key in omit:
            continue
        if key == "meta":
            data.update(val)
        else:
            data[key] = val


def numpy_to_python_type(data):
    """In-place conversion of numpy scalars/arrays (one level of nesting) to
    plain Python types for JSON serialization."""
    def _convert(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        return v

    for key, val in data.items():
        if isinstance(val, dict):
            for k2, v2 in val.items():
                val[k2] = _convert(v2)
        else:
            data[key] = _convert(val)
