"""Optimization helpers for Bayesian optimization (counterpart of
:mod:`elfi_tpu.methods.bo.utils`).

:func:`adam_minimize` is the bounded Adam descent of every device-side
optimization of BO (acquisitions, GP hyperparameter fits, the posterior
threshold): all starts as one batch of rows, each step one evaluation of
the objective and its autograd gradient.  :func:`descend` runs it on a
CUDA device as a replay of a CUDA graph captured once per objective and
shapes, since the eager descent would be thousands of small launches that
the host issues one by one; the replay gives the eager run's result bit
for bit.  :func:`minimize_traced` is the multi-start minimizer on top of
it.  The scipy host helpers are the JAX package's.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import scipy.optimize
import torch
from scipy.optimize import differential_evolution
from torch.utils._pytree import tree_flatten, tree_unflatten

from ...parallel.backends import resolve_device
from ...utils.rng import generator
from .gp import full_float32_matmul, value_and_grad

__all__ = ["stochastic_optimization", "minimize", "minimize_traced",
           "adam_minimize", "descend", "CostFunction"]


def adam_minimize(obj, x0, steps, lr, lo, hi):
    """Bounded Adam descent of ``obj`` from every row of ``x0`` (..., d),
    tracking each row's best iterate; ``obj`` maps the rows to their
    values, ``x0.shape[:-1]``.  Returns (best rows, their values).

    One evaluation per step gives the value (for the best-iterate
    tracking) and the gradient; non-finite gradients are zeroed, the
    iterate is clipped to ``[lo, hi]`` and the step size decays as
    ``lr * 0.5 ** (3 i / steps)``.  The step constants are float32, as the
    JAX package's traced ones."""
    # best-iterate tracking starts from x0, so an out-of-bounds start
    # could otherwise be returned by a bounded minimizer
    x0 = torch.clamp(x0, lo, hi)
    with torch.no_grad():
        best_f = obj(x0)
    x = best_x = x0
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    f32 = np.float32
    for i in range(steps):
        f, g = value_and_grad(obj, x)
        better = f < best_f
        best_x = torch.where(better[..., None], x, best_x)
        best_f = torch.where(better, f, best_f)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / float(f32(1) - f32(0.9) ** f32(i + 1))
        vh = v / float(f32(1) - f32(0.999) ** f32(i + 1))
        step_lr = lr * float(f32(0.5) ** (f32(3.0) * f32(i) / f32(steps)))
        x = torch.clamp(x - step_lr * mh / (torch.sqrt(vh) + 1e-8), lo, hi)
    with torch.no_grad():
        f = obj(x)
    better = f < best_f
    return (torch.where(better[..., None], x, best_x),
            torch.where(better, f, best_f))


def _descent(fn, starts, steps, lr, lo, hi, args):
    with full_float32_matmul():
        return adam_minimize(lambda t: fn(t, *args), starts, steps, lr, lo,
                             hi)


#: captured descents, least recently used first; bounded, since each holds
#: its graph's memory pool and its static inputs
_GRAPHS = OrderedDict()
_GRAPHS_CAP = 8

#: replays of captured descents, for the launch counts of the smoke run
replays = 0


def descend(fn, starts, steps, lr, lo, hi, args=(), capture=None):
    """:func:`adam_minimize` of ``fn(theta, *args)`` from ``starts`` (S, d)
    within ``[lo, hi]``.  ``args`` is a tuple of tensors, dicts of tensors
    and Python numbers.

    With ``capture`` (default: on a CUDA device) the descent is a CUDA
    graph captured at the first call for this ``fn``, ``steps``, Python
    numbers and tensor shapes, and replayed after the inputs are copied
    into its static tensors; otherwise it runs eagerly.  A replay neither
    waits for the device nor copies from the host."""
    global replays
    if capture is None:
        capture = starts.device.type == "cuda"
    if not capture:
        return _descent(fn, starts, steps, lr, lo, hi, args)
    leaves, spec = tree_flatten((starts, lr, lo, hi, tuple(args)))
    key = (fn, steps, spec, tuple(
        (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
        else x for x in leaves))
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _capture(fn, steps, leaves, spec)
        _GRAPHS[key] = entry
        while len(_GRAPHS) > _GRAPHS_CAP:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(key)
    static, graph, out = entry
    for s, x in zip(static, leaves):
        if isinstance(s, torch.Tensor):
            s.copy_(x)
    graph.replay()
    replays += 1
    return out[0].clone(), out[1].clone()


def _capture(fn, steps, leaves, spec):
    """(static inputs, graph, static outputs) of one captured descent."""
    static = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in leaves]
    starts, lr, lo, hi, args = tree_unflatten(static, spec)
    device = starts.device
    # a warm-up on a side stream first, as CUDA graph capture asks: it
    # initialises the libraries' handles and workspaces outside the graph
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        _descent(fn, starts, steps, lr, lo, hi, args)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _descent(fn, starts, steps, lr, lo, hi, args)
    return static, graph, out


def _args_device(args):
    leaves, _ = tree_flatten(args)
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def minimize_traced(fn, bounds, args=(), n_starts=10, steps=150, lr=None,
                    seed=None, extra_starts=None, device=None):
    """Multi-start bounded minimization on the device.

    ``fn(theta, *args)`` maps rows ``theta`` (n, d) to their values (n,);
    per-call data goes through ``args``, so a stable ``fn`` reuses its
    captured descent (:func:`descend`).  The ``n_starts`` uniform starts
    come from a generator seeded with ``seed`` (the JAX package's
    ``key``).  Runs on the device of the tensors in ``args`` (else
    ``device``, else the global backend's).  Returns (x_min (d,), f_min) as
    numpy and a float.
    """
    bounds = np.asarray(bounds, np.float32)
    d = bounds.shape[0]
    lr = lr or float(np.max(bounds[:, 1] - bounds[:, 0]) / 10.0)
    device = _args_device(args) or resolve_device(device)
    lo = torch.as_tensor(bounds[:, 0], device=device)
    hi = torch.as_tensor(bounds[:, 1], device=device)
    if seed is None:
        seed = np.random.randint(2**31)
    starts = lo + (hi - lo) * torch.rand(
        (n_starts, d), generator=generator(int(seed), device), device=device)
    if extra_starts is not None:
        extra = torch.atleast_2d(torch.as_tensor(
            np.asarray(extra_starts), dtype=torch.float32, device=device))
        starts = torch.cat([starts, torch.clamp(extra, lo, hi)], dim=0)
    xs, fs = descend(fn, starts, steps, torch.tensor(lr, device=device), lo,
                     hi, args)
    fs = torch.where(torch.isfinite(fs), fs, math.inf)
    i = int(torch.argmin(fs))
    return xs[i].cpu().numpy(), float(fs[i])


def stochastic_optimization(fun, bounds, maxiter=1000, polish=True, seed=0):
    """Global minimum of ``fun`` by differential evolution (reference
    ``bo/utils.py:9-37``)."""

    def fun_1d(x):
        return np.asarray(fun(x)).ravel()

    result = differential_evolution(func=fun_1d, bounds=bounds,
                                    maxiter=maxiter, polish=polish,
                                    init="latinhypercube", seed=seed)
    return result.x, result.fun


def minimize(fun, bounds, method="L-BFGS-B", constraints=None, grad=None,
             prior=None, n_start_points=10, maxiter=1000, random_state=None):
    """Multi-start bounded minimization on the host (reference
    ``bo/utils.py:40-111``).  Start points are drawn from ``prior``
    (clipped to the bounds) or uniformly."""
    ndim = len(bounds)
    start_points = np.empty((n_start_points, ndim))
    if prior is None:
        random_state = random_state or np.random
        for i in range(ndim):
            start_points[:, i] = random_state.uniform(*bounds[i],
                                                      n_start_points)
    else:
        start_points = np.atleast_2d(prior.rvs(size=n_start_points,
                                               random_state=random_state))
        if start_points.ndim == 1:
            start_points = start_points[:, None]
        for i in range(ndim):
            start_points[:, i] = np.clip(start_points[:, i], *bounds[i])

    def as_floatfun(f):
        def wrapped(x):
            return np.asarray(f(x), np.float64).ravel()
        return wrapped

    fun_w = lambda x: float(np.asarray(fun(x)).ravel()[0])  # noqa: E731
    grad_w = as_floatfun(grad) if grad is not None else None

    locs, vals = [], np.empty(n_start_points)
    for i in range(n_start_points):
        result = scipy.optimize.minimize(fun_w, start_points[i],
                                         method=method, jac=grad_w,
                                         bounds=bounds,
                                         constraints=constraints,
                                         options={"maxiter": maxiter})
        locs.append(result["x"])
        vals[i] = result["fun"]

    ind_min = int(np.argmin(vals))
    loc = locs[ind_min]
    for i in range(ndim):
        loc[i] = np.clip(loc[i], *bounds[i])
    return loc, vals[ind_min]


class CostFunction:
    """Additive acquisition cost (reference ``bo/utils.py:114-164``).

    ``traceable`` (optional): a version of the cost on tensors, rows
    ``theta`` (n, d) -> (n,), for the device-side acquisition optimizer."""

    def __init__(self, function, gradient, scale=1, traceable=None):
        self.function = function
        self.gradient = gradient
        self.scale = scale
        self.traceable = traceable

    def evaluate(self, x):
        x = np.atleast_2d(x)
        n, _ = x.shape
        return self.scale * np.asarray(self.function(x)).reshape(n, 1)

    def evaluate_gradient(self, x):
        x = np.atleast_2d(x)
        n, input_dim = x.shape
        return self.scale * np.asarray(self.gradient(x)).reshape(n, input_dim)
