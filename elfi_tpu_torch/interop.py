"""Carry the JAX package's state into the port.

The system has no learned weights: its state is a model's observed arrays,
the rejection sampler's top-N sample buffer and SMC's populations.  The
first two are dicts of arrays;
:func:`from_numpy_state` turns such a dict, taken to numpy on the JAX side
(``jax.device_get(rej.state["samples"])``, including ``__key``, or
``model.observed``), into tensors on ``device``, so both packages can
compute from the same state.  An adaptive distance's state is a host-side
holder of weight vectors and Welford accumulators;
:func:`adaptive_state_from_numpy` carries the JAX node's holder into the
port's node.  :func:`population_from_numpy` turns one round's population of
a JAX ``SmcSample`` into a port ``Sample`` that can stand as
``SMC._populations[-1]``, the population the next round proposes from.
:func:`gp_from_numpy` builds BOLFI's GP surrogate from a JAX
``GPRegression``'s evidence and hyperparameters, so that both packages
predict from the same surrogate.  :func:`romc_solutions_from_numpy`
installs a JAX ``ROMC``'s solutions into a port ``ROMC``, so both build
regions, local fits and the posterior from the same optima.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_numpy_state", "adaptive_state_from_numpy",
           "population_from_numpy", "gp_from_numpy",
           "romc_solutions_from_numpy"]


def from_numpy_state(d, device):
    """``{name: array}`` -> ``{name: tensor on device}``, dtypes kept.  The
    tensors are copies: ``jax.device_get`` hands out read-only arrays."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in d.items()}


def adaptive_state_from_numpy(holder, node):
    """Load a JAX ``AdaptiveDistance`` holder (``node.adaptive_state`` of
    the JAX package: the ``w`` list, whose first entry is ``None``, and the
    Welford fields ``count``, ``mean``, ``m2`` and ``scale``) into the
    port's ``AdaptiveDistance`` ``node``, as float64 numpy copies, and
    return the node's holder.  The holder's version is bumped, not copied:
    programs compiled against the old weights go stale."""
    def f64(x):
        return np.array(x, np.float64)

    st = node.adaptive_state
    st["w"] = [None if w is None else f64(w) for w in holder["w"]]
    st["count"] = int(holder["count"])
    for k in ("mean", "m2", "scale"):
        if k in holder:
            st[k] = f64(holder[k])
        else:
            st.pop(k, None)
    node._bump_version()
    return st


def population_from_numpy(outputs, weights, cov, parameter_names,
                          discrepancy_name=None, **meta):
    """An SMC population for the port from numpy: the ``outputs``,
    ``weights`` and ``meta["cov"]`` of a JAX ``SmcSample.populations[r]``
    (``{k: np.asarray(v)}``, ``np.asarray(pop.weights)``,
    ``pop.meta["cov"]``).  The result carries ``means`` (the parameter
    matrix), ``weights`` and ``meta`` (``cov`` and any other ``meta``
    given, such as ``threshold`` and ``n_batches``), as the port's
    ``SMC._extract_population`` leaves them; the arrays are copies."""
    from .methods.results import Sample
    from .methods.utils import batch_to_arr2d
    outputs = {k: np.array(v) for k, v in outputs.items()}
    pop = Sample("Rejection within SMC-ABC", outputs, parameter_names,
                 discrepancy_name=discrepancy_name, weights=np.array(weights),
                 cov=np.array(cov, np.float64), **meta)
    pop.means = batch_to_arr2d(outputs, pop.parameter_names)
    return pop


def gp_from_numpy(X, y, params, bounds, *, device, prior_shapes=None):
    """A port ``GPRegression`` on ``device`` holding the evidence ``X`` (n,
    d) and ``y`` (n,) and the hyperparameters ``params`` of a JAX
    ``GPRegression`` (``gp.X``, ``gp.Y``, ``gp.params``, ``gp.bounds`` and
    optionally ``gp._prior_shapes``, as numpy), factored as the JAX GP's
    ``_refactor`` factors it."""
    from .methods.bo.gp import GPRegression
    X = np.asarray(X, np.float64)
    gp = GPRegression([f"x{i}" for i in range(X.shape[1])], bounds=bounds,
                      device=device)
    gp._x = X.copy()
    gp._y = np.asarray(y, np.float64).reshape(-1).copy()
    gp.params = {k: np.array(v, np.float32) if np.ndim(v) else float(v)
                 for k, v in params.items()}
    if prior_shapes is not None:
        gp._prior_shapes = np.array(prior_shapes, np.float64)
    gp._refactor()
    return gp


def romc_solutions_from_numpy(romc, x_min, f_min, hess):
    """Install solutions into the port ``ROMC`` ``romc`` after its
    ``_define_objectives``: ``x_min`` (n1, D), ``f_min`` (n1,) and ``hess``
    (n1, D, D), numpy, as the JAX package's problems hold them
    (``p.result.x_min``, ``p.result.f_min``, ``p.result.hess_appr``).
    Marks the problems solved as ``_solve_gradients`` does and returns
    ``romc``."""
    probs = romc.optim_problems
    if probs is None:
        raise ValueError("define the objectives first (_define_objectives)")
    x_min = np.asarray(x_min, np.float64).reshape(len(probs), -1)
    f_min = np.asarray(f_min, np.float64).reshape(len(probs))
    hess = np.asarray(hess, np.float64).reshape(
        len(probs), x_min.shape[1], x_min.shape[1])
    solved = [p.set_solution(x_min[i].copy(), f_min[i], hess[i].copy())
              for i, p in enumerate(probs)]
    romc.inference_state["solved"] = solved
    romc.inference_state["attempted"] = [True] * len(probs)
    romc.inference_state["_has_solved_problems"] = True
    return romc
