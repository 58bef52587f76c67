"""Model extensions: the joint prior over a model's parameters
(counterpart of :mod:`elfi_tpu.model.extensions`).

The prior sub-DAG is walked directly into ``rvs`` / ``logpdf`` /
``gradient_logpdf``: ``rvs`` runs the parameters' per-batch program, the
density is a plain function on tensors, and the gradient comes from
autograd.  A prior with host (scipy-adapter) distributions is evaluated
eagerly in float64 numpy, its gradient by central differences, and has no
``traceable_logpdf``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compile.compiler import compile_program
from ..parallel.backends import resolve_device
from ..ops.distributions import Distribution

__all__ = ["ModelPrior", "ScipyLikeDistribution"]

# API parity alias: elfi.Distribution == ScipyLikeDistribution in reference
ScipyLikeDistribution = Distribution


class ModelPrior:
    """Joint prior distribution over a model's parameter nodes.  Densities
    are evaluated in float32 on ``device`` (None: the global backend's)."""

    def __init__(self, model, parameter_names=None, device=None):
        model = model.model if hasattr(model, "model") and not hasattr(
            model, "dag") else model
        self.model = model.copy()
        self.parameter_names = list(parameter_names
                                    or self.model.parameter_names)
        self.dim = len(self.parameter_names)
        self.device = resolve_device(device)
        dag = self.model.dag
        self._order = dag.topological_order(self.parameter_names)
        self._states = {n: dag.get_state(n) for n in self._order}
        self._parents = {n: dag.parents(n) for n in self._order}
        #: whether a parameter (or an ancestor) is a host distribution
        self.host = any(
            st["kind"] == "rv" and getattr(st["distribution"], "host", False)
            for st in self._states.values())

    # -- sampling ---------------------------------------------------------------
    def rvs(self, size=1, seed=None, random_state=None):
        """Draw ``(size, dim)`` from the joint prior, as numpy: the
        parameters' program run at batch index 0 of the integer ``seed``."""
        if seed is None:
            rs = random_state if random_state is not None else np.random
            seed = int(rs.randint(0, 2**31 - 1))
        prog = compile_program(self.model, tuple(self.parameter_names),
                               device=self.device)
        out = prog.run(seed, 0, {}, batch_size=int(size))
        return np.column_stack([out[n].cpu().numpy().reshape(size, -1)
                                for n in self.parameter_names])

    def box(self):
        """``(lo, hi, logconst)`` numpy arrays/float if the joint prior is
        an independent uniform box over the parameters, else ``None``."""
        lo, hi, consts = {}, {}, {}
        logconst = 0.0
        pset = set(self.parameter_names)
        for name in self._order:
            st = self._states[name]
            if st["kind"] == "constant":
                consts[name] = st["value"]
                continue
            if st["kind"] != "rv" or name not in pset:
                return None
            if getattr(st["distribution"], "name", None) != "uniform":
                return None
            pv = []
            for p in self._parents[name]:
                v = consts.get(p)
                if v is None or np.ndim(v) != 0:
                    return None
                pv.append(float(v))
            loc = pv[0] if len(pv) > 0 else 0.0
            scale = pv[1] if len(pv) > 1 else 1.0
            if not (scale > 0.0):
                return None
            lo[name] = loc
            hi[name] = loc + scale
            logconst -= float(np.log(scale))
        if set(lo) != pset:
            return None
        return (np.asarray([lo[n] for n in self.parameter_names],
                           np.float32),
                np.asarray([hi[n] for n in self.parameter_names],
                           np.float32),
                float(logconst))

    # -- density ------------------------------------------------------------------
    def traceable_logpdf(self):
        """Function ``x (n, dim) tensor -> (n,)`` joint log-prior on
        ``x``'s device; named after the JAX package's method, it is what
        the SMC proposal and weights evaluate on the device.  A prior with
        host distributions has none (``ValueError``)."""
        if self.host:
            raise ValueError(
                "The prior contains host-path (scipy-adapter) "
                "distributions, which have no torch density. Use the "
                "port's distributions (or an elfi_tpu_torch.Distribution "
                "subclass) for methods that evaluate the prior on the "
                "device.")
        return self.tensor_logpdf()

    def tensor_logpdf(self):
        """Function ``x (n, dim) tensor -> (n,)`` joint log-prior on
        ``x``'s device: :meth:`traceable_logpdf`, except that a host
        distribution's density is evaluated in numpy on the way (so it has
        no gradient and waits for the device)."""
        order, states, parents = self._order, self._states, self._parents
        pindex = {n: i for i, n in enumerate(self.parameter_names)}

        def fn(x):
            vals = {}
            logp = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            for name in order:
                st = states[name]
                kind = st["kind"]
                if kind == "constant":
                    vals[name] = st["value"]
                elif kind == "rv":
                    if name not in pindex:
                        raise ValueError(
                            f"Prior density requires all stochastic ancestors "
                            f"of parameters to be parameters; {name!r} is not.")
                    xi = x[:, pindex[name]]
                    lp = st["distribution"].logpdf(
                        xi, *(vals[p] for p in parents[name]))
                    if not isinstance(lp, torch.Tensor):    # a host density
                        lp = torch.as_tensor(lp, dtype=x.dtype,
                                             device=x.device)
                    logp = logp + lp
                    vals[name] = xi
                elif kind in ("operation", "summary"):
                    vals[name] = st["op"](*(vals[p] for p in parents[name]))
                else:
                    raise ValueError(
                        f"Unsupported node kind {kind!r} in prior subgraph")
            return logp

        return fn

    def _as_x(self, x):
        return torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32,
                                                device=self.device))

    def logpdf(self, x):
        """Joint log-prior of ``x`` (n, dim) as numpy float32 (float64 for
        a host prior); a single row gives a scalar, as in the JAX
        package."""
        x = torch.atleast_2d(torch.as_tensor(np.asarray(x, np.float64))) \
            if self.host else self._as_x(x)
        lp = self.tensor_logpdf()(x).cpu().numpy()
        return lp.squeeze() if x.shape[0] == 1 else lp

    def pdf(self, x):
        return np.exp(self.logpdf(x))

    def gradient_logpdf(self, x):
        """(n, dim) gradient of the joint log-prior by autograd (a host
        prior: central differences); zero (not nan) outside the support,
        as in the reference."""
        if self.host:
            x = np.atleast_2d(np.asarray(x, np.float64))
            g = np.stack([self.numerical_gradient_logpdf(row) for row in x])
            return np.where(np.isfinite(g), g.reshape(x.shape), 0.0)
        x = self._as_x(x).requires_grad_(True)
        lp = self.tensor_logpdf()(x).sum()
        # a density that is constant in x (uniform priors) has no graph
        g = torch.autograd.grad(lp, x)[0] if lp.requires_grad \
            else torch.zeros_like(x)
        g = g.cpu().numpy()
        return np.where(np.isfinite(g), g, 0.0)

    def numerical_gradient_logpdf(self, x):
        from ..methods.utils import numgrad
        return numgrad(lambda xx: float(np.sum(self.logpdf(xx[None]))),
                       np.asarray(x))
