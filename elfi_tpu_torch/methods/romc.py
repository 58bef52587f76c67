"""ROMC: Robust Optimisation Monte Carlo (counterpart of
:mod:`elfi_tpu.methods.romc`; reference ``elfi/methods/inference/romc.py``
and ``posteriors.py:393-795``).

ROMC draws n1 nuisance realisations, turns each into a deterministic
objective ``d^2(theta; u_i)``, minimises every one, keeps the optima below
a threshold, builds a bounding box around each (line searches along the
Hessian's eigenvectors) and samples the posterior by importance sampling
inside the boxes.

How the port holds the nuisance fixed.  The JAX package calls its program
at batch size 1 with a frozen key per problem and ``vmap``s that over
problems.  The port's program seeds a generator per stochastic node from
``(seed, batch_index, node)`` on every call, so two calls at the same
``(seed, batch_index)`` draw the same noise: row i of the program at batch
n1, called at ``(seed_obj, 0)``, is problem i's objective.  So:

- one evaluation of all n1 problems is one program call, each problem's
  theta in its row; S restarts are S calls at the same ``(seed_obj, 0)``,
  so they share each problem's noise as the JAX restarts share its key;
- the rows are independent, so the gradient of the row sum is every
  problem's gradient (autograd), and D double-backward passes of it give
  every problem's Hessian;
- all n1 x S descents are one eager :func:`.bo.utils.adam_minimize`; the
  program makes its generators on the host per call, so it is not
  captured as a CUDA graph;
- the line searches over (problems x 2D eigen-directions) are one masked
  loop that reads "any pair still stepping" on the host once an
  iteration, and the posterior evaluates every region at a point index in
  one program call.

A graph whose discrepancy has no gradient (the fused distance kernels
have no backward) is refused with a ``ValueError``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..compile.compiler import compile_program
from ..model.extensions import ModelPrior
from ..parallel.backends import resolve_device
from ..utils import get_sub_seed, random_seed
from ..utils.rng import fold_in, generator as make_generator
from .base import ParameterInference, _ProgressBar
from .bo.gp import full_float32_matmul
from .bo.utils import adam_minimize
from .results import RomcSample
from .utils import compute_ess

logger = logging.getLogger(__name__)

__all__ = ["ROMC", "OptimisationProblem", "RomcOptimisationResult",
           "NDimBoundingBox", "RegionConstructor", "RomcPosterior",
           "line_search"]

#: salt of the objectives' program seed, folded into the solve's seed
_OBJECTIVE_SALT = 0x120C
#: salt of the local fits' box draws, as the JAX package's ``1000 + i``
_LOCAL_FIT_SALT = 1000


# ---------------------------------------------------------------------------
# deterministic objectives
# ---------------------------------------------------------------------------

class DeterministicObjective:
    """The frozen-noise distances ``d^2(theta; u_i)`` of all n1 problems
    (reference ``romc.py:562-592``): row i of the program at batch n1,
    called at ``(seed, 0)``."""

    def __init__(self, model, discrepancy_name, parameter_names, *, device):
        self.model = model
        self.discrepancy_name = discrepancy_name
        self.parameter_names = list(parameter_names)
        self.dim = len(self.parameter_names)
        self.device = torch.device(device)
        self._prog = compile_program(model, (discrepancy_name,),
                                     override_names=tuple(parameter_names),
                                     device=self.device)
        self.n1 = None
        self.seed = None
        self._fn = None

    def freeze(self, n1, seed):
        """Fix the number of problems and the program seed of their
        noise."""
        self.n1 = int(n1)
        self.seed = int(seed)
        self._fn = self._prog.traceable(self.n1)

    def __call__(self, theta):
        """``theta`` (n1, D), row i problem i's point -> the n1 squared
        distances (n1,), float32; differentiable."""
        overrides = {name: theta[:, j]
                     for j, name in enumerate(self.parameter_names)}
        out = self._fn(self.seed, 0, overrides)[self.discrepancy_name]
        d = out.reshape(self.n1, -1)[:, -1]
        return d.to(torch.float32) ** 2

    def at(self, rows, theta):
        """Problem ``rows[p]``'s objective at ``theta[p, j]`` for every
        pair p and point index j: ``theta`` (P, m, D) -> (P, m).  One
        program call per j while ``rows`` has no repeats (else one per
        repeat layer).  No gradient."""
        rows = np.asarray(rows, np.int64)
        P, m, _ = theta.shape
        out = torch.empty((P, m), dtype=torch.float32, device=theta.device)
        with torch.no_grad():
            for layer in _distinct_layers(rows):
                sel = torch.as_tensor(layer, device=theta.device)
                idx = torch.as_tensor(rows[layer], device=theta.device)
                for j in range(m):
                    pts = theta[sel, j]
                    base = pts[0].expand(self.n1, self.dim).clone()
                    base[idx] = pts
                    out[sel, j] = self(base)[idx]
        return out

    def row_fn(self, ind):
        """Problem ``ind``'s objective as a function of points ``(..., D)
        -> (...)``, one program call per point (every row at the point);
        differentiable."""
        def fn(theta):
            flat = theta.reshape(-1, self.dim)
            vals = [self(t.expand(self.n1, self.dim))[ind] for t in flat]
            return torch.stack(vals).reshape(theta.shape[:-1])
        return fn


def _distinct_layers(rows):
    """Split the positions of ``rows`` into layers without a repeated
    row: each layer is one program call per point index."""
    layers, seen = [], []
    for p, r in enumerate(rows):
        for layer, used in zip(layers, seen):
            if r not in used:
                layer.append(p)
                used.add(r)
                break
        else:
            layers.append([p])
            seen.append({r})
    return [np.asarray(layer) for layer in layers]


def _differentiable(fn, theta, discrepancy_name):
    """``(t, fn(t))`` with ``t`` a copy of ``theta`` that requires grad;
    raises unless the value depends differentiably on ``t`` (without a
    gradient the descents would hand the starts back as solutions)."""
    with torch.enable_grad():
        t = theta.detach().requires_grad_(True)
        f = fn(t)
    if not f.requires_grad:
        raise ValueError(
            f"ROMC needs the gradient of the discrepancy "
            f"{discrepancy_name!r} with respect to the parameters, and this "
            "graph gives none (a fused distance kernel has no backward); "
            "use the plain graph of the model")
    return t, f


def _hessian(fn, x, discrepancy_name):
    """Hessians of ``fn`` (rows (n, D) -> (n,), independent rows) at the
    rows of ``x``: (n, D, D), by D double-backward passes of the row-summed
    gradient."""
    D = x.shape[-1]
    t, f = _differentiable(fn, x, discrepancy_name)
    with torch.enable_grad():
        g, = torch.autograd.grad(f.sum(), t, create_graph=True)
        rows = []
        for d in range(D):
            h = None
            if g.requires_grad:
                h, = torch.autograd.grad(g[:, d].sum(), t, retain_graph=True,
                                         allow_unused=True)
            rows.append(torch.zeros_like(t) if h is None else h)
    return torch.stack(rows, dim=1).detach()


def line_search(f, th_star, vd, eps, K=10, eta=1., rep_lim=300):
    """Offset along ``vd`` where ``f`` first reaches ``eps``, with K
    halving refinements (reference ``romc.py:1971-2015``), for every pair
    of rows of ``th_star`` and ``vd`` (..., D) at once: ``f`` maps points
    (..., D) to values (...).  Returns the offsets (...).

    Per pair, as the JAX package's: refinement k steps by ``eta / 2^k``
    while ``f < eps`` and at most ``rep_lim + 1`` times, then steps back
    once; a pair that used up its steps skips the later refinements; an
    offset <= 0 becomes the last step length.  The pairs run as one masked
    loop whose "any pair still stepping" is read on the host once an
    iteration."""
    th = torch.as_tensor(th_star, dtype=torch.float32)
    vd = torch.as_tensor(vd, dtype=torch.float32, device=th.device)
    th, vd = torch.broadcast_tensors(th, vd)
    th = th.clone()
    shape = th.shape[:-1]
    eps = float(np.float32(eps))
    offset = torch.zeros(shape, dtype=torch.float32, device=th.device)
    eta_k = torch.full(shape, float(np.float32(eta)), dtype=torch.float32,
                       device=th.device)
    hit = torch.zeros(shape, dtype=torch.bool, device=th.device)
    with torch.no_grad():
        for _ in range(K):
            live = ~hit
            rep = torch.zeros(shape, dtype=torch.int32, device=th.device)
            going = live
            while True:
                going = going & (f(th) < eps) & (rep <= rep_lim)
                if not bool(going.any()):
                    break
                th = torch.where(going[..., None], th + eta_k[..., None] * vd,
                                 th)
                offset = torch.where(going, offset + eta_k, offset)
                rep = rep + going.to(torch.int32)
            th = torch.where(live[..., None], th - eta_k[..., None] * vd, th)
            offset = torch.where(live, offset - eta_k, offset)
            hit = hit | (live & (rep > rep_lim))
            eta_k = torch.where(live, eta_k / 2, eta_k)
    return torch.where(offset <= 0, eta_k, offset)


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------

class NDimBoundingBox:
    """Eigenvector-aligned bounding box around an optimum (reference
    ``romc.py:1655-1849``)."""

    def __init__(self, rotation, center, limits):
        rotation = np.atleast_2d(np.asarray(rotation, float))
        center = np.atleast_1d(np.asarray(center, float))
        limits = np.asarray(limits, float).reshape(-1, 2)
        assert center.shape[0] == rotation.shape[0] == rotation.shape[1]
        self.dim = rotation.shape[0]
        self.rotation = rotation
        self.center = center
        self.limits = self._secure_limits(limits)
        self.rotation_inv = np.linalg.inv(self.rotation)
        self.volume = float(np.prod(self.limits[:, 1] - self.limits[:, 0]))

    @staticmethod
    def _secure_limits(limits):
        limits = limits.astype(float)
        eps = .001
        for i in range(limits.shape[0]):
            limits[i, 0] = min(limits[i, 0], 0.0)
            limits[i, 1] = max(limits[i, 1], 0.0)
            if np.isclose(limits[i, 0], limits[i, 1], atol=eps):
                limits[i, 0] -= eps / 2
                limits[i, 1] += eps / 2
        return limits

    def contains(self, point):
        v = self.rotation_inv @ (np.asarray(point) - self.center)
        return bool(np.all((v >= self.limits[:, 0])
                           & (v <= self.limits[:, 1])))

    def sample(self, n2, seed=None, generator=None):
        """``n2`` uniform points of the box, (n2, dim) float32 numpy, from
        ``generator`` (else a CPU generator seeded with ``seed``)."""
        if generator is None:
            generator = make_generator(seed if seed is not None
                                       else random_seed(), "cpu")
        u = torch.rand((n2, self.dim), generator=generator,
                       device=generator.device)
        lo = torch.as_tensor(self.limits[:, 0], dtype=torch.float32,
                             device=u.device)
        hi = torch.as_tensor(self.limits[:, 1], dtype=torch.float32,
                             device=u.device)
        rot = torch.as_tensor(self.rotation, dtype=torch.float32,
                              device=u.device)
        center = torch.as_tensor(self.center, dtype=torch.float32,
                                 device=u.device)
        with full_float32_matmul():
            box = lo + u * (hi - lo)
            return (box @ rot.T + center).cpu().numpy()

    def pdf(self, theta):
        return self.contains(theta) / self.volume

    def plot(self, samples):
        import matplotlib.pyplot as plt
        plt.figure()
        samples = np.atleast_2d(samples)
        if self.dim == 1:
            plt.plot(samples[:, 0], np.zeros(len(samples)), "bo")
        else:
            plt.plot(samples[:, 0], samples[:, 1], "bo")
        plt.plot(*np.atleast_1d(self.center)[:2], "ro")


class RegionConstructor:
    """Builds the bounding box via eigenvector line searches (reference
    ``romc.py:1851-1968``).  ``func`` maps points (..., D) to values
    (...); the searches run on ``device`` (None: the global backend's)."""

    def __init__(self, result, func, dim, eps_region, K=10, eta=1.,
                 rep_lim=300, device=None):
        self.res = result
        self.func = func
        self.dim = dim
        self.eps_region = eps_region
        self.K = K
        self.eta = eta
        self.rep_lim = rep_lim
        self.device = resolve_device(device)

    @staticmethod
    def _find_rotation(hess_appr):
        dim = hess_appr.shape[0]
        if not np.all(np.isfinite(hess_appr)) or \
                np.linalg.matrix_rank(hess_appr) != dim:
            return np.eye(dim)
        eig_val, eig_vec = np.linalg.eigh((hess_appr + hess_appr.T) / 2)
        if not np.all(np.isfinite(eig_vec)) or \
                np.linalg.matrix_rank(eig_vec) < dim:
            return np.eye(dim)
        return eig_vec

    def build(self):
        """One box: the 2D directions (-v_d, then +v_d) searched as one
        masked loop."""
        theta0 = np.asarray(self.res.x_min, float)
        rotation = self._find_rotation(np.asarray(self.res.hess_appr))
        rot_t = rotation.T.astype(np.float32)
        dirs = torch.as_tensor(np.concatenate([-rot_t, rot_t]),
                               device=self.device)
        th0 = torch.as_tensor(theta0, dtype=torch.float32,
                              device=self.device).expand_as(dirs)
        off = line_search(self.func, th0, dirs, self.eps_region, self.K,
                          self.eta, self.rep_lim).cpu().numpy()
        D = self.dim
        limits = np.stack([-off[:D], off[D:]], axis=1).astype(float)
        return [NDimBoundingBox(rotation, theta0, limits)]


# ---------------------------------------------------------------------------
# per-problem container (API parity with the reference OptimisationProblem)
# ---------------------------------------------------------------------------

class RomcOptimisationResult:
    def __init__(self, x_min, f_min, hess_appr, jac=None, hess=None,
                 hess_inv=None):
        self.x_min = np.atleast_1d(np.asarray(x_min, float))
        self.f_min = float(f_min)
        self.hess_appr = np.asarray(hess_appr, float)
        self.jac = jac
        self.hess = hess
        self.hess_inv = hess_inv


class OptimisationProblem:
    """One deterministic optimisation problem (reference
    ``romc.py:1326-1631``): row ``ind`` of the shared objective."""

    def __init__(self, ind, nuisance, parameter_names, target_name,
                 objective, dim, prior, n1, bounds):
        self.ind = ind
        self.nuisance = nuisance          # integer seed (API parity)
        self.objective = objective        # host callable theta -> float
        self.dim = dim
        self.bounds = bounds
        self.parameter_names = parameter_names
        self.target_name = target_name
        self.prior = prior
        self.n1 = n1
        self.state = {"attempted": False, "solved": False,
                      "has_fit_surrogate": False,
                      "has_fit_local_surrogates": False,
                      "has_built_region_with_surrogate": False,
                      "region": False}
        self.bo_process = None
        self.surrogate = None
        self.local_surrogates = None
        self.result = None
        self.regions = None
        self.eps_region = None
        self.initial_point = None
        # the shared DeterministicObjective, set by ROMC
        self._traceable = None

    @property
    def device(self):
        return self._traceable.device

    def _objective_fn(self):
        """This problem's objective on points (..., D) -> (...)."""
        return self._traceable.row_fn(self.ind)

    def _box_generator(self, i):
        """The CPU generator of region ``i``'s local-fit draws."""
        return make_generator(fold_in(self.nuisance, _LOCAL_FIT_SALT + i),
                              "cpu")

    def set_solution(self, x_min, f_min, hess_appr, x0=None):
        self.result = RomcOptimisationResult(x_min, f_min, hess_appr)
        self.initial_point = x0
        self.state["attempted"] = True
        self.state["solved"] = bool(np.isfinite(f_min))
        return self.state["solved"]

    def solve_gradients(self, **kwargs):
        """Solve this problem alone with Adam (the batched path in
        ROMC._solve_gradients is preferred)."""
        seed = kwargs.get("seed") or 0
        x0 = kwargs.get("x0")
        if x0 is None:
            x0 = np.asarray(self.prior.rvs(size=self.n1,
                                           seed=seed))[self.ind]
        steps = kwargs.get("steps", 300)
        lr = kwargs.get("lr", 0.1)
        fn = self._objective_fn()
        lo, hi = _bounds_arrays(self.bounds, self.dim, self.device)
        start = torch.as_tensor(np.asarray(x0, np.float32).reshape(1, -1),
                                device=self.device)
        _differentiable(fn, start, self.target_name)
        with full_float32_matmul():
            x, f = adam_minimize(fn, start, steps, lr, lo, hi)
            hess = _hessian(fn, x, self.target_name)[0]
        return self.set_solution(x[0].cpu().numpy(), float(f[0]),
                                 hess.cpu().numpy(), x0)

    def solve_bo(self, **kwargs):
        """Solve with deterministic Bayesian optimisation (reference
        ``romc.py:1446-1500``)."""
        from .bo.acquisition import LCBSC
        from .bo.gp import GPRegression
        from .bo.utils import stochastic_optimization

        n_evidence = kwargs.get("n_evidence", 20)
        acq_noise_var = kwargs.get("acq_noise_var", 0.1)
        seed = kwargs.get("seed") or 0
        bounds = self.bounds if self.bounds is not None else \
            [(0, 1)] * self.dim
        gp = GPRegression(self.parameter_names, bounds=list(bounds),
                          device=self.device)
        acq = LCBSC(gp, prior=self.prior, noise_var=acq_noise_var,
                    seed=int(seed) + self.ind)
        n_init = max(5, n_evidence // 3)
        x_init = np.asarray(self.prior.rvs(
            size=n_init, seed=int(seed) + 7919 * (self.ind + 1)))
        x_init = np.clip(x_init, [b[0] for b in bounds],
                         [b[1] for b in bounds])
        y_init = np.array([self.objective(x) for x in x_init])
        gp.update(x_init, y_init, optimize=True)
        for t in range(n_evidence - n_init):
            x_new = acq.acquire(1, t=t)
            y_new = np.array([self.objective(x) for x in x_new])
            gp.update(x_new, y_new, optimize=(t % 5 == 4))

        pred = gp.device_predict(noiseless=True)
        dim = self.dim

        def surrogate_t(theta):
            return pred(theta.reshape(-1, dim))[0].reshape(theta.shape[:-1])

        self.surrogate = lambda theta: float(surrogate_t(torch.as_tensor(
            np.asarray(theta, np.float32).reshape(dim),
            device=self.device)))
        self._surrogate_traceable = surrogate_t
        self.bo_process = gp
        x_min, _ = stochastic_optimization(gp.predict_mean, gp.bounds,
                                           seed=int(seed))
        x = torch.as_tensor(np.asarray(x_min, np.float32).reshape(1, -1),
                            device=self.device)
        hess = _hessian(self._objective_fn(), x, self.target_name)[0]
        solved = self.set_solution(x_min, self.objective(x_min),
                                   hess.cpu().numpy())
        self.state["has_fit_surrogate"] = True
        return solved

    def build_region(self, **kwargs):
        """Bounding box via line search (reference ``romc.py:1502-1548``)."""
        assert self.state["solved"]
        use_surrogate = kwargs.get("use_surrogate",
                                   self.state["has_fit_surrogate"])
        if use_surrogate:
            assert self.surrogate is not None
            func = self._surrogate_traceable
            self.state["has_built_region_with_surrogate"] = True
        else:
            func = self._objective_fn()
        eps_region = kwargs["eps_region"]
        self.eps_region = eps_region
        constructor = RegionConstructor(
            self.result, func, self.dim, eps_region=eps_region,
            K=kwargs.get("K", 10), eta=kwargs.get("eta", 1.),
            rep_lim=kwargs.get("rep_lim", 300), device=self.device)
        self.regions = constructor.build()
        self.state["region"] = True
        return True

    def fit_local_surrogate(self, **kwargs):
        """Quadratic least-squares fit inside each region (reference
        ``romc.py:1550-1595``), with the minimum-norm solution."""
        nof_samples = kwargs.get("nof_samples", 20)
        use_surrogate = kwargs.get("use_surrogate", False)
        if use_surrogate and self.surrogate is not None:
            objective_t = self._surrogate_traceable
        else:
            objective_t = self._objective_fn()
        local = []
        self._local_coeffs = []
        for i, region in enumerate(self.regions):
            x = torch.as_tensor(region.sample(
                nof_samples, generator=self._box_generator(i)),
                device=self.device)
            with torch.no_grad():
                y = objective_t(x)
            coef = _lstsq_min_norm(_quad_features(x), y).cpu().numpy()
            self._local_coeffs.append(coef)
            local.append(_make_local_surrogate(coef))
        self.local_surrogates = local
        self.state["has_fit_local_surrogates"] = True
        self.state["local_surrogates"] = True

    def visualize_region(self, force_objective=False, samples=None,
                         savefig=None):
        import matplotlib.pyplot as plt
        if not self.state["region"]:
            logger.warning("Problem %d has no region", self.ind)
            return
        region = self.regions[0]
        func = self.objective if (force_objective or self.surrogate is None) \
            else self.surrogate
        if self.dim == 1:
            xs = np.linspace(region.center[0] + region.limits[0, 0] - .2,
                             region.center[0] + region.limits[0, 1] + .2, 30)
            ys = [func(np.atleast_1d(x)) for x in xs]
            plt.figure()
            plt.plot(xs, ys, "r--")
            plt.axvspan(region.center[0] + region.limits[0, 0],
                        region.center[0] + region.limits[0, 1], alpha=.3)
            plt.axhline(self.eps_region, color="g")
        else:
            region.plot(samples if samples is not None
                        else region.sample(50, seed=0))
        if savefig:
            plt.savefig(savefig, bbox_inches="tight")


def _quad_features(x):
    """[1, x_i, x_i x_j (i<=j)] feature matrix for quadratic fits:
    ``x`` (..., n, d) -> (..., n, 1 + d + d (d + 1) / 2)."""
    x = torch.as_tensor(x)
    d = x.shape[-1]
    cols = [torch.ones_like(x[..., :1]), x]
    for i in range(d):
        for j in range(i, d):
            cols.append((x[..., i] * x[..., j])[..., None])
    return torch.cat(cols, dim=-1)


def _lstsq_min_norm(feats, y):
    """The minimum-norm least-squares coefficients of ``feats`` (..., n, F)
    against ``y`` (..., n), as numpy's and JAX's ``lstsq`` give them, also
    where F > n: the pseudo-inverse by SVD (cut at ``eps * max(n, F)`` of
    the largest singular value), on either device.  CUDA's
    ``torch.linalg.lstsq`` has only the ``gels`` driver, which assumes full
    rank."""
    with full_float32_matmul():
        return (torch.linalg.pinv(feats) @ y[..., None])[..., 0]


def _make_local_surrogate(coef):
    coef = np.asarray(coef, np.float32)

    def fn(theta):
        theta = np.atleast_1d(np.asarray(theta, np.float32))
        feats = _quad_features(torch.as_tensor(theta)[None])[0].numpy()
        return float(feats @ coef)
    return fn


def _bounds_arrays(bounds, dim, device="cpu"):
    """(lo, hi) float32 tensors on ``device``; unbounded without
    ``bounds``."""
    if bounds is None:
        return (torch.full((dim,), -np.inf, device=device),
                torch.full((dim,), np.inf, device=device))
    b = np.asarray(bounds, np.float32)
    return (torch.as_tensor(b[:, 0], device=device),
            torch.as_tensor(b[:, 1], device=device))


def _stack_factors(gps):
    """The GP factors of ``gps`` stacked over a leading region axis:
    (X (R, cap, D), mask (R, cap), alpha (R, cap), params), each
    hyperparameter (R, 1, 1) or (R, 1, k), as a custom kernel takes them."""
    factors = [g._factor for g in gps]
    X = torch.stack([f[0] for f in factors])
    mask = torch.stack([f[1] for f in factors])
    alpha = torch.stack([f[3] for f in factors])
    R = len(factors)
    params = {k: torch.stack([f[4][k] for f in factors]).reshape(R, 1, -1)
              for k in factors[0][4]}
    return X, mask, alpha, params


def _surrogate_means(fns, aux, theta):
    """Region r's GP mean at ``theta[r, j]``: ``theta`` (R, m, D) -> (R, m)
    (the mean of ``predict_noiseless``, ``k(theta, X) alpha``)."""
    X, mask, alpha, params = aux
    with torch.no_grad(), full_float32_matmul():
        kx = fns.kernel(theta, X, params) * mask[:, None, :]
        return (kx @ alpha[..., None])[..., 0]


# ---------------------------------------------------------------------------
# posterior
# ---------------------------------------------------------------------------

class RomcPosterior:
    """ROMC posterior: prior x (sum of region indicators), evaluated for
    every region at once (reference ``posteriors.py:393-795``).

    The region objectives are the problems' rows of ``traceable_objective``
    (``rows``: the problem of each region), the local quadratic fits
    (``local_coeffs``) or the stacked GP surrogates (``surrogate_fns`` and
    ``surrogate_aux``).  ``mesh`` is accepted and ignored: one device.
    ``prior=None`` puts the posterior on the global backend's device."""

    def __init__(self, regions, objectives, objectives_actual=None,
                 objectives_surrogate=None, objectives_local=None,
                 nuisance=None, surrogate_used=False, prior=None,
                 left_lim=None, right_lim=None, eps_filter=None,
                 eps_region=None, eps_cutoff=None, parallelize=False,
                 traceable_objective=None, rows=None, local_coeffs=None,
                 surrogate_fns=None, surrogate_aux=None, mesh=None):
        self.regions = regions
        self.funcs = objectives
        self.objectives_actual = objectives_actual
        self.objectives_surrogate = objectives_surrogate
        self.objectives_local = objectives_local
        self.nuisance = nuisance
        self.surrogate_used = surrogate_used
        self.prior = prior
        self.left_lim = left_lim
        self.right_lim = right_lim
        self.eps_filter = eps_filter
        self.eps_region = eps_region
        self.eps_cutoff = eps_cutoff
        self.dim = prior.dim if prior is not None else None
        self.partition = None
        self.device = prior.device if prior is not None else \
            resolve_device(None)
        self._tr_obj = traceable_objective
        self._rows = None if rows is None else np.asarray(rows, np.int64)
        self._local_coeffs = None if local_coeffs is None else \
            torch.as_tensor(np.stack(local_coeffs), dtype=torch.float32,
                            device=self.device)
        self._surrogate_fns = surrogate_fns
        self._surrogate_aux = surrogate_aux

    # -- every region's objective ---------------------------------------------
    def _region_distances(self, thetas):
        """Region r's distance at ``thetas[r, j]``: (R, m, D) -> (R, m);
        the objective costs one program call per point index j."""
        if self._local_coeffs is not None:
            return torch.einsum("rmf,rf->rm", _quad_features(thetas),
                                self._local_coeffs)
        if self._surrogate_aux is not None:
            return _surrogate_means(self._surrogate_fns,
                                    self._surrogate_aux, thetas)
        return self._tr_obj.at(self._rows, thetas)

    def _distances(self, thetas):
        """(n, D) tensor -> (n, R) distances under every region's
        objective."""
        R = len(self.regions)
        return self._region_distances(
            thetas[None].expand(R, *thetas.shape)).T

    def _distances_traceable(self, theta):
        """theta (D,) -> distances under every region's objective (R,)."""
        return self._distances(theta[None])[0]

    def _tensor(self, x):
        """``x`` (a tensor, or an array, copied) as float32 on the
        posterior's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.array(x, np.float32), device=self.device)

    def _as_thetas(self, thetas):
        return self._tensor(thetas).reshape(-1, self.dim)

    def _indicator_counts(self, thetas):
        """(n, D) -> number of regions accepting each point."""
        d = self._distances(self._as_thetas(thetas))
        eps = float(np.float32(self.eps_cutoff))
        return torch.sum(d <= eps, dim=1).cpu().numpy()

    def _all_distances(self, thetas):
        """(n, D) -> (n, R) distances under every region objective."""
        return self._distances(self._as_thetas(thetas)).cpu().numpy()

    # -- pdf ------------------------------------------------------------------
    def pdf_unnorm_batched(self, theta):
        theta = np.atleast_2d(np.asarray(theta, np.float32))
        pr = np.asarray(self.prior.pdf(theta)).ravel()
        if self.surrogate_used:
            inside = np.array([[r.contains(t) for r in self.regions]
                               for t in theta])
            d = self._all_distances(theta)
            counts = np.sum(inside & (d <= self.eps_cutoff), axis=1)
        else:
            counts = self._indicator_counts(theta)
        return pr * counts

    def _approximate_partition(self, nof_points=30):
        assert self.dim <= 2, "partition approximation only for dim <= 2"
        grids = [np.linspace(self.left_lim[i], self.right_lim[i], nof_points)
                 for i in range(self.dim)]
        mesh = np.stack(np.meshgrid(*grids), -1).reshape(-1, self.dim)
        vol = np.prod((np.asarray(self.right_lim)
                       - np.asarray(self.left_lim)) / nof_points)
        self.partition = float(np.sum(self.pdf_unnorm_batched(mesh) * vol))
        return self.partition

    def pdf(self, theta):
        if self.partition is None:
            self._approximate_partition()
        return self.pdf_unnorm_batched(theta) / self.partition

    def reset_eps_cutoff(self, eps_cutoff):
        self.eps_cutoff = eps_cutoff
        self.partition = None

    # -- sampling -------------------------------------------------------------
    def sample(self, n2, seed=None):
        """n2 importance samples per region: uniform box points from one
        generator seeded with ``seed`` on the posterior's device.

        Returns (thetas (R, n2, D), weights (R, n2), distances (R*n2,)),
        numpy."""
        if seed is None:
            seed = random_seed()
        R = len(self.regions)
        dev = self.device

        def stacked(values):
            return torch.as_tensor(np.stack(values), dtype=torch.float32,
                                   device=dev)

        rot = stacked([r.rotation for r in self.regions])
        center = stacked([r.center for r in self.regions])
        lims = stacked([r.limits for r in self.regions])
        u = torch.rand((R, n2, self.dim),
                       generator=make_generator(int(seed), dev), device=dev)
        with full_float32_matmul():
            box = lims[:, None, :, 0] + u * (lims[:, None, :, 1]
                                             - lims[:, None, :, 0])
            thetas = torch.einsum("rij,rnj->rni", rot, box) \
                + center[:, None, :]
        w, dists = self._weights(thetas)
        return thetas.cpu().numpy(), w, dists.flatten()

    def _weights(self, thetas):
        """Importance weights ``1[d < eps] * prior pdf * box volume`` and
        distances of the box points ``thetas`` (R, n2, D), as float32
        numpy (R, n2) each."""
        thetas = self._tensor(thetas)
        R, n2, D = thetas.shape
        dists = self._region_distances(thetas).cpu().numpy()
        pr = np.asarray(self.prior.pdf(thetas.reshape(-1, D).cpu().numpy()),
                        np.float32).reshape(R, n2)
        vols = np.asarray([r.volume for r in self.regions], np.float32)
        ind = (dists < np.float32(self.eps_cutoff)).astype(np.float32)
        return ind * pr * vols[:, None], dists

    def compute_expectation(self, h, theta, w):
        h_theta = h(theta)
        return np.sum(h_theta * w) / np.sum(w)


# ---------------------------------------------------------------------------
# the inference method
# ---------------------------------------------------------------------------

class ROMC(ParameterInference):
    """Robust Optimisation Monte Carlo (reference ``romc.py:424-1323``)."""

    def __init__(self, model, bounds=None, discrepancy_name=None,
                 output_names=None, custom_optim_class=None,
                 parallelize=False, **kwargs):
        model, discrepancy_name = self._resolve_model(model,
                                                      discrepancy_name)
        output_names = [discrepancy_name] + model.parameter_names + \
            (output_names or [])
        super().__init__(model, output_names, **kwargs)
        self.discrepancy_name = discrepancy_name
        self.model_prior = ModelPrior(self.model, device=self.device)
        self.dim = self.model_prior.dim
        if isinstance(bounds, dict):  # reference accepts a name-keyed dict
            bounds = [bounds[p] for p in self.model.parameter_names]
        self.bounds = bounds
        self.left_lim = np.array([b[0] for b in bounds], float) \
            if bounds is not None else None
        self.right_lim = np.array([b[1] for b in bounds], float) \
            if bounds is not None else None

        self.inference_state = {
            "_has_gen_nuisance": False, "_has_defined_problems": False,
            "_has_solved_problems": False,
            "_has_fitted_surrogate_model": False,
            "_has_filtered_solutions": False,
            "_has_fitted_local_models": False,
            "_has_estimated_regions": False,
            "_has_defined_posterior": False, "_has_drawn_samples": False,
            "attempted": None, "solved": None, "accepted": None,
            "computed_BB": None}
        self.inference_args = {"parallelize": parallelize}
        self.custom_optim_class = custom_optim_class
        self.optim_problems = None
        self.posterior = None
        self.samples = None
        self.weights = None
        self.distances = None
        self.result = None
        self._objective = DeterministicObjective(
            self.model, discrepancy_name, self.parameter_names,
            device=self.device)

    # -- objectives -----------------------------------------------------------
    def _define_objectives(self, n1, seed=None):
        """The n1 problems: the JAX package's integer nuisances (API
        parity), and the objective's program seed from ``seed``."""
        nuisance = np.random.RandomState(seed).randint(
            1, 2**31 - 1, size=n1)
        self._objective.freeze(n1, fold_in(
            int(seed) if seed is not None else random_seed(),
            _OBJECTIVE_SALT))
        self.inference_state["_has_gen_nuisance"] = True
        self.inference_args["N1"] = n1
        self.inference_args["initial_seed"] = seed

        problems = []
        for ind, nu in enumerate(nuisance):
            cls = self.custom_optim_class or OptimisationProblem
            prob = cls(ind=ind, nuisance=int(nu),
                       parameter_names=self.parameter_names,
                       target_name=self.discrepancy_name,
                       objective=self._make_host_objective(ind),
                       dim=self.dim, prior=self.model_prior, n1=n1,
                       bounds=self.bounds)
            prob._traceable = self._objective
            problems.append(prob)
        self.optim_problems = problems
        self.inference_state["_has_defined_problems"] = True

    def _make_host_objective(self, ind):
        """Problem ``ind``'s objective as a host callable theta -> float:
        the batch of n1 with theta in every row, row ``ind`` taken."""
        obj = self._objective
        fn = obj.row_fn(ind)

        def host_obj(theta):
            t = torch.as_tensor(np.asarray(theta, np.float32).reshape(-1),
                                device=obj.device)
            with torch.no_grad():
                return float(fn(t))
        return host_obj

    # -- solving --------------------------------------------------------------
    def solve_problems(self, n1, use_bo=False, optimizer_args=None,
                       seed=None):
        """Define and solve the n1 deterministic problems (reference
        ``romc.py:954-993``); the gradient path solves all problems as one
        batched descent."""
        optimizer_args = dict(optimizer_args or {})
        optimizer_args.setdefault("seed", seed)
        self._define_objectives(n1=n1, seed=seed)
        if use_bo:
            logger.info("Solving problems with Bayesian optimisation")
            self._solve_bo(**optimizer_args)
        else:
            logger.info("Solving problems with batched autograd descent")
            self._solve_gradients(**optimizer_args)

    def _solve_gradients(self, **kwargs):
        """All n1 x restarts Adam descents as one ``adam_minimize`` over
        starts (n1, S, D), each step S program calls; each problem's best
        restart, then its Hessian."""
        n1 = self.inference_args["N1"]
        seed = kwargs.get("seed") or 0
        steps = kwargs.get("steps", 300)
        lr = kwargs.get("lr", 0.1)
        x0 = kwargs.get("x0")
        if x0 is None:
            x0 = np.asarray(self.model_prior.rvs(size=n1, seed=seed))
        x0 = np.asarray(np.atleast_2d(x0), np.float32)
        restarts = int(kwargs.get("restarts", 5))
        starts = x0[:, None, :]
        if restarts > 1:
            # extra prior-drawn starts per problem; the per-problem best is
            # kept, which makes gradient solves robust on multi-modal
            # objectives (e.g. 4-d g-and-k)
            extra = np.asarray(self.model_prior.rvs(
                size=n1 * (restarts - 1),
                seed=int(get_sub_seed(seed, 0xA11))), np.float32).reshape(
                    n1, restarts - 1, self.dim)
            starts = np.concatenate([starts, extra], axis=1)
        starts = torch.as_tensor(starts, device=self.device)
        lo, hi = _bounds_arrays(self.bounds, self.dim, self.device)
        obj = self._objective
        _differentiable(obj, starts[:, 0], self.discrepancy_name)

        def all_restarts(x):
            return torch.stack([obj(x[:, s]) for s in range(x.shape[1])],
                               dim=1)

        with full_float32_matmul():
            xr, fr = adam_minimize(all_restarts, starts, steps, lr, lo, hi)
            best = torch.argmin(fr, dim=1)
            rows = torch.arange(n1, device=self.device)
            xs, fs = xr[rows, best], fr[rows, best]
            hs = _hessian(obj, xs, self.discrepancy_name)
        xs, fs, hs = xs.cpu().numpy(), fs.cpu().numpy(), hs.cpu().numpy()
        solved, attempted = [], []
        for i, prob in enumerate(self.optim_problems):
            attempted.append(True)
            solved.append(prob.set_solution(xs[i], fs[i], hs[i], x0[i]))
        self.inference_state["solved"] = solved
        self.inference_state["attempted"] = attempted
        self.inference_state["_has_solved_problems"] = True

    def _solve_bo(self, **kwargs):
        pb = _ProgressBar()
        solved, attempted = [], []
        for i, prob in enumerate(self.optim_problems):
            pb.update(i + 1, len(self.optim_problems))
            attempted.append(True)
            solved.append(prob.solve_bo(**kwargs))
        pb.finish()
        self.inference_state["attempted"] = attempted
        self.inference_state["solved"] = solved
        self.inference_state["_has_solved_problems"] = True
        self.inference_state["_has_fitted_surrogate_model"] = True

    # -- regions --------------------------------------------------------------
    def compute_eps(self, quantile):
        assert self.inference_state["_has_solved_problems"]
        dist = [p.result.f_min for p in self.optim_problems
                if p.state["solved"]]
        return float(np.quantile(dist, quantile))

    def _filter_solutions(self, eps_filter):
        solved = self.inference_state["solved"]
        accepted = [bool(s and p.result.f_min < eps_filter)
                    for s, p in zip(solved, self.optim_problems)]
        self.inference_args["eps_filter"] = eps_filter
        self.inference_state["accepted"] = accepted
        self.inference_state["_has_filtered_solutions"] = True

    def estimate_regions(self, eps_filter, use_surrogate=None,
                         region_args=None, fit_models=False,
                         fit_models_args=None, eps_region=None,
                         eps_cutoff=None):
        """Filter + build bounding boxes (+ local models) (reference
        ``romc.py:994-1059``)."""
        assert self.inference_state["_has_solved_problems"], \
            "Solve the optimisation problems first"
        region_args = dict(region_args or {})
        fit_models_args = dict(fit_models_args or {})
        eps_cutoff = eps_cutoff if eps_cutoff is not None else eps_filter
        eps_region = eps_region if eps_region is not None else eps_filter
        if use_surrogate is None:
            use_surrogate = self.inference_state[
                "_has_fitted_surrogate_model"]
        region_args.setdefault("use_surrogate", use_surrogate)
        region_args.setdefault("eps_region", eps_region)
        self.inference_args["eps_region"] = eps_region
        self.inference_args["eps_cutoff"] = eps_cutoff

        self._filter_solutions(eps_filter)
        accepted = self.inference_state["accepted"]
        if self._can_batch_regions(accepted, region_args["use_surrogate"]):
            self._build_regions_batched(accepted, **region_args)
            computed_bb = [bool(a) for a in accepted]
        else:
            computed_bb = []
            for i, prob in enumerate(self.optim_problems):
                if accepted[i]:
                    computed_bb.append(prob.build_region(**region_args))
                else:
                    computed_bb.append(False)
        self.inference_state["computed_BB"] = computed_bb
        self.inference_state["_has_estimated_regions"] = True

        if fit_models:
            fit_surr = fit_models_args.get("use_surrogate", False)
            if self._can_batch_regions(accepted, fit_surr):
                self._fit_local_surrogates_batched(accepted,
                                                   **fit_models_args)
            else:
                for i, prob in enumerate(self.optim_problems):
                    if accepted[i]:
                        prob.fit_local_surrogate(**fit_models_args)
            self.inference_state["_has_fitted_local_models"] = True

        self._define_posterior(eps_cutoff=eps_cutoff)

    def _can_batch_regions(self, accepted, use_surrogate):
        """Batched construction covers the default problem class with
        either the shared objective or same-shape GP surrogates; custom
        optimisation classes keep the per-problem path."""
        if self.custom_optim_class is not None:
            return False
        probs = [p for p, a in zip(self.optim_problems, accepted) if a]
        if not probs:
            return False
        if use_surrogate:
            if any(p.bo_process is None for p in probs):
                return False
            fns0 = probs[0].bo_process.fns
            cap0 = probs[0].bo_process._factor[0].shape
            return all(p.bo_process.fns is fns0
                       and p.bo_process._factor[0].shape == cap0
                       for p in probs)
        return all(p._traceable is self._objective for p in probs)

    def _build_regions_batched(self, accepted, eps_region, use_surrogate,
                               K=10, eta=1., rep_lim=300, **_ignored):
        """The line searches of all accepted problems x 2D eigenvector
        directions as one masked loop (``**_ignored``: the per-problem path
        reads known keys and tolerates extras, so this one does too)."""
        probs = [p for p, a in zip(self.optim_problems, accepted) if a]
        D = self.dim
        theta0 = np.stack([np.asarray(p.result.x_min, np.float32)
                           for p in probs])
        rotations = np.stack([
            RegionConstructor._find_rotation(np.asarray(p.result.hess_appr))
            for p in probs]).astype(np.float32)
        # per problem: rows d<D are -eigvec_d, rows d>=D are +eigvec_d
        rot_t = np.transpose(rotations, (0, 2, 1))
        dirs = torch.as_tensor(np.concatenate([-rot_t, rot_t], axis=1),
                               device=self.device)          # (n, 2D, D)
        th0 = torch.as_tensor(theta0, device=self.device)[:, None, :]

        if use_surrogate:
            fns = probs[0].bo_process.fns
            aux = _stack_factors([p.bo_process for p in probs])

            def f(th):
                return _surrogate_means(fns, aux, th)
        else:
            rows = [p.ind for p in probs]

            def f(th):
                return self._objective.at(rows, th)

        offsets = line_search(f, th0.expand_as(dirs), dirs, eps_region, K,
                              eta, rep_lim).cpu().numpy()
        for i, prob in enumerate(probs):
            limits = np.stack([-offsets[i, :D], offsets[i, D:]], axis=1)
            prob.regions = [NDimBoundingBox(rotations[i], theta0[i],
                                            limits)]
            prob.eps_region = float(eps_region)
            prob.state["region"] = True
            if use_surrogate:
                prob.state["has_built_region_with_surrogate"] = True

    def _fit_local_surrogates_batched(self, accepted, nof_samples=20,
                                      use_surrogate=False, **_ignored):
        """All accepted problems' quadratic local-surrogate fits at once
        (reference ``romc.py:1550-1595``): each region's box points from
        the same generator as ``fit_local_surrogate``'s, every region's
        objective at a point index in one program call, then one batched
        minimum-norm least squares."""
        probs = [p for p, a in zip(self.optim_problems, accepted) if a]
        pairs = [(p, i, r) for p in probs for i, r in enumerate(p.regions)]
        if not pairs:
            return
        x = torch.as_tensor(np.stack([
            r.sample(nof_samples, generator=p._box_generator(i))
            for p, i, r in pairs]), device=self.device)   # (P, n, D)
        use_surr = use_surrogate and all(p.surrogate is not None
                                         for p in probs)
        if use_surr:
            y = _surrogate_means(probs[0].bo_process.fns, _stack_factors(
                [p.bo_process for p, _, _ in pairs]), x)
        else:
            y = self._objective.at([p.ind for p, _, _ in pairs], x)
        coefs = _lstsq_min_norm(_quad_features(x), y).cpu().numpy()
        per_prob = {}
        for (p, _, _), coef in zip(pairs, coefs):
            per_prob.setdefault(id(p), (p, []))[1].append(np.asarray(coef))
        for p, cs in per_prob.values():
            p._local_coeffs = cs
            p.local_surrogates = [_make_local_surrogate(c) for c in cs]
            p.state["has_fit_local_surrogates"] = True
            p.state["local_surrogates"] = True

    def _define_posterior(self, eps_cutoff):
        use_surrogate = self.inference_state["_has_fitted_surrogate_model"]
        use_local = self.inference_state["_has_fitted_local_models"]
        regions, objectives, actual, nuisance, rows, coeffs = \
            [], [], [], [], [], []
        region_probs = []
        for prob in self.optim_problems:
            if prob.state["region"]:
                for jj, region in enumerate(prob.regions):
                    nuisance.append(prob.nuisance)
                    rows.append(prob.ind)
                    regions.append(region)
                    region_probs.append(prob)
                    actual.append(prob.objective)
                    if use_local:
                        objectives.append(prob.local_surrogates[jj])
                        coeffs.append(prob._local_coeffs[jj])
                    elif use_surrogate:
                        objectives.append(prob.surrogate)
                    else:
                        objectives.append(prob.objective)
        # under use_bo the posterior evaluates the fitted surrogates, as the
        # reference evaluates ``self.funcs`` (romc.py:507-551): every
        # region's GP factor, stacked over regions
        surrogate_fns = surrogate_aux = None
        if use_surrogate and not use_local and region_probs:
            gps = [p.bo_process for p in region_probs]
            if (all(g is not None and g._factor is not None for g in gps)
                    and all(g.fns is gps[0].fns for g in gps)
                    and len({g._factor[0].shape for g in gps}) == 1):
                surrogate_fns = gps[0].fns
                surrogate_aux = _stack_factors(gps)
        self.posterior = RomcPosterior(
            regions, objectives, actual, None, None, nuisance,
            use_local or use_surrogate, self.model_prior, self.left_lim,
            self.right_lim, self.inference_args["eps_filter"],
            self.inference_args["eps_region"], eps_cutoff,
            self.inference_args["parallelize"],
            traceable_objective=self._objective, rows=rows,
            local_coeffs=coeffs if use_local else None,
            surrogate_fns=surrogate_fns, surrogate_aux=surrogate_aux)
        self.inference_state["_has_defined_posterior"] = True

    # -- one-call training ----------------------------------------------------
    def fit_posterior(self, n1, eps_filter, use_bo=False, quantile=None,
                      optimizer_args=None, region_args=None,
                      fit_models=False, fit_models_args=None, seed=None,
                      eps_region=None, eps_cutoff=None):
        """solve + filter + regions in one call (reference
        ``romc.py:898-952``)."""
        self.solve_problems(n1=n1, use_bo=use_bo,
                            optimizer_args=optimizer_args, seed=seed)
        if eps_filter == "auto":
            eps_filter = self.compute_eps(float(quantile))
        self.estimate_regions(eps_filter=float(eps_filter),
                              use_surrogate=use_bo, region_args=region_args,
                              fit_models=fit_models,
                              fit_models_args=fit_models_args,
                              eps_region=eps_region, eps_cutoff=eps_cutoff)

    # -- inference ------------------------------------------------------------
    def sample(self, n2, seed=None):
        assert self.inference_state["_has_defined_posterior"], \
            "You must train first"
        self.samples, self.weights, self.distances = \
            self.posterior.sample(n2, seed=seed)
        self.inference_state["_has_drawn_samples"] = True
        self.result = self.extract_result()
        return self.result

    def eval_unnorm_posterior(self, theta):
        assert self.inference_state["_has_defined_posterior"]
        return self.posterior.pdf_unnorm_batched(np.atleast_2d(theta))

    def eval_posterior(self, theta):
        assert self.inference_state["_has_defined_posterior"]
        assert self.bounds is not None, \
            "bounds are needed to approximate the partition function"
        return self.posterior.pdf(np.atleast_2d(theta))

    def compute_expectation(self, h):
        assert self.inference_state["_has_drawn_samples"]
        return self.posterior.compute_expectation(h, self.samples,
                                                  self.weights)

    def compute_ess(self):
        assert self.inference_state["_has_drawn_samples"]
        return compute_ess(self.result.weights)

    def compute_divergence(self, gt_posterior, bounds=None, step=0.1,
                           distance="Jensen-Shannon"):
        """Grid divergence to a ground-truth posterior (reference
        ``romc.py:1169-1242``)."""
        import scipy.stats as ss
        from scipy import spatial
        assert self.inference_state["_has_defined_posterior"]
        assert distance in ("Jensen-Shannon", "KL-Divergence")
        limits = bounds or self.bounds
        dim = len(limits)
        if dim > 2:
            logger.info("divergence approximation intractable for dim > 2")
            return None
        grids = [np.linspace(b[0], b[1], int((b[1] - b[0]) / step))
                 for b in limits]
        mesh = np.stack(np.meshgrid(*grids), -1).reshape(-1, dim)
        p_points = np.squeeze(self.eval_posterior(mesh))
        q_points = np.squeeze(gt_posterior(mesh))
        if distance == "KL-Divergence":
            return ss.entropy(p_points, q_points)
        return spatial.distance.jensenshannon(p_points, q_points)

    def extract_result(self):
        if self.samples is None:
            raise ValueError("Nothing to extract")
        outputs = {}
        for i, name in enumerate(self.model.parameter_names):
            outputs[name] = self.samples[:, :, i].flatten()
        outputs[self.discrepancy_name] = self.distances.flatten()
        return RomcSample(method_name="ROMC", outputs=outputs,
                          parameter_names=self.model.parameter_names,
                          discrepancy_name=self.discrepancy_name,
                          weights=self.weights.flatten())

    # -- inspection -----------------------------------------------------------
    def visualize_region(self, i, force_objective=False, savefig=False):
        samples = None
        if self.samples is not None:
            k = sum(1 for j in range(i)
                    if self.optim_problems[j].state["region"])
            samples = self.samples[k]
        self.optim_problems[i].visualize_region(force_objective, samples,
                                                savefig)

    def distance_hist(self, savefig=False, **kwargs):
        import matplotlib.pyplot as plt
        assert self.inference_state["_has_solved_problems"]
        dist = [max(p.result.f_min, 0) for p in self.optim_problems
                if p.state["solved"]]
        plt.figure()
        plt.hist(dist, **kwargs)
        if savefig:
            plt.savefig(savefig, bbox_inches="tight")
