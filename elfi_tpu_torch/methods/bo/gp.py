"""Gaussian-process regression on tensors (counterpart of
:mod:`elfi_tpu.methods.bo.gp`).

The same model family as the JAX package: an RBF kernel plus a bias term
over bounds-scaled inputs, Gamma hyperpriors with the mean == variance
heuristics, the noise variance initialised to ``max(y)^2 / 100`` and held
above :func:`log_noise_floor`.  Training inputs live in padded capacity
buffers (a power of two) with an active-row mask, so adding one evidence
point changes no shape.

Differences from the JAX package, all deliberate:

- The functions of :class:`GPFns` are batched by construction: a predict
  takes ``(n, d)`` points, and :meth:`GPFns.neg_log_posterior` takes one
  log-parameter vector ``(P,)`` or ``(R, P)`` of them, where the JAX
  package ``vmap``s.  Gradients come from autograd on the sum over the
  batch, which is the per-row gradient because the rows are independent.
- The Cholesky factor comes from ``cholesky_ex``, which does not make the
  host wait on the device.  Where the factorization fails (``info > 0``)
  the factor is set to NaN, which is what JAX's Cholesky returns, so a
  failed hyperparameter restart is dropped in the same way.
- Every GP function runs with float32 matmuls at full precision, whatever
  the process set (:func:`full_float32_matmul`): TF32 would give the
  predictive variance the error that collapsed it in the JAX package on the
  TPU's bf16 default.

Custom kernels: ``kernel(A, B, params) -> (..., n, m)`` on tensors, over
positive hyperparameters named in ``kernel_params``.  A hyperparameter is a
tensor that broadcasts against the result: 0-d, or ``(R, 1, 1)`` when
:meth:`GPFns.neg_log_posterior` evaluates R vectors at once.  ``A`` may
carry leading batch dimensions.
"""

from __future__ import annotations

import contextlib
import copy as _copy
import functools
import math
import threading

import numpy as np
import scipy.optimize
import torch

from ...parallel.backends import resolve_device

__all__ = ["GPRegression", "GPFns", "rbf_bias_kernel", "make_gp_fns",
           "full_float32_matmul", "log_noise_floor"]


def _pad_cap(n):
    cap = 16
    while cap < n:
        cap *= 2
    return cap


_GUARD = threading.local()


@contextlib.contextmanager
def full_float32_matmul():
    """Float32 matmuls at full precision (no TF32 on CUDA) inside the
    block, whatever the process set; the settings are restored after it.
    Re-entering costs nothing."""
    if getattr(_GUARD, "depth", 0):
        _GUARD.depth += 1
        try:
            yield
        finally:
            _GUARD.depth -= 1
        return
    cublas = torch.backends.cuda.matmul
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:     # the process mixed the legacy and new settings
        legacy = None
    new = getattr(cublas, "fp32_precision", None)
    torch.set_float32_matmul_precision("highest")
    if new is not None:
        cublas.fp32_precision = "ieee"
    _GUARD.depth = 1
    try:
        yield
    finally:
        _GUARD.depth = 0
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if new is not None:
            cublas.fp32_precision = new


def _mm_highest(fn):
    """``fn`` run inside :func:`full_float32_matmul`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_float32_matmul():
            return fn(*args, **kwargs)
    return wrapped


def rbf_bias_kernel(A, B, params):
    """RBF + bias cross-covariance ``k(A, B)``, (..., n, m).

    ``params['scales']`` (optional, not optimized) rescales each input
    dimension before the isotropic distance: GPRegression sets it to 1 /
    bounds-width per dimension.  Distances are per-dimension outer
    differences, not the ``|a|^2 + |b|^2 - 2ab`` expansion, whose
    cancellation on near-duplicate evidence rows corrupts the factor."""
    scales = params.get("scales") if isinstance(params, dict) else None
    if scales is not None:
        A = A * scales
        B = B * scales
    r2 = torch.sum((A[..., :, None, :] - B[..., None, :, :]) ** 2, dim=-1)
    return (params["sigma2"] * torch.exp(-0.5 * r2 / (params["ell"] ** 2))
            + params["bias"])


def _rbf_bias_diag(x, params):
    """``k(x_i, x_i)`` of :func:`rbf_bias_kernel`: the distance is 0, so it
    is ``sigma2 * 1 + bias`` for every row, and its gradient is 0."""
    return (params["sigma2"] + params["bias"]).expand(x.shape[:-1])


rbf_bias_kernel.param_names = ("sigma2", "ell", "bias")
rbf_bias_kernel.diag = _rbf_bias_diag


def log_noise_floor(y, mask=None):
    """Lower bound for the log noise variance: 1 % of the active-data
    variance.  Full maximum-likelihood GPs on small BO evidence sets
    collapse the noise to ~0, which turns the BOLFI posterior
    Phi((h - mu) / sigma) into cliffs that stall NUTS."""
    if mask is None:
        var = torch.var(y, correction=0)
    else:
        n = torch.clamp(torch.sum(mask), min=1.0)
        mean = torch.sum(y * mask) / n
        var = torch.sum(mask * (y - mean) ** 2) / n
    return torch.log(torch.clamp(0.01 * var, min=1e-8))


def _cholesky(K):
    """Lower Cholesky factor of ``K`` (..., n, n), NaN where the
    factorization fails, as JAX's Cholesky gives it; ``cholesky_ex`` does
    not wait for the device to check ``info``."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[..., None, None], math.nan, L)


def _cho_solve(L, b):
    """``K^-1 b`` from ``K``'s lower Cholesky factor ``L`` (..., n, n) for
    ``b`` (..., n, k): two triangular solves, as JAX's ``cho_solve``."""
    z = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)


def value_and_grad(fn, x):
    """``(fn(x), d sum(fn(x)) / dx)`` for a function of a batch of rows:
    the per-row gradients when the rows are independent.  A value that
    does not depend on ``x`` has gradient 0."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        f = fn(x)
        if f.requires_grad:
            g, = torch.autograd.grad(f.sum(), x, allow_unused=True)
        else:
            g = None
    return f.detach(), (torch.zeros_like(x) if g is None else g)


class GPFns:
    """GP machinery for one kernel function.  Hyperparameters are a dict
    over ``param_names + ('noise',)``; log-parameter vectors follow that
    order with the noise last (the optimizers hold the noise floor at index
    -1)."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.cross_cov = kernel
        self.param_names = tuple(kernel.param_names) + ("noise",)
        names = self.param_names
        diag = getattr(kernel, "diag", None)

        def prior_var_diag(x, params):
            if diag is not None:
                return diag(x, params)
            return torch.stack([kernel(x[i:i + 1], x[i:i + 1], params)[0, 0]
                                for i in range(x.shape[0])])

        def kernel_mats(X, mask, params):
            """Masked ``K + noise I`` over the padded buffer: padding rows
            and columns are identity, so the Cholesky factor of the active
            block is exact."""
            K = kernel(X, X, params)
            eye = torch.eye(X.shape[-2], dtype=K.dtype, device=K.device)
            m2 = mask[:, None] * mask[None, :]
            return torch.where(m2 > 0, K + params["noise"] * eye, eye)

        def posterior_factor(X, y, mask, params):
            L = _cholesky(kernel_mats(X, mask, params))
            ym = y * mask
            alpha = _cho_solve(L, ym[:, None])[:, 0]
            return L, alpha * mask

        def neg_log_posterior(log_params, X, y, mask, prior_shapes,
                              const_params=None):
            """Negative log marginal likelihood plus the Gamma log-priors,
            of ``log_params`` (P,) -> () or (R, P) -> (R,)."""
            u = torch.atleast_2d(log_params)
            R = u.shape[0]
            params = {k: torch.exp(u[:, i]).reshape(R, 1, 1)
                      for i, k in enumerate(names)}
            if const_params:
                params.update(const_params)
            L = _cholesky(kernel_mats(X, mask, params))
            ym = y * mask
            alpha = _cho_solve(L, ym.expand(R, ym.shape[0])[..., None])[
                ..., 0]
            n_active = torch.sum(mask)
            mll = (-0.5 * torch.sum(ym * alpha, dim=-1)
                   - torch.sum(torch.log(torch.diagonal(L, dim1=-2,
                                                        dim2=-1)), dim=-1)
                   - 0.5 * n_active * math.log(2 * math.pi))
            # Gamma(shape=k, scale=1) log-priors in log-space (with the
            # exp-transform Jacobian), as GPy's from_EV(m, m)
            logprior = 0.0
            for i in range(len(names)):
                ui = u[:, i]
                k = prior_shapes[i]
                logprior = logprior + torch.where(
                    k > 0, k * ui - torch.exp(ui) - torch.lgamma(k), 0.0)
            out = -(mll + logprior)
            return out if log_params.ndim == 2 else out[0]

        def predict(x, X, mask, L, alpha, params):
            kx = kernel(x, X, params) * mask[None, :]
            mu = kx @ alpha
            v = torch.linalg.solve_triangular(L, kx.T, upper=False)
            var = (prior_var_diag(x, params) - torch.sum(v * v, dim=0)
                   + params["noise"])
            return mu, torch.clamp(var, min=1e-10)

        def predict_noiseless(x, X, mask, L, alpha, params):
            mu, var = predict(x, X, mask, L, alpha, params)
            return mu, torch.clamp(var - params["noise"], min=1e-10)

        def posterior_inverse(L, mask):
            """Masked ``K^-1`` from the Cholesky factor, so that each
            predict inside a long device loop is a matmul instead of a
            triangular solve.  The padding block of K is identity, so
            masking the inverse is exact."""
            eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
            Kinv = _cho_solve(L, eye)
            return Kinv * (mask[:, None] * mask[None, :])

        def predict_inv(x, X, mask, Kinv, alpha, params):
            kx = kernel(x, X, params) * mask[None, :]
            mu = kx @ alpha
            var = (prior_var_diag(x, params)
                   - torch.sum((kx @ Kinv) * kx, dim=1) + params["noise"])
            return mu, torch.clamp(var, min=1e-10)

        def predict_noiseless_inv(x, X, mask, Kinv, alpha, params):
            mu, var = predict_inv(x, X, mask, Kinv, alpha, params)
            return mu, torch.clamp(var - params["noise"], min=1e-10)

        def neg_lcb_obj_inv(theta, X, mask, Kinv, alpha, params, beta):
            """LCB objective ``mean - sqrt(beta * var)`` on the
            cached-inverse predict, of ``theta`` (d,) -> () or
            (n, d) -> (n,)."""
            mu, var = predict_noiseless_inv(torch.atleast_2d(theta), X, mask,
                                            Kinv, alpha, params)
            out = mu - torch.sqrt(beta * var)
            return out if theta.ndim == 2 else out[0]

        def neg_lcb_obj(theta, X, mask, L, alpha, params, beta):
            mu, var = predict_noiseless(torch.atleast_2d(theta), X, mask, L,
                                        alpha, params)
            out = mu - torch.sqrt(beta * var)
            return out if theta.ndim == 2 else out[0]

        def mean_obj(theta, X, mask, L, alpha, params):
            """GP posterior mean at ``theta`` (d,) -> () or (n, d) -> (n,):
            the objective of the multistart minimizations."""
            mu, _ = predict(torch.atleast_2d(theta), X, mask, L, alpha,
                            params)
            return mu if theta.ndim == 2 else mu[0]

        def optimize_restarts_core(starts, X, y, mask, prior_shapes, lr,
                                   steps=250, const_params=None,
                                   capture=None):
            """All hyperparameter restarts ``starts`` (R, P) as one batched
            Adam descent (:func:`.utils.descend`: a replayed CUDA graph on a
            CUDA device unless ``capture`` is False); returns the best (P,)
            and its value."""
            from .utils import descend
            dim = starts.shape[-1]
            lo = torch.cat([torch.full((dim - 1,), -12.0,
                                       device=starts.device),
                            log_noise_floor(y, mask).reshape(1)])
            hi = torch.full((dim,), 12.0, device=starts.device)
            us, fs = descend(self.neg_log_posterior, starts, steps, lr, lo,
                             hi, (X, y, mask, prior_shapes, const_params),
                             capture=capture)
            fs = torch.where(torch.isfinite(fs), fs, math.inf)
            i = torch.argmin(fs).reshape(1)
            return us.index_select(0, i)[0], fs.index_select(0, i)[0]

        def _grad_fn(pred):
            def grads(x, X, mask, L, alpha, params):
                with torch.enable_grad():
                    x = x.detach().requires_grad_(True)
                    mu, var = pred(x, X, mask, L, alpha, params)
                    gmu, = torch.autograd.grad(mu.sum(), x,
                                               retain_graph=True)
                    gvar, = torch.autograd.grad(var.sum(), x,
                                                allow_unused=True)
                return gmu, (torch.zeros_like(x) if gvar is None else gvar)
            return grads

        def neg_log_posterior_grad(log_params, *args, **kwargs):
            return value_and_grad(
                lambda u: neg_log_posterior(u, *args, **kwargs), log_params)

        for name, fn in (
                ("kernel_mats", kernel_mats),
                ("posterior_factor", posterior_factor),
                ("posterior_inverse", posterior_inverse),
                ("predict", predict), ("predict_noiseless", predict_noiseless),
                ("predict_inv", predict_inv),
                ("predict_noiseless_inv", predict_noiseless_inv),
                ("neg_lcb_obj_inv", neg_lcb_obj_inv),
                ("neg_lcb_obj", neg_lcb_obj), ("mean_obj", mean_obj),
                ("neg_log_posterior", neg_log_posterior),
                ("optimize_restarts_core", optimize_restarts_core),
                ("grads_noisy", _grad_fn(predict)),
                ("grads_noiseless", _grad_fn(predict_noiseless))):
            setattr(self, name, _mm_highest(fn))
        self.optimize_restarts = self.optimize_restarts_core
        self.neg_log_posterior_grad = _mm_highest(neg_log_posterior_grad)


_FNS_CACHE = {}


def make_gp_fns(kernel):
    """Build (or fetch) the GP machinery for ``kernel``.  Kept per kernel
    object, so every GP with one kernel shares one bundle and the captured
    descents keyed on its functions (:mod:`.utils`)."""
    key = id(kernel)
    fns = _FNS_CACHE.get(key)
    if fns is None or fns.kernel is not kernel:
        fns = _FNS_CACHE[key] = GPFns(kernel)
    return fns


# the default kernel's machinery under the JAX package's module-level
# names: ``gp_cross_cov`` is the kernel (acquisitions imported it), the
# objectives and the restarts' optimiser are the default bundle's
gp_cross_cov = rbf_bias_kernel
_DEFAULT_FNS = make_gp_fns(rbf_bias_kernel)
gp_mean_obj = _DEFAULT_FNS.mean_obj
gp_neg_lcb_obj = _DEFAULT_FNS.neg_lcb_obj
gp_neg_lcb_obj_inv = _DEFAULT_FNS.neg_lcb_obj_inv
optimize_restarts_core = _DEFAULT_FNS.optimize_restarts_core


class GPRegression:
    """The GP surrogate of BOLFI (counterpart of the JAX package's
    ``GPRegression``, the reference's ``GPyRegression``).

    ``kernel``/``kernel_params``/``kernel_priors`` give custom-kernel
    support: ``kernel(A, B, params)`` is a cross-covariance on tensors,
    ``kernel_params`` maps its positive hyperparameter names to initial
    values (ordering = optimization ordering), and ``kernel_priors``
    optionally maps names to Gamma(shape, scale=1) log-prior shapes.
    ``device``: where the factor and every prediction live (None: the
    global backend's).
    """

    def __init__(self, parameter_names=None, bounds=None, optimizer="adam",
                 max_opt_iters=50, gp=None, seed=0, kernel=None,
                 kernel_params=None, kernel_priors=None, device=None,
                 **gp_params):
        if parameter_names is None:
            input_dim = 1
        elif isinstance(parameter_names, (list, tuple)):
            input_dim = len(parameter_names)
        else:
            raise ValueError("parameter_names must be a list of strings")
        if bounds is None:
            bounds = [(0, 1)] * input_dim
        elif isinstance(bounds, dict):
            bounds = [bounds[n] for n in (parameter_names or bounds.keys())]
        if len(bounds) != input_dim:
            raise ValueError("len(bounds) does not match input dimension")

        kernel = kernel or gp_params.pop("kernel", None)
        self.custom_kernel = kernel is not None
        if self.custom_kernel:
            if kernel_params is None:
                raise ValueError(
                    "a custom kernel requires kernel_params (dict of "
                    "initial positive hyperparameter values)")
            if not hasattr(kernel, "param_names"):
                kernel.param_names = tuple(kernel_params.keys())
            self._kernel = kernel
        else:
            self._kernel = rbf_bias_kernel
        self.fns = make_gp_fns(self._kernel)
        self._kernel_params = dict(kernel_params or {})
        self._kernel_priors = dict(kernel_priors or {})
        self.device = resolve_device(device)

        self.parameter_names = parameter_names
        self.input_dim = input_dim
        self.bounds = [tuple(b) for b in bounds]
        self.optimizer = optimizer
        self.max_opt_iters = max_opt_iters
        self.gp_params = gp_params
        self.seed = seed
        self.is_sampling = False

        self._x = None            # (n, d) numpy
        self._y = None            # (n,) numpy
        self.params = None        # dict of floats (scales: an array)
        self._prior_shapes = np.zeros(len(self.fns.param_names))
        self._factor = None       # (X_pad, mask, L, alpha, params) tensors
        self._n_restarts = int(gp_params.pop("n_restarts", 4))

    # -- data -----------------------------------------------------------------
    @property
    def n_evidence(self):
        return 0 if self._x is None else len(self._x)

    @property
    def X(self):
        return None if self._x is None else self._x.copy()

    @property
    def Y(self):
        return None if self._y is None else self._y.reshape(-1, 1).copy()

    @property
    def x(self):
        return self.X

    @property
    def y(self):
        return self.Y

    @property
    def noise(self):
        return self.params["noise"] if self.params else None

    def __str__(self):
        if self.params is None:
            return "GPRegression(unfitted)"
        p = {k: round(float(v), 5) for k, v in self.params.items()
             if np.ndim(v) == 0}
        return f"GPRegression(n={self.n_evidence}, {p})"

    __repr__ = __str__

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    # -- fitting --------------------------------------------------------------
    def _init_hyperparams(self):
        """Heuristic initial values and Gamma(mean = var) hyperpriors
        (reference ``gpy_regression.py:243-280``)."""
        y = self._y
        noise_var = self.gp_params.get("noise_var")
        if noise_var is None:
            noise_var = max(np.max(y) ** 2 / 100.0, 1e-6)
        else:
            # a user-specified value is respected (an explicit 0 included),
            # floored so the log-parametrisation stays finite
            noise_var = max(float(noise_var), 1e-8)
        if self.custom_kernel:
            self.params = dict(self._kernel_params, noise=float(noise_var))
            self._prior_shapes = np.array(
                [float(self._kernel_priors.get(n, 0.0))
                 for n in self._kernel.param_names] + [0.0])
            return
        # bounds-scaled distances: ell lives in unit-cube units, so its
        # heuristic initial value is 1/3 whatever the parameter ranges
        widths = np.array([hi - lo for lo, hi in self.bounds], np.float32)
        scales = 1.0 / np.maximum(widths, 1e-12)
        length_scale = 1.0 / 3.0
        kernel_var = (np.max(np.abs(y)) / 3.0) ** 2
        bias_var = kernel_var / 4.0
        self.params = dict(sigma2=float(max(kernel_var, 1e-6)),
                           ell=float(length_scale),
                           bias=float(max(bias_var, 1e-6)),
                           noise=float(noise_var),
                           scales=scales)
        self._prior_shapes = np.array([kernel_var, length_scale, bias_var,
                                       0.0])

    def _log_param_vector(self):
        return np.log(np.asarray([self.params[k]
                                  for k in self.fns.param_names]))

    def _const_params(self):
        """Non-optimized kernel constants carried in the params dict (the
        bounds scales)."""
        return {k: self._tensor(v) for k, v in (self.params or {}).items()
                if k not in self.fns.param_names}

    def update(self, x, y, optimize=False):
        """Append evidence; refactorise the posterior (reference
        ``gpy_regression.py:286-315``)."""
        x = np.asarray(x, np.float64).reshape(-1, self.input_dim)
        y = np.asarray(y, np.float64).reshape(-1)
        if self._x is None:
            self._x, self._y = x, y
            self._init_hyperparams()
        else:
            self._x = np.vstack([self._x, x])
            self._y = np.concatenate([self._y, y])
        if optimize:
            self.optimize()
        else:
            self._refactor()

    def _padded(self):
        """The evidence padded to its capacity, with its mask, as float32
        tensors on the GP's device."""
        n = self.n_evidence
        cap = _pad_cap(n)
        Xp = np.zeros((cap, self.input_dim))
        Xp[:n] = self._x
        yp = np.zeros(cap)
        yp[:n] = self._y
        mask = np.zeros(cap)
        mask[:n] = 1.0
        return self._tensor(Xp), self._tensor(yp), self._tensor(mask)

    def _refactor(self):
        Xp, yp, mask = self._padded()
        params = {k: self._tensor(v) for k, v in self.params.items()}
        L, alpha = self.fns.posterior_factor(Xp, yp, mask, params)
        self._factor = (Xp, mask, L, alpha, params)

    def optimize(self):
        """MAP hyperparameters by multi-restart descent over log-params
        (replaces GPy's scg, ``gpy_regression.py:317-323``).

        'adam' (default): all restarts as one batched Adam descent on the
        device.  'lbfgsb' keeps scipy's L-BFGS-B on the host with a device
        value and gradient per call."""
        if self.optimizer not in ("lbfgsb", "lbfgs", "scg", "scipy"):
            return self._optimize_adam()
        Xp, yp, mask = self._padded()
        shapes = self._tensor(self._prior_shapes)
        const = self._const_params()

        def obj(u):
            val, grad = self.fns.neg_log_posterior_grad(
                self._tensor(u), Xp, yp, mask, shapes, const)
            val = float(val)
            grad = grad.cpu().numpy().astype(np.float64)
            if not np.isfinite(val):
                return 1e10, np.zeros_like(grad)
            return val, grad

        u0 = self._log_param_vector()
        dim = len(u0)
        noise_floor = float(np.log(max(0.01 * np.var(self._y), 1e-8)))
        opt_bounds = [(-12, 12)] * (dim - 1) + [(noise_floor, 12)]
        rng = np.random.RandomState(self.seed + self.n_evidence)
        starts = [u0] + [u0 + rng.normal(0, 1.0, size=dim)
                         for _ in range(self._n_restarts - 1)]
        best, best_val = u0, np.inf
        for s in starts:
            try:
                r = scipy.optimize.minimize(
                    obj, s, jac=True, method="L-BFGS-B", bounds=opt_bounds,
                    options={"maxiter": self.max_opt_iters})
            except (ValueError, np.linalg.LinAlgError):
                continue
            if np.isfinite(r.fun) and r.fun < best_val:
                best, best_val = r.x, r.fun
        self.params.update(zip(self.fns.param_names,
                               np.exp(best).tolist()))
        self._refactor()

    def _optimize_adam(self):
        Xp, yp, mask = self._padded()
        u0 = self._log_param_vector().astype(np.float32)
        dim = len(u0)
        rng = np.random.RandomState(self.seed + self.n_evidence)
        starts = np.vstack([u0] + [u0 + rng.normal(0, 1.0, dim)
                                   for _ in range(self._n_restarts - 1)])
        best, _ = self.fns.optimize_restarts(
            self._tensor(starts), Xp, yp, mask,
            self._tensor(self._prior_shapes),
            torch.tensor(0.1, device=self.device),
            const_params=self._const_params())
        vals = np.exp(best.cpu().numpy().astype(np.float64))
        if np.all(np.isfinite(vals)):
            self.params.update(zip(self.fns.param_names, vals.tolist()))
        self._refactor()

    # -- prediction -----------------------------------------------------------
    def predict(self, x, noiseless=False):
        """(mean, var) at x, each (n, 1) numpy (reference
        ``gpy_regression.py:98-147``)."""
        x = np.asarray(x, np.float32).reshape(-1, self.input_dim)
        if self._factor is None:
            return np.zeros((len(x), 1)), np.ones((len(x), 1))
        Xp, mask, L, alpha, params = self._factor
        fn = self.fns.predict_noiseless if noiseless else self.fns.predict
        mu, var = fn(self._tensor(x), Xp, mask, L, alpha, params)
        return mu.cpu().numpy()[:, None], var.cpu().numpy()[:, None]

    def predict_mean(self, x):
        return self.predict(x)[0]

    def predict_var(self, x, noiseless=False):
        return self.predict(x, noiseless=noiseless)[1]

    def predictive_gradients(self, x):
        """(dmu/dx, dvar/dx), each (n, d) numpy, by autograd (reference
        ``gpy_regression.py:180-223``)."""
        x = np.asarray(x, np.float32).reshape(-1, self.input_dim)
        if self._factor is None:
            return (np.zeros((len(x), self.input_dim)),
                    np.zeros((len(x), self.input_dim)))
        Xp, mask, L, alpha, params = self._factor
        gmu, gvar = self.fns.grads_noisy(self._tensor(x), Xp, mask, L, alpha,
                                         params)
        return gmu.cpu().numpy(), gvar.cpu().numpy()

    def predictive_gradient_mean(self, x):
        return self.predictive_gradients(x)[0]

    # -- device closures for the samplers -------------------------------------
    def device_predict(self, noiseless=False, use_inverse=False):
        """A function ``x (n, d) tensor -> (mu, var)`` over the current
        factor, for device loops.  ``use_inverse=True`` computes the masked
        ``K^-1`` once here, so each evaluation is a matmul instead of a
        triangular solve."""
        if self._factor is None:
            raise ValueError("GP has no evidence yet")
        Xp, mask, L, alpha, params = self._factor
        if use_inverse:
            Kinv = self.fns.posterior_inverse(L, mask)
            fn = self.fns.predict_noiseless_inv if noiseless \
                else self.fns.predict_inv

            def pred(x):
                return fn(x, Xp, mask, Kinv, alpha, params)

            return pred
        fn = self.fns.predict_noiseless if noiseless else self.fns.predict

        def pred(x):
            return fn(x, Xp, mask, L, alpha, params)

        return pred

    def copy(self):
        k = _copy.copy(self)
        if self._x is not None:
            k._x = self._x.copy()
            k._y = self._y.copy()
            k.params = dict(self.params)
        return k
