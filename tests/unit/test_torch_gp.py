"""BOLFI's GP surrogate, acquisition and posterior in the PyTorch port
against the JAX package's on the same inputs: the special functions, the
RBF + bias kernel and every GP function on the same evidence and
hyperparameters (carried across with ``gp_from_numpy``), the Adam descent,
the hyperparameter restarts and the fused loop's theta selector from the
same starts, the BOLFI posterior, the fused fit's refit schedule and the
GP it leaves behind, and the Cholesky's NaN on a failed factorization.

The evidence holds near-duplicate rows, as BO's acquisitions make them
(the JAX package's
``test_gp_variance_never_collapses_on_clustered_evidence``).  Both packages
compute in float32; their factorizations and sums take their own orders, so
each comparison states the tolerance that float32 rounding on that data
allows.
"""

import math

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.interop import gp_from_numpy
from elfi_tpu_torch.methods import bolfi as tbolfi
from elfi_tpu_torch.methods.bo import gp as tgp
from elfi_tpu_torch.methods.bo import utils as tutils
from elfi_tpu_torch.methods.bo.acquisition import LCBSC
from elfi_tpu_torch.methods.posteriors import BolfiPosterior
from elfi_tpu_torch.ops import special as tspecial

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


CPU = torch.device("cpu")
# float32 elementwise and reductions over a few terms
ELEM_RTOL = 1e-6
# float32 Cholesky factors, solves and the products over the cap-64 buffer
# of near-duplicate evidence, which both packages compute in their own
# orders: relative to the largest entry of each result
FACTOR_TOL = 2e-4
# the predictive variance through the cached inverse, the quadratic form
# kx K^-1 kx that cancels down to the noise on clustered evidence
VAR_INV_TOL = 1e-3


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _close(a, b, tol=FACTOR_TOL, what=""):
    a, b = _np(a), _np(b)
    scale = max(np.max(np.abs(b)), 1e-30)
    gap = np.max(np.abs(a - b)) / scale
    assert gap <= tol, f"{what}: max gap {gap} of the largest entry {scale}"


def _evidence(d, n=48, seed=0):
    """BO-like evidence in the unit box: clusters of near-duplicates and a
    few spread points."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(3, d)
    X = np.vstack([c + 1e-4 * rng.randn((n - 12) // 3, d) for c in centers]
                  + [rng.rand(12, d)])
    y = np.sin(5 * X[:, 0]) + np.cos(3 * X[:, -1]) + 0.1 * rng.randn(len(X))
    return X, y


@pytest.fixture(scope="module", params=[2, 3], ids=["d2", "d3"])
def gps(request):
    """A JAX GP fit on clustered evidence (cap 64) and the port's GP on the
    same evidence and hyperparameters."""
    from elfi_tpu.methods.bo.gp import GPRegression
    d = request.param
    X, y = _evidence(d)
    jgp = GPRegression([f"x{i}" for i in range(d)], bounds=[(0, 1)] * d)
    jgp.update(X, y, optimize=True)
    pgp = gp_from_numpy(jgp.X, jgp.Y, jgp.params, jgp.bounds, device=CPU,
                        prior_shapes=jgp._prior_shapes)
    return jgp, pgp


def _grid(d, n=25, seed=1):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


# -- special functions --------------------------------------------------------

def test_special_functions_equal_jax():
    from elfi_tpu.ops import special as jspecial
    x = np.linspace(-6, 6, 41).astype(np.float32)
    a = np.linspace(-3, 3, 41).astype(np.float32)
    for name in ("norm_cdf", "norm_logcdf"):
        np.testing.assert_allclose(
            _np(getattr(tspecial, name)(_t(x))),
            np.asarray(getattr(jspecial, name)(x), np.float64),
            rtol=ELEM_RTOL, err_msg=name)
    # values near 0 (T is odd in a): the sum of 32 terms is rounded in its
    # own order, so an absolute floor of a few float32 ulps of T(0, 1)
    for name in ("owens_t", "skewnorm_cdf"):
        np.testing.assert_allclose(
            _np(getattr(tspecial, name)(_t(x), _t(a))),
            np.asarray(getattr(jspecial, name)(x, a), np.float64),
            rtol=ELEM_RTOL, atol=1e-7, err_msg=name)


# -- the kernel and the GP functions ------------------------------------------

def test_rbf_bias_kernel_equals_jax(gps):
    from elfi_tpu.methods.bo.gp import rbf_bias_kernel
    jgp, pgp = gps
    A, B = _grid(jgp.input_dim, 30, 2), jgp.X.astype(np.float32)
    jparams = {k: np.asarray(v, np.float32) for k, v in jgp.params.items()}
    pparams = {k: _t(v) for k, v in jgp.params.items()}
    np.testing.assert_allclose(
        _np(tgp.rbf_bias_kernel(_t(A), _t(B), pparams)),
        np.asarray(rbf_bias_kernel(A, B, jparams), np.float64),
        rtol=ELEM_RTOL)


def test_factor_and_inverse_equal_jax(gps):
    jgp, pgp = gps
    jXp, jmask, jL, jalpha, _ = jgp._factor
    Xp, mask, L, alpha, params = pgp._factor
    assert Xp.shape[0] == 64
    np.testing.assert_array_equal(_np(Xp), np.asarray(jXp, np.float64))
    np.testing.assert_array_equal(_np(mask), np.asarray(jmask, np.float64))
    _close(pgp.fns.kernel_mats(Xp, mask, params),
           jgp.fns.kernel_mats(jXp, jmask, jgp._factor[4]), ELEM_RTOL,
           "kernel_mats")
    _close(L, jL, FACTOR_TOL, "L")
    _close(alpha, jalpha, FACTOR_TOL, "alpha")
    _close(pgp.fns.posterior_inverse(L, mask),
           jgp.fns.posterior_inverse(jL, jmask), FACTOR_TOL, "K^-1")


@pytest.mark.parametrize("noiseless", [False, True])
def test_predict_family_equals_jax(gps, noiseless):
    jgp, pgp = gps
    x = _grid(jgp.input_dim)
    jm, jv = jgp.predict(x, noiseless=noiseless)
    pm, pv = pgp.predict(x, noiseless=noiseless)
    _close(pm, jm, FACTOR_TOL, "mean")
    _close(pv, jv, FACTOR_TOL, "var")
    jXp, jmask, jL, jalpha, jparams = jgp._factor
    Xp, mask, L, alpha, params = pgp._factor
    jKinv = jgp.fns.posterior_inverse(jL, jmask)
    Kinv = pgp.fns.posterior_inverse(L, mask)
    jfn = jgp.fns.predict_noiseless_inv if noiseless else jgp.fns.predict_inv
    pfn = pgp.fns.predict_noiseless_inv if noiseless else pgp.fns.predict_inv
    jmi, jvi = jfn(x, jXp, jmask, jKinv, jalpha, jparams)
    pmi, pvi = pfn(_t(x), Xp, mask, Kinv, alpha, params)
    _close(pmi, jmi, FACTOR_TOL, "mean, inverse")
    _close(pvi, jvi, VAR_INV_TOL, "var, inverse")
    if not noiseless:
        jg = jgp.predictive_gradients(x)
        pg = pgp.predictive_gradients(x)
        _close(pg[0], jg[0], FACTOR_TOL, "d mean")
        _close(pg[1], jg[1], 5 * FACTOR_TOL, "d var")
    # the variance never collapses to the clip on clustered evidence
    assert np.all(pv > 0.5 * (0.0 if noiseless else pgp.params["noise"]))


def test_neg_log_posterior_and_gradient_equal_jax(gps):
    jgp, pgp = gps
    import jax.numpy as jnp
    jXp, jyp, jmask = jgp._padded()
    Xp, yp, mask = pgp._padded()
    rng = np.random.RandomState(3)
    u = (jgp._log_param_vector()[None]
         + 0.3 * rng.randn(4, 4)).astype(np.float32)
    shapes = np.asarray(jgp._prior_shapes, np.float32)
    jconst = jgp._const_params()
    pconst = pgp._const_params()
    for row in u:
        jv, jg = jgp.fns.neg_log_posterior_grad(
            jnp.asarray(row), jXp.astype(jnp.float32),
            jyp.astype(jnp.float32), jmask.astype(jnp.float32),
            jnp.asarray(shapes), jconst)
        pv, pg = pgp.fns.neg_log_posterior_grad(_t(row), Xp, yp, mask,
                                                _t(shapes), pconst)
        # a sum of terms of about 50 (the log-determinant, the data fit)
        # that cancel to about 1: 5e-4 absolute is 1e-5 of the terms
        np.testing.assert_allclose(float(pv), float(jv), rtol=1e-4,
                                   atol=5e-4)
        _close(pg, jg, 1e-3, "gradient")
    # the batched form is the rows one by one
    batched = pgp.fns.neg_log_posterior(_t(u), Xp, yp, mask, _t(shapes),
                                        pconst)
    rows = [float(pgp.fns.neg_log_posterior(_t(r), Xp, yp, mask, _t(shapes),
                                            pconst)) for r in u]
    np.testing.assert_allclose(_np(batched), rows, rtol=1e-6)


def test_neg_lcb_objective_and_gradient_equal_jax(gps):
    import jax
    import jax.numpy as jnp
    jgp, pgp = gps
    jXp, jmask, jL, jalpha, jparams = jgp._factor
    Xp, mask, L, alpha, params = pgp._factor
    jKinv = jgp.fns.posterior_inverse(jL, jmask)
    Kinv = pgp.fns.posterior_inverse(L, mask)
    beta = np.float32(7.5)
    x = _grid(jgp.input_dim, 8, 4)
    jf = jax.vmap(jax.value_and_grad(
        lambda th: jgp.fns.neg_lcb_obj_inv(th, jXp, jmask, jKinv, jalpha,
                                           jparams, jnp.float32(beta))))
    jv, jg = jf(jnp.asarray(x))
    pv, pg = tgp.value_and_grad(
        lambda th: pgp.fns.neg_lcb_obj_inv(th, Xp, mask, Kinv, alpha, params,
                                           _t(beta)), _t(x))
    _close(pv, jv, VAR_INV_TOL, "LCB")
    _close(pg, jg, 2e-3, "LCB gradient")


# -- descents -----------------------------------------------------------------

def test_adam_minimize_on_a_quadratic_equals_jax():
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods.bo.utils import adam_minimize as jadam
    c = np.array([0.3, -0.7, 1.1], np.float32)
    lo, hi = -np.ones(3, np.float32), 2 * np.ones(3, np.float32)
    x0 = np.array([[1.5, 1.5, -0.5], [-1.0, 0.0, 0.0]], np.float32)
    jx, jf = jax.vmap(lambda s: jadam(
        lambda t: jnp.sum((t - c) ** 2), s, 100, jnp.float32(0.2),
        jnp.asarray(lo), jnp.asarray(hi)))(jnp.asarray(x0))
    px, pf = tutils.adam_minimize(lambda t: torch.sum((t - _t(c)) ** 2, -1),
                                  _t(x0), 100, torch.tensor(0.2), _t(lo),
                                  _t(hi))
    np.testing.assert_allclose(_np(px), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(pf), np.asarray(jf), rtol=1e-4, atol=1e-9)


def test_adam_minimize_on_the_lcb_objective_equals_jax(gps):
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods.bo.utils import adam_minimize as jadam
    jgp, pgp = gps
    d = jgp.input_dim
    jXp, jmask, jL, jalpha, jparams = jgp._factor
    Xp, mask, L, alpha, params = pgp._factor
    jKinv = jgp.fns.posterior_inverse(jL, jmask)
    Kinv = pgp.fns.posterior_inverse(L, mask)
    x0 = _grid(d, 10, 5)
    lo, hi = np.zeros(d, np.float32), np.ones(d, np.float32)
    jx, jf = jax.vmap(lambda s: jadam(
        lambda t: jgp.fns.neg_lcb_obj_inv(t, jXp, jmask, jKinv, jalpha,
                                          jparams, jnp.float32(5.0)),
        s, 150, jnp.float32(0.1), jnp.asarray(lo), jnp.asarray(hi)))(
            jnp.asarray(x0))
    px, pf = tutils.descend(pgp.fns.neg_lcb_obj_inv, _t(x0), 150, 0.1, _t(lo),
                            _t(hi), (Xp, mask, Kinv, alpha, params,
                                     torch.tensor(5.0)))
    # each start descends to the same minimum; float32 rounding moves the
    # iterates by far less than the minima are apart
    np.testing.assert_allclose(_np(px), np.asarray(jx), atol=2e-3)
    _close(pf, jf, 1e-3, "minima")


def test_optimize_restarts_core_equals_jax(gps):
    import jax.numpy as jnp
    jgp, pgp = gps
    jXp, jyp, jmask = jgp._padded()
    Xp, yp, mask = pgp._padded()
    u0 = jgp._log_param_vector().astype(np.float32)
    starts = (u0[None] + 0.5 * np.random.RandomState(6).randn(4, 4)).astype(
        np.float32)
    starts[0] = u0
    shapes = np.asarray(jgp._prior_shapes, np.float32)
    ju, jf = jgp.fns.optimize_restarts(
        jnp.asarray(starts), jXp.astype(jnp.float32),
        jyp.astype(jnp.float32), jmask.astype(jnp.float32),
        jnp.asarray(shapes), jnp.float32(0.1), steps=60,
        const_params=jgp._const_params())
    pu, pf = pgp.fns.optimize_restarts_core(
        _t(starts), Xp, yp, mask, _t(shapes), torch.tensor(0.1), steps=60,
        const_params=pgp._const_params())
    # the same minimum; along its flat directions the float32 descents stop
    # a little apart in the log-parameters
    np.testing.assert_allclose(float(pf), float(jf), rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(_np(pu), np.asarray(ju), atol=5e-2)


def _indefinite_kernel():
    """exp-kernel minus a constant: indefinite once ``c`` outweighs the
    rest, where the Cholesky fails."""
    def kernel(A, B, p):
        lib = torch if isinstance(A, torch.Tensor) else __import__(
            "jax.numpy", fromlist=["exp"])
        r2 = ((A[..., :, None, :] - B[..., None, :, :]) ** 2).sum(-1)
        return p["s"] * lib.exp(-0.5 * r2) - p["c"]
    kernel.param_names = ("s", "c")
    return kernel


def test_failed_cholesky_is_nan_and_its_restart_is_dropped():
    import jax.numpy as jnp
    from elfi_tpu.methods.bo.gp import make_gp_fns as jmake
    # cholesky_ex's partial factor becomes NaN, as JAX's Cholesky gives it
    K = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(tgp._cholesky(K)).all()
    assert torch.isnan(tgp._cholesky(torch.stack([K, torch.eye(2)]))[0]).all()
    assert torch.equal(tgp._cholesky(torch.stack([K, torch.eye(2)]))[1],
                       torch.eye(2))
    # restart 1's c makes K indefinite over all of its descent: dropped in
    # both packages, which pick the same finite restart
    rng = np.random.RandomState(0)
    X = rng.rand(20, 1)
    y = np.sin(3 * X[:, 0])
    Xp = np.zeros((32, 1), np.float32)
    Xp[:20] = X
    yp = np.zeros(32, np.float32)
    yp[:20] = y
    mask = (np.arange(32) < 20).astype(np.float32)
    starts = np.log(np.array([[1.0, 0.01, 0.01], [1.0, 1e4, 0.01]],
                             np.float32))
    shapes = np.zeros(3, np.float32)
    kernel = _indefinite_kernel()
    pu, pf = tgp.make_gp_fns(kernel).optimize_restarts_core(
        _t(starts), _t(Xp), _t(yp), _t(mask), _t(shapes), torch.tensor(0.01),
        steps=20)
    ju, jf = jmake(kernel).optimize_restarts(
        jnp.asarray(starts), jnp.asarray(Xp), jnp.asarray(yp),
        jnp.asarray(mask), jnp.asarray(shapes), jnp.float32(0.01), steps=20)
    assert np.isfinite(float(pf)) and np.isfinite(float(jf))
    # the finite restart is the first one: it stays near its start
    assert abs(float(pu[1]) - math.log(0.01)) < 1.0
    np.testing.assert_allclose(_np(pu), np.asarray(ju), atol=1e-3)


# -- the fused loop's pieces --------------------------------------------------

def test_theta_selector_equals_jax_from_the_same_starts(gps, monkeypatch):
    """Both selectors from the same injected uniform starts, with no
    acquisition noise and no epsilon draws: the same acquired point."""
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods import bolfi as jbolfi
    jgp, pgp = gps
    d = jgp.input_dim
    u = np.random.RandomState(7).rand(10, d).astype(np.float32)
    lo, hi = (0.0,) * d, (1.0,) * d
    spec = (64, d, 10, 1000, lo, hi, None, 0.0)
    jXp, _, _, _, jparams = jgp._factor
    Xp, _, _, _, params = pgp._factor
    yp = np.zeros(64, np.float32)
    yp[:jgp.n_evidence] = jgp.Y[:, 0]
    n = jgp.n_evidence
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    jtheta = jbolfi._make_theta_selector(spec)(
        jax.random.key(0), jXp, jnp.asarray(yp), jnp.int32(n), jparams,
        jnp.int32(3), jnp.float32(6.0))
    monkeypatch.undo()
    monkeypatch.setattr(torch, "rand", lambda *a, **k: _t(u))
    ptheta = tbolfi._make_theta_selector(spec, device=CPU)(
        0, Xp, _t(yp), n, params, 3, torch.tensor(6.0))
    monkeypatch.undo()
    np.testing.assert_allclose(_np(ptheta), np.asarray(jtheta), atol=2e-3)


def test_refit_schedule_and_segments_equal_jax(monkeypatch):
    """The port's schedule against the segments the JAX package's fused fit
    runs, recorded from its loop with the device programs stubbed out."""
    import jax.numpy as jnp
    import elfi_tpu as elfi
    from elfi_tpu.methods import bolfi as jbolfi
    from elfi_tpu.models import ma2 as jma2

    calls = []

    def programs(spec, init_fn, sim_fn):
        cap, d = spec.cap, spec.d

        def init(master):
            return (jnp.zeros((cap, d)), jnp.zeros(cap), jnp.zeros(4),
                    jnp.zeros(4))

        def segment(master, Xc, yc, u, n, ts, betas):
            calls.append(("segment", int(ts[0]), len(ts)))
            return Xc, yc, n + len(ts)

        def refit(master, Xc, yc, u, shapes, n, t):
            calls.append(("refit", int(t)))
            return u
        return init, segment, refit

    monkeypatch.setattr(jbolfi, "_fused_bo_programs", programs)
    m = jma2.get_model(seed_obs=4)
    for n_init, n_total, interval in ((16, 40, 8), (10, 37, 7), (12, 13, 5),
                                      (40, 500, 20), (5, 30, 1),
                                      (20, 20, 4)):
        calls.clear()
        bolfi = elfi.BOLFI(m["d"], batch_size=1, initial_evidence=n_init,
                           update_interval=interval,
                           bounds={"t1": (-2, 2), "t2": (-1, 1)}, seed=0)
        bolfi._fused_fit(n_total)
        want = []
        for start, length, refit in tbolfi.refit_schedule(
                n_init, n_total, interval)[1]:
            want.append(("segment", start, length))
            if refit:
                want.append(("refit", start + length - 1))
        assert calls == want, (n_init, n_total, interval)


def test_install_fused_gp_equals_jax():
    from elfi_tpu.methods import bolfi as jbolfi
    from elfi_tpu.methods.bo.gp import GPRegression as JGP
    X, y = _evidence(2, n=42)
    X, y = X[:40], y[:40]
    Xf = np.zeros((64, 2), np.float32)
    Xf[:40] = X
    yf = np.zeros(64, np.float32)
    yf[:40] = y
    uf = np.log(np.array([0.8, 0.25, 0.2, 0.02], np.float32))
    scales = np.array([0.25, 0.5], np.float32)
    jgp = JGP(["a", "b"], bounds=[(-2, 2), (-1, 1)])
    pgp = tgp.GPRegression(["a", "b"], bounds=[(-2, 2), (-1, 1)], device=CPU)
    jbolfi._install_fused_gp(jgp, Xf, yf, uf, 40, 16, scales)
    tbolfi._install_fused_gp(pgp, Xf, yf, uf, 40, 16, scales)
    np.testing.assert_array_equal(pgp.X, jgp.X)
    np.testing.assert_array_equal(pgp.Y, jgp.Y)
    assert set(pgp.params) == set(jgp.params)
    for k in pgp.params:
        np.testing.assert_array_equal(pgp.params[k], jgp.params[k])
    np.testing.assert_array_equal(pgp._prior_shapes, jgp._prior_shapes)
    x = _grid(2) * np.array([4, 2], np.float32) - np.array([2, 1], np.float32)
    _close(pgp.predict(x)[0], jgp.predict(x)[0], FACTOR_TOL, "mean")


# -- the acquisition and the posterior ----------------------------------------

def test_lcbsc_beta_and_host_acquisition(gps):
    from elfi_tpu.methods.bo.acquisition import LCBSC as JLCBSC
    jgp, pgp = gps
    jacq, pacq = JLCBSC(jgp, seed=0), LCBSC(pgp, seed=0)
    for t in (0, 1, 7, 459):
        assert pacq._beta(t) == jacq._beta(t)
    x = _grid(jgp.input_dim, 6, 8)
    _close(pacq.evaluate(x, t=3), jacq.evaluate(x, t=3), FACTOR_TOL, "LCB")
    _close(pacq.evaluate_gradient(x, t=3), jacq.evaluate_gradient(x, t=3),
           5e-3, "LCB gradient")
    pts = pacq.acquire(3, t=2)
    assert pts.shape == (3, jgp.input_dim)
    assert np.all((pts >= 0) & (pts <= 1))


def test_bolfi_posterior_equals_jax(gps):
    import elfi_tpu as elfi
    from elfi_tpu.methods.posteriors import BolfiPosterior as JPost
    from elfi_tpu.model.extensions import ModelPrior as JPrior
    jgp, pgp = gps
    d = jgp.input_dim
    jm, pm = elfi.Model(name=f"post_j{d}"), et.Model(name=f"post_p{d}")
    for i in range(d):
        elfi.Prior("uniform", 0, 1, model=jm, name=f"x{i}")
        et.Prior("uniform", 0, 1, model=pm, name=f"x{i}")
    names = [f"x{i}" for i in range(d)]
    jpost = JPost(jgp, threshold=-0.4, prior=JPrior(jm, parameter_names=names))
    ppost = BolfiPosterior(pgp, threshold=-0.4,
                           prior=et.ModelPrior(pm, parameter_names=names,
                                               device=CPU))
    x = np.vstack([_grid(d, 12, 9), np.full((1, d), 1.5, np.float32)])
    jl, pl = jpost.logpdf(x), ppost.logpdf(x)
    assert pl[-1] == jl[-1] == -np.inf
    # log Phi(z) ~ -z^2 / 2 far out (z down to about -11 here) multiplies
    # the float32 gap of z (about 1e-3 relative, as the variance's) by z
    np.testing.assert_allclose(pl[:-1], jl[:-1], rtol=3e-2, atol=1e-4)
    _close(ppost.gradient_logpdf(x[:-1]), jpost.gradient_logpdf(x[:-1]),
           5e-3, "gradient")
    np.testing.assert_array_equal(ppost.gradient_logpdf(x[-1]), np.zeros(d))
    _close(ppost._unnormalized_loglikelihood(x[:-1]),
           jpost._unnormalized_loglikelihood(x[:-1]), 1e-3, "loglik")
    # the threshold search: the GP mean's minimum, found on the device
    jt = JPost(jgp, prior=JPrior(jm, parameter_names=names), seed=0)
    pt = BolfiPosterior(pgp, prior=et.ModelPrior(pm, parameter_names=names,
                                                 device=CPU), seed=0)
    assert pt.threshold == pytest.approx(jt.threshold, abs=2e-3)


# -- a custom kernel ----------------------------------------------------------

def _matern32(lib):
    """Matern-3/2 over the kernel's own hyperparameters, in ``lib``."""
    def kernel(A, B, p):
        r2 = ((A[..., :, None, :] - B[..., None, :, :]) ** 2).sum(-1)
        r = lib.sqrt(r2 + 1e-12) * (3.0 ** 0.5) / p["lengthscale"]
        return p["variance"] * (1.0 + r) * lib.exp(-r)
    kernel.param_names = ("variance", "lengthscale")
    return kernel


def test_custom_kernel_gp_equals_jax():
    """A user kernel (the reference's GPy kernel object) through the same
    machinery: the port's GP on the JAX GP's evidence and MAP
    hyperparameters predicts as the JAX GP does; the fit, the gradients and
    the device closure run through the kernel."""
    import jax.numpy as jnp
    from elfi_tpu.methods.bo.gp import GPRegression as JGP
    rng = np.random.RandomState(1)
    X = rng.uniform(-2, 2, size=(25, 1))
    y = np.sin(2 * X[:, 0]) + 0.05 * rng.randn(25)
    init = {"variance": 1.0, "lengthscale": 0.8}
    jgp = JGP(["x"], bounds=[(-2, 2)], kernel=_matern32(jnp),
              kernel_params=init)
    jgp.update(X, y, optimize=True)
    pgp = tgp.GPRegression(["x"], bounds=[(-2, 2)], kernel=_matern32(torch),
                           kernel_params=init, device=CPU)
    pgp.update(X, y)
    pgp.params = {k: float(v) for k, v in jgp.params.items()}
    pgp._refactor()
    assert pgp.custom_kernel
    xs = np.linspace(-1.8, 1.8, 9)[:, None]
    jm, jv = jgp.predict(xs)
    pm, pv = pgp.predict(xs)
    _close(pm, jm, FACTOR_TOL, "mean")
    _close(pv, jv, FACTOR_TOL, "var")
    _close(pgp.predictive_gradients(xs)[0], jgp.predictive_gradients(xs)[0],
           1e-3, "d mean")
    mu_dev, _ = pgp.device_predict(noiseless=True, use_inverse=True)(_t(xs))
    np.testing.assert_allclose(_np(mu_dev), pm[:, 0], atol=1e-4)
    # the port's own MAP fit through the kernel
    pgp.update(np.array([[0.3]]), np.array([np.sin(0.6)]), optimize=True)
    assert pgp.n_evidence == 26
    assert np.all(np.isfinite(pgp.predict(xs)[0]))
    with pytest.raises(ValueError, match="kernel_params"):
        tgp.GPRegression(["x"], bounds=[(-2, 2)], kernel=_matern32(torch),
                         device=CPU)


@pytest.mark.parametrize("name", ["gp_mean_obj", "gp_neg_lcb_obj",
                                  "gp_neg_lcb_obj_inv"])
def test_module_level_objectives_equal_jax(gps, name):
    """The JAX module's names (``elfi_tpu/methods/bo/gp.py:104, 328-332``):
    the default bundle's objectives, at points of the grid."""
    import jax.numpy as jnp
    from elfi_tpu.methods.bo import gp as jgp_mod
    jgp, pgp = gps
    if jgp.fns.kernel is not jgp_mod.rbf_bias_kernel:
        pytest.skip("the fixture's GP has another kernel")
    jXp, jmask, jL, jalpha, jparams = jgp._factor
    Xp, mask, L, alpha, params = pgp._factor
    jargs, pargs = (jXp, jmask, jL, jalpha, jparams), (Xp, mask, L, alpha,
                                                       params)
    if name == "gp_neg_lcb_obj_inv":
        jargs = (jXp, jmask, jgp.fns.posterior_inverse(jL, jmask), jalpha,
                 jparams)
        pargs = (Xp, mask, pgp.fns.posterior_inverse(L, mask), alpha, params)
    beta = np.float32(7.5)
    jextra = () if name == "gp_mean_obj" else (jnp.float32(beta),)
    pextra = () if name == "gp_mean_obj" else (_t(beta),)
    assert getattr(tgp, name) is getattr(
        tgp.make_gp_fns(tgp.rbf_bias_kernel), name[3:])
    x = _grid(jgp.input_dim, 8, 4)
    jv = [getattr(jgp_mod, name)(jnp.asarray(r), *jargs, *jextra) for r in x]
    pv = [getattr(tgp, name)(_t(r), *pargs, *pextra) for r in x]
    _close(torch.stack(pv), np.stack(jv), VAR_INV_TOL, name)


def test_module_level_kernel_and_restarts_equal_jax(gps):
    from elfi_tpu.methods.bo import gp as jgp_mod
    jgp, pgp = gps
    assert tgp.gp_cross_cov is tgp.rbf_bias_kernel
    x = _grid(jgp.input_dim, 7, 2)
    _close(tgp.gp_cross_cov(_t(x), _t(x[:3]), pgp.params),
           jgp_mod.gp_cross_cov(x, x[:3], jgp.params), ELEM_RTOL,
           "gp_cross_cov")
    assert tgp.optimize_restarts_core is \
        tgp.make_gp_fns(tgp.rbf_bias_kernel).optimize_restarts_core
    Xp, yp, mask = pgp._padded()
    u0 = jgp._log_param_vector().astype(np.float32)
    shapes = _t(np.asarray(jgp._prior_shapes, np.float32))
    pu, pf = tgp.optimize_restarts_core(_t(u0[None]), Xp, yp, mask, shapes,
                                        torch.tensor(0.1), steps=20,
                                        const_params=pgp._const_params())
    qu, qf = pgp.fns.optimize_restarts_core(_t(u0[None]), Xp, yp, mask,
                                            shapes, torch.tensor(0.1),
                                            steps=20,
                                            const_params=pgp._const_params())
    assert torch.equal(pu, qu) and torch.equal(pf, qf)
