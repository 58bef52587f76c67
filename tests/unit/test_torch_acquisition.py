"""The variance acquisitions of the PyTorch port (``MaxVar``, ``RandMaxVar``,
``ExpIntVar``) against the JAX package's on the same inputs: the indicator
moments, MaxVar's value and autograd gradient, ExpIntVar's lookahead state,
loss and gradient, on one GP carried across with ``gp_from_numpy`` and the
MA2 prior (a triangle, not a box); each gradient against central
differences, as the JAX package's ``test_bolfi.py`` checks it; RandMaxVar
and the constrained host path in bounds and finite; and a BOLFI host-loop
fit with each rule through the entry point.

Both packages compute in float32 and take their own orders in the GP's
factor and inverse, so each comparison states the tolerance that float32
rounding on this data allows.
"""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.interop import gp_from_numpy
from elfi_tpu_torch.methods.bo import acquisition as tacq
from elfi_tpu_torch.models import ma2

torch.set_num_threads(1)

BOUNDS = [(-2.0, 2.0), (-1.0, 1.0)]
CPU = torch.device("cpu")
# float32 elementwise: the normal CDF and Owen's T quadrature
ELEM_TOL = 2e-6
# values through the GP's cached inverse (its quadratic form cancels down
# to the noise), relative to the largest value over the rows
GP_TOL = 2e-3


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _close(a, b, tol=GP_TOL, what=""):
    a, b = _np(a), _np(b)
    scale = max(np.max(np.abs(b)), 1e-30)
    gap = np.max(np.abs(a - b)) / scale
    assert gap <= tol, f"{what}: max gap {gap} of the largest entry {scale}"


def _evidence(n=30, seed=0):
    """MA2-like evidence: a log discrepancy with its minimum near (0.6,
    0.2), inside the triangle prior."""
    rng = np.random.RandomState(seed)
    X = np.column_stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-0.8, 0.8, n)])
    X[:, 1] = np.clip(X[:, 1], -1 + np.abs(X[:, 0]) / 2 + 0.05,
                      1 - np.abs(X[:, 0]) / 2 - 0.05)
    y = np.log(0.05 + (X[:, 0] - 0.6) ** 2 + 2 * (X[:, 1] - 0.2) ** 2) \
        + 0.05 * rng.randn(n)
    return X, y


@pytest.fixture(scope="module")
def pair():
    """A JAX GP and prior and the port's GP on the same evidence and
    hyperparameters, with the port's MA2 prior."""
    import elfi_tpu as elfi
    from elfi_tpu.methods.bo.gp import GPRegression
    from elfi_tpu.models import ma2 as jma2
    X, y = _evidence()
    jgp = GPRegression(["t1", "t2"], bounds=BOUNDS)
    jgp.update(X, y, optimize=True)
    jprior = elfi.ModelPrior(jma2.get_model(seed_obs=4))
    pgp = gp_from_numpy(jgp.X, jgp.Y, jgp.params, jgp.bounds, device=CPU,
                        prior_shapes=jgp._prior_shapes)
    pgp.parameter_names = ["t1", "t2"]
    # the model draws its observed data on the global backend's device,
    # and a module's fixture runs before the per-test CPU client is set
    et.set_client("native", device="cpu")
    pprior = et.ModelPrior(ma2.get_model(seed_obs=4), device=CPU)
    return jgp, jprior, pgp, pprior


THETAS = np.array([[0.4, 0.1], [-0.5, 0.3], [1.2, -0.3], [0.6, 0.2],
                   [-1.1, -0.2]], np.float32)


def test_indicator_moments_equal_jax():
    from elfi_tpu.methods.bo.acquisition import _indicator_moments as jim
    rng = np.random.RandomState(0)
    mean = rng.normal(0, 1, 40).astype(np.float32)
    var = rng.uniform(0.01, 2, 40).astype(np.float32)
    for eps, noise in ((0.1, 0.05), (-0.5, 0.3), (1.0, 1e-3)):
        j1, j2 = jim(np.float32(eps), mean, var, np.float32(noise))
        t1, t2 = tacq._indicator_moments(
            torch.tensor(eps), torch.as_tensor(mean), torch.as_tensor(var),
            torch.tensor(noise))
        np.testing.assert_allclose(_np(t1), np.asarray(j1), atol=ELEM_TOL)
        np.testing.assert_allclose(_np(t2), np.asarray(j2), atol=ELEM_TOL)


def _maxvar_pair(pair, cls_name="MaxVar", **kw):
    from elfi_tpu.methods.bo import acquisition as jacq
    jgp, jprior, pgp, pprior = pair
    j = getattr(jacq, cls_name)(jgp, prior=jprior, seed=0, **kw)
    p = getattr(tacq, cls_name)(pgp, prior=pprior, seed=0, **kw)
    j._update_eps()
    p._update_eps()
    assert p.eps == j.eps
    return j, p


def test_maxvar_value_and_gradient_equal_jax(pair):
    j, p = _maxvar_pair(pair)
    _close(p.evaluate(THETAS), j.evaluate(THETAS), what="MaxVar value")
    _close(p.evaluate_gradient(THETAS), j.evaluate_gradient(THETAS),
           tol=5 * GP_TOL, what="MaxVar gradient")
    # the descent's objective: -log of the value
    obj, args = p._traced(0)
    jobj, jargs = j._traced(0)
    import jax
    jvals = [float(jobj(jax.numpy.asarray(th), *jargs)) for th in THETAS]
    with torch.no_grad():
        pvals = obj(torch.as_tensor(THETAS), *args)
    np.testing.assert_allclose(_np(pvals), jvals, atol=1e-3)


def test_expintvar_state_loss_and_gradient_equal_jax(pair):
    import jax.numpy as jnp
    from elfi_tpu.methods.bo.acquisition import _lookahead_state_fn as jstate
    j, p = _maxvar_pair(pair, "ExpIntVar")
    np.testing.assert_array_equal(p._points, j._points)
    j._refresh_state(t=1)
    p._refresh_state(t=1)
    jst = jstate(pair[0].fns)(*j._gp_args(), jnp.asarray(j._points,
                                                         jnp.float32))
    for name, a, b in zip(("mean_p", "var_p", "kinv_kxp", "phi_p"),
                          p._state[1:], jst):
        _close(a, b, what=name)
    _close(p._weights, j._weights, what="weights")
    _close(p.evaluate(THETAS), j.evaluate(THETAS), what="ExpIntVar loss")
    _close(p.evaluate_gradient(THETAS), j.evaluate_gradient(THETAS),
           tol=5 * GP_TOL, what="ExpIntVar gradient")
    # outside the prior's triangle the loss is float32's largest value
    out = np.array([[1.9, -0.9]], np.float32)
    assert p.evaluate(out)[0] == np.finfo(np.float32).max


@pytest.mark.parametrize("cls_name", ["MaxVar", "ExpIntVar"])
def test_gradient_matches_numeric(pair, cls_name):
    _, p = _maxvar_pair(pair, cls_name)
    if cls_name == "ExpIntVar":
        p._refresh_state(t=1)
    thetas = THETAS[:3].astype(np.float64)
    grads = p.evaluate_gradient(thetas)
    assert grads.shape == (3, 2)
    h = 1e-3
    for k in range(2):
        shift = np.zeros(2)
        shift[k] = h
        num = (np.ravel(p.evaluate(thetas + shift))
               - np.ravel(p.evaluate(thetas - shift))) / (2 * h)
        scale = np.maximum(np.abs(num), 1e-7)
        np.testing.assert_allclose(grads[:, k] / scale, num / scale,
                                   atol=0.05)


def _in_bounds(pts):
    for i, (lo, hi) in enumerate(BOUNDS):
        assert np.all((pts[:, i] >= lo) & (pts[:, i] <= hi))
    assert np.all(np.isfinite(pts))


@pytest.mark.parametrize("cls_name,kw", [
    ("MaxVar", {}), ("ExpIntVar", {}),
    ("RandMaxVar", {"n_samples": 20}),
    ("RandMaxVar", {"n_samples": 20, "sampler": "metropolis",
                    "sigma_proposals": {"t1": 0.2, "t2": 0.1}}),
    ("ExpIntVar", {"integration": "importance", "n_samples": 20,
                   "n_samples_imp": 10})])
def test_acquire_in_bounds(pair, cls_name, kw):
    _, _, pgp, pprior = pair
    acq = getattr(tacq, cls_name)(pgp, prior=pprior, seed=0, noise_var=0.01,
                                  **kw)
    pts = acq.acquire(1, t=2)
    assert pts.shape == (1, 2)
    _in_bounds(pts)


@pytest.mark.parametrize("cls_name", ["MaxVar", "ExpIntVar"])
def test_constrained_host_path(pair, cls_name):
    """The SLSQP host path honours a constraint: t1 + t2 <= 0.5."""
    _, _, pgp, pprior = pair
    con = {"type": "ineq", "fun": lambda x: 0.5 - x[0] - x[1]}
    acq = getattr(tacq, cls_name)(pgp, prior=pprior, seed=0, n_inits=3,
                                  max_opt_iters=50, constraints=(con,))
    pts = acq.acquire(2, t=1)
    assert pts.shape == (2, 2)
    assert np.all(pts.sum(axis=1) <= 0.5 + 1e-5)
    _in_bounds(pts)


@pytest.mark.parametrize("cls_name,kw", [
    ("MaxVar", {}), ("RandMaxVar", {"n_samples": 20}), ("ExpIntVar", {})])
def test_bolfi_host_loop_with_variance_acquisition(cls_name, kw):
    """``BOLFI(..., acquisition_method=...)`` runs the host loop with the
    rule; every acquired point lies in the bounds and the GP stays
    finite."""
    m = ma2.get_model(seed_obs=4)
    et.Operation(torch.log, m["d"], model=m, name="log_d")
    gp = et.GPRegression(["t1", "t2"], bounds=BOUNDS, device="cpu")
    prior = et.ModelPrior(m, device="cpu")
    acq = getattr(tacq, cls_name)(gp, prior=prior, seed=1, **kw)
    bolfi = et.BOLFI(m["log_d"], batch_size=1, initial_evidence=10,
                     update_interval=2, target_model=gp,
                     acquisition_method=acq, seed=1, device="cpu")
    assert not bolfi._fused_eligible()
    bolfi.fit(n_evidence=13, bar=False)
    assert gp.n_evidence == 13
    _in_bounds(gp.X)
    assert np.all(np.isfinite(gp.Y))
