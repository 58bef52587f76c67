"""BOLFIRE in the PyTorch port on the CPU: the ``-log prior`` cost of the
fused acquisition, the selector with that cost and ``BolfirePosterior``
against the JAX package's on the same inputs, then the fit end to end at
the JAX package's test points (``tests/functional/test_bolfire.py``): g-and-k
fused and on the host, MA2 (whose triangle prior is not the bounds box, so
the fused fit adds the cost and draws its initial thetas from the prior
program), the fused fit's determinism, and the three repairs of the JAX
package's fused fit (rounds below the initial evidence, the scaler in the
round attributes, ``last_GP_update``)."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.interop import gp_from_numpy
from elfi_tpu_torch.methods import bolfi as tbolfi
from elfi_tpu_torch.methods.bolfire import _prior_cost_fn
from elfi_tpu_torch.methods.posteriors import BolfirePosterior
from elfi_tpu_torch.models import gnk, ma2

torch.set_num_threads(1)

CPU = torch.device("cpu")
MA2_BOUNDS = {"t1": (-2, 2), "t2": (-1, 1)}
GNK_BOUNDS = {p: (0.0, 10.0) for p in ("A", "B", "g", "k")}


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


# -- the pieces against the JAX package ------------------------------------

def test_prior_cost_fn_sanitized_outside_support():
    """The cost is finite with a finite gradient inside MA2's triangle,
    1e30 (float32) with gradient 0 outside it, and equal to the JAX
    package's inside."""
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods.bolfire import _prior_cost_fn as jcost_fn
    from elfi_tpu.model.extensions import ModelPrior as JPrior
    from elfi_tpu.models import ma2 as jma2
    cost = _prior_cost_fn(et.ModelPrior(ma2.get_model(seed_obs=4),
                                        device=CPU))
    rows = torch.tensor([[0.6, 0.2], [-0.4, -0.3], [-3.0, 0.0]],
                        requires_grad=True)
    c = cost(rows)
    g, = torch.autograd.grad(c.sum(), rows)
    c = c.detach()
    assert np.all(np.isfinite(_np(c[:2]))) and float(c[0]) < 1e29
    assert float(c[2]) == float(np.float32(1e30))
    assert np.all(np.isfinite(_np(g[:2])))
    assert torch.equal(g[2], torch.zeros(2))
    jcost = jcost_fn(JPrior(jma2.get_model(seed_obs=4)))
    for i in range(2):
        jc, jg = jax.value_and_grad(jcost)(jnp.asarray(_np(rows[i]),
                                                       jnp.float32))
        np.testing.assert_allclose(float(c[i]), float(jc), rtol=1e-6)
        np.testing.assert_allclose(_np(g[i]), np.asarray(jg), atol=1e-6)


def _evidence(n=30, seed=0):
    """A log discrepancy with its minimum near (0.6, 0.2), inside the
    triangle prior."""
    rng = np.random.RandomState(seed)
    X = np.column_stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-0.8, 0.8, n)])
    X[:, 1] = np.clip(X[:, 1], -1 + np.abs(X[:, 0]) / 2 + 0.05,
                      1 - np.abs(X[:, 0]) / 2 - 0.05)
    y = np.log(0.05 + (X[:, 0] - 0.6) ** 2 + 2 * (X[:, 1] - 0.2) ** 2) \
        + 0.05 * rng.randn(n)
    return X, y


@pytest.fixture(scope="module")
def gps():
    from elfi_tpu.methods.bo.gp import GPRegression
    X, y = _evidence()
    jgp = GPRegression(["t1", "t2"], bounds=list(MA2_BOUNDS.values()))
    jgp.update(X, y, optimize=True)
    pgp = gp_from_numpy(jgp.X, jgp.Y, jgp.params, jgp.bounds, device=CPU,
                        prior_shapes=jgp._prior_shapes)
    return jgp, pgp


def _box_models():
    """The same uniform box prior over (t1, t2) in both packages."""
    import elfi_tpu as elfi
    models = []
    for lib in (elfi, et):
        m = lib.Model(name="box")
        lib.Prior("uniform", -2, 4, model=m, name="t1")
        lib.Prior("uniform", -1, 2, model=m, name="t2")
        models.append(m)
    return models


@pytest.mark.parametrize("prior_kind", ["box", "triangle"])
def test_bolfire_posterior_equals_jax(gps, prior_kind):
    """``logpdf`` (``-mu + log prior``) and its gradient on the same GP,
    inside and outside the prior's support: to atol 1e-4 (the means of
    the two packages' factors)."""
    from elfi_tpu.methods.posteriors import BolfirePosterior as JPost
    from elfi_tpu.model.extensions import ModelPrior as JPrior
    from elfi_tpu.models import ma2 as jma2
    jgp, pgp = gps
    if prior_kind == "box":
        jm, pm = _box_models()
    else:
        jm, pm = jma2.get_model(seed_obs=4), ma2.get_model(seed_obs=4)
    jpost = JPost(["t1", "t2"], jgp, JPrior(jm))
    post = BolfirePosterior(["t1", "t2"], pgp, et.ModelPrior(pm, device=CPU))
    x = np.array([[0.6, 0.2], [-0.5, 0.1], [1.2, -0.3], [1.9, -0.9]],
                 np.float32)
    lp, jlp = post.logpdf(x), np.asarray(jpost.logpdf(x))
    finite = np.isfinite(jlp)
    assert finite.sum() == (4 if prior_kind == "box" else 2)
    np.testing.assert_array_equal(np.isfinite(lp), finite)
    np.testing.assert_allclose(lp[finite], jlp[finite], atol=1e-4)
    np.testing.assert_allclose(post.gradient_logpdf(x)[finite],
                               np.asarray(jpost.gradient_logpdf(x))[finite],
                               atol=1e-3)
    assert post.logpdf(x[0]) == pytest.approx(float(lp[0]), rel=1e-5)
    np.testing.assert_allclose(post.pdf(x[:1]), np.exp(lp[:1]), rtol=1e-5)


def test_theta_selector_with_cost_equals_jax(gps, monkeypatch):
    """Both selectors with the MA2 prior's cost from the same injected
    uniform starts (some outside the triangle), no acquisition noise and no
    epsilon draws: the same acquired point."""
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods import bolfi as jbolfi
    from elfi_tpu.methods.bolfire import _prior_cost_fn as jcost_fn
    from elfi_tpu.model.extensions import ModelPrior as JPrior
    from elfi_tpu.models import ma2 as jma2
    jgp, pgp = gps
    jXp, _, _, _, jparams = jgp._factor
    Xp, _, _, _, params = pgp._factor
    cap = Xp.shape[0]
    n = jgp.n_evidence
    yp = np.zeros(cap, np.float32)
    yp[:n] = jgp.Y[:, 0]
    u = np.random.RandomState(7).rand(10, 2).astype(np.float32)
    spec = (cap, 2, 10, 1000, (-2.0, -1.0), (2.0, 1.0), None, 0.0)
    jcost = jcost_fn(JPrior(jma2.get_model(seed_obs=4)))
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    jtheta = jbolfi._make_theta_selector(spec, jcost)(
        jax.random.key(0), jXp, jnp.asarray(yp), jnp.int32(n), jparams,
        jnp.int32(3), jnp.float32(6.0))
    monkeypatch.undo()
    cost = _prior_cost_fn(et.ModelPrior(ma2.get_model(seed_obs=4),
                                        device=CPU))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(u))
    theta = tbolfi._make_theta_selector(spec, cost, device=CPU)(
        0, Xp, torch.as_tensor(yp), n, params, 3, torch.tensor(6.0))
    monkeypatch.undo()
    np.testing.assert_allclose(_np(theta), np.asarray(jtheta), atol=2e-3)


# -- the fit end to end ----------------------------------------------------

def _gnk_bolfire(seed=5, **kw):
    m = gnk.get_model(n_obs=50, seed_obs=2)
    return et.BOLFIRE(m, n_training_data=100, feature_names=["ss_order"],
                      bounds=GNK_BOUNDS, n_initial_evidence=8, seed=seed,
                      device="cpu", **kw)


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "host"])
def gnk_fitted(request):
    # the model draws its observed data on the global backend's device,
    # and a module's fixture runs before the per-test CPU client is set
    et.set_client("native", device="cpu")
    bolfire = _gnk_bolfire()
    assert bolfire._fused_eligible()
    bolfire.fit(n_evidence=12, bar=False, fused=request.param)
    return bolfire


def test_bolfire_gnk_fit_and_sample(gnk_fitted):
    """``test_bolfire_gnk_smoke``'s point on both paths."""
    bolfire = gnk_fitted
    gp = bolfire.target_model
    assert gp.n_evidence == 12 and bolfire.n_evidence == 12
    assert len(bolfire.classifier_attributes) == 12
    assert bolfire.state["n_sim"] == 12 * 100
    ev = np.asarray(gp.X)
    assert np.all((ev >= 0.0) & (ev <= 10.0))
    assert np.all(np.isfinite(gp.Y))
    res = bolfire.sample(100, n_chains=2, bar=False)
    assert isinstance(res, et.BolfireSample)
    arr = res.samples_array
    assert arr.shape == (100, 4) and np.all(np.isfinite(arr))
    assert np.all((arr >= 0.0) & (arr <= 10.0))


def test_round_attributes_give_the_log_ratio(gnk_fitted):
    """Each round's attributes hold the scaler's mean and scale, so they
    give the round's log-ratio at the observed features: minus the GP's
    target of that round."""
    bolfire = gnk_fitted
    obs = bolfire.observed[0].astype(np.float64)
    for attrs, y in zip(bolfire.classifier_attributes,
                        bolfire.target_model.Y[:, 0]):
        p = attrs["parameters"]
        z = ((obs - np.asarray(p["mean_"])) / np.asarray(p["scale_"])) \
            @ np.asarray(p["coef_"][0]) + p["intercept_"][0]
        assert -z == pytest.approx(y, abs=1e-4 * max(1.0, abs(y)))


def test_bolfire_fused_fit_is_deterministic():
    """One seed gives one fused fit, bit for bit; another seed another."""
    fits = []
    for seed in (5, 5, 6):
        bolfire = _gnk_bolfire(seed=seed)
        bolfire.fit(n_evidence=10, bar=False)
        fits.append(bolfire)
    a, b, c = (f.target_model for f in fits)
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.Y, b.Y)
    assert fits[0].classifier_attributes == fits[1].classifier_attributes
    assert not np.array_equal(a.X, c.X)


def test_fewer_rounds_than_initial_evidence_run_on_the_host():
    """The JAX package's fused fit would run every initial round and count
    only n_evidence of them; here the fit runs n_evidence rounds on the
    host."""
    bolfire = _gnk_bolfire()
    with pytest.raises(ValueError, match="not eligible"):
        bolfire.fit(n_evidence=5, bar=False, fused=True)
    bolfire.fit(n_evidence=5, bar=False)
    assert bolfire.target_model.n_evidence == 5
    assert len(bolfire.classifier_attributes) == 5
    assert bolfire.state["n_sim"] == 5 * 100
    assert bolfire.state["n_batches"] == 5


@pytest.fixture(scope="module")
def ma2_fitted():
    """The JAX package's MA2 point: a triangle prior, so the fused fit adds
    the prior cost and draws its initial thetas from the prior program."""
    # the model draws its observed data on the global backend's device,
    # and a module's fixture runs before the per-test CPU client is set
    et.set_client("native", device="cpu")
    m = ma2.get_model(seed_obs=4)
    bolfire = et.BOLFIRE(m, n_training_data=100, batch_size=100,
                         bounds=MA2_BOUNDS, n_initial_evidence=5,
                         update_interval=5, seed=11, device="cpu")
    assert bolfire._fused_eligible() and bolfire._fused_box() is None
    bolfire.fit(n_evidence=12, bar=False)
    return bolfire


def test_bolfire_ma2_fit_and_sample(ma2_fitted):
    bolfire = ma2_fitted
    gp = bolfire.target_model
    assert gp.n_evidence == 12 and len(bolfire.classifier_attributes) == 12
    # every evidence point inside the triangle
    assert np.all(np.isfinite(bolfire.prior.logpdf(gp.X)))
    post = bolfire.extract_result()
    assert np.isfinite(post.logpdf(np.array([0.6, 0.2], np.float32)))
    maps = post.map_estimates
    assert set(maps) == {"t1", "t2"}
    res = bolfire.sample(200, n_chains=2, bar=False)
    assert res.chains.shape == (2, 200, 2)
    assert np.all(np.abs(res.sample_means_array) < 3)


def test_last_gp_update_is_the_last_refit(ma2_fitted):
    """5 initial points, a refit every 5: the one refit comes at 10, so a
    continued host fit refits at 15, as the host loop would (the JAX
    package records 12)."""
    assert ma2_fitted.state["last_GP_update"] == 10
    assert not ma2_fitted._should_optimize()
