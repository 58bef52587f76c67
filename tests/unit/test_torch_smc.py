"""The SMC slice of the PyTorch port against the JAX package, on the same
numpy inputs: the vector-threshold merge, ``truncnorm`` and
``multivariate_normal``, ``ModelPrior``, the Gaussian-mixture proposal,
the density-ratio estimator, the Gaussian models and their committed
observations, and one SMC round's deterministic quantities from a JAX
population carried over by ``interop.population_from_numpy``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elfi_tpu as elfi
import elfi_tpu_torch as et
from elfi_tpu.methods import density_ratio_estimation as jax_dre
from elfi_tpu.methods.utils import GMDistribution as JaxGM
from elfi_tpu.model.extensions import ModelPrior as JaxModelPrior
from elfi_tpu.models import gauss as jax_gauss
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu.ops import distributions as jax_dists
from elfi_tpu.ops import topk as jax_topk
from elfi_tpu_torch.interop import population_from_numpy
from elfi_tpu_torch.methods import density_ratio_estimation as dre
from elfi_tpu_torch.methods.utils import GMDistribution, PreparedGM
from elfi_tpu_torch.model.extensions import ModelPrior
from elfi_tpu_torch.models import gauss, ma2
from elfi_tpu_torch.ops import distributions as dists

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


GAUSS2D = dict(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
               cov_matrix=np.eye(2))


# -- the vector-threshold repair ----------------------------------------------

def _adapted_ma2():
    """MA2 with an adaptive distance after one adaptation round, so its
    node outputs two distance columns."""
    m = ma2.get_model(seed_obs=4)
    et.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
    et.Rejection(m["ad"], batch_size=256, seed=1).sample(
        20, n_sim=512, bar=False)
    assert len(m["ad"].adaptive_state["w"]) == 2
    return m


def test_vector_threshold_sample_runs():
    """A vector threshold (one bound per distance column) reaches the merge
    as a float32 tensor; the parent commit raised TypeError here."""
    m = _adapted_ma2()
    rej = et.Rejection(m["ad"], batch_size=256, seed=2)
    res = rej.sample(30, threshold=np.array([np.inf, 2.0], np.float32),
                     bar=False)
    thr = rej._merge_threshold()
    assert isinstance(thr, torch.Tensor) and thr.dtype == torch.float32
    assert thr.device == rej.device and thr.tolist() == [np.inf, 2.0]
    assert rej.state["n_accepted"] >= 30
    assert res.outputs["ad"].shape == (30,)
    assert np.all(np.isfinite(res.outputs["ad"]))


@pytest.mark.parametrize("t", [0.5, 1.5])
def test_vector_threshold_accepts_as_jax(t):
    """The sampler's merge with its vector threshold keeps the rows that
    the JAX package's merge keeps with ``jnp.asarray(t, jnp.float32)``, on
    the same two-column distances."""
    m = _adapted_ma2()
    rej = et.Rejection(m["ad"], batch_size=64, seed=3)
    thr = np.array([np.inf, t], np.float32)
    rej.set_objective(40, threshold=thr)
    rng = np.random.default_rng(5)
    buffers_t = buffers_j = None
    for _ in range(3):
        batch = {"ad": rng.gamma(2.0, 0.6, (64, 2)).astype(np.float32),
                 "t1": rng.normal(size=64).astype(np.float32)}
        bt = {k: torch.tensor(v) for k, v in batch.items()}
        bj = {k: jnp.asarray(v) for k, v in batch.items()}
        if buffers_t is None:
            from elfi_tpu_torch.ops import topk
            buffers_t = topk.init_buffers(40, bt, "ad")
            buffers_j = jax_topk.init_buffers(40, bj, "ad")
        buffers_t, acc_t = rej._merge(buffers_t, bt, rej._merge_threshold())
        buffers_j, acc_j = jax_topk.make_merge_fn("ad")(
            buffers_j, bj, jnp.asarray(thr, jnp.float32))
        assert int(acc_t) == int(acc_j) == int(
            np.sum(np.all(batch["ad"] <= thr, axis=1)))
    for k in buffers_t:
        np.testing.assert_array_equal(_np(buffers_t[k]),
                                      np.asarray(buffers_j[k]), err_msg=k)


# -- distributions -------------------------------------------------------------

def _grid(n=200, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 4.0, n) \
        .astype(np.float32)


@pytest.mark.parametrize("params", [(0.01, 10.0, 0.0, 1.0),
                                    (-1.0, 1.5, 1.0, 2.0)])
def test_truncnorm_equals_jax(params):
    """logpdf, cdf and ppf on the same inputs (rtol 1e-5), -inf and nan
    where the JAX package gives them."""
    x = _grid()
    q = np.random.default_rng(1).uniform(-0.1, 1.1, 200).astype(np.float32)
    for name, arg in (("logpdf", x), ("cdf", x), ("ppf", q)):
        got = _np(getattr(dists.truncnorm, name)(torch.tensor(arg), *params))
        want = np.asarray(getattr(jax_dists.truncnorm, name)(
            jnp.asarray(arg), *params))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        assert got.dtype == want.dtype == np.float32


def test_truncnorm_rvs_support_and_moments():
    g = torch.Generator().manual_seed(0)
    x = _np(dists.truncnorm.rvs(0.01, 10.0, size=20000, generator=g))
    assert x.shape == (20000,) and np.all((x >= 0.01) & (x <= 10.0))
    ref = np.asarray(jax_dists.truncnorm.rvs(0.01, 10.0, size=20000,
                                             key=jax.random.key(0)))
    assert abs(x.mean() - ref.mean()) < 0.02
    assert abs(x.std() - ref.std()) < 0.02
    assert dists.from_name("truncnorm") is dists.truncnorm
    assert dists.from_name("multivariate_normal") is \
        dists.multivariate_normal


def test_multivariate_normal_equals_jax():
    """logpdf on the same inputs (rtol 1e-5); draws by their moments.  The
    JAX package's class has no cdf or ppf, so the port has none."""
    mean, cov = [0.5, -0.2], [[0.5, 0.1], [0.1, 0.3]]
    x = np.random.default_rng(2).normal(size=(100, 2)).astype(np.float32)
    got = _np(dists.multivariate_normal.logpdf(torch.tensor(x), mean, cov))
    want = np.asarray(jax_dists.multivariate_normal.logpdf(x, mean, cov))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    d = _np(dists.multivariate_normal.rvs(
        mean, cov, size=40000, generator=torch.Generator().manual_seed(3)))
    assert d.shape == (40000, 2)
    np.testing.assert_allclose(d.mean(0), mean, atol=0.02)
    np.testing.assert_allclose(np.cov(d, rowvar=False), cov, atol=0.02)


# -- ModelPrior ---------------------------------------------------------------

def _prior_pair(name):
    if name == "ma2":
        return (ModelPrior(ma2.get_model(seed_obs=4)),
                JaxModelPrior(jax_ma2.get_model(seed_obs=4)))
    if name == "gauss1d":
        return (ModelPrior(gauss.get_model(seed_obs=3)),
                JaxModelPrior(jax_gauss.get_model(seed_obs=3)))
    return (ModelPrior(gauss.get_model(**GAUSS2D)),
            JaxModelPrior(jax_gauss.get_model(**GAUSS2D)))


def _prior_points(name):
    """Rows inside and outside each prior's support."""
    rng = np.random.default_rng(7)
    if name == "ma2":
        x = np.column_stack([rng.uniform(-2.5, 2.5, 300),
                             rng.uniform(-1.5, 1.5, 300)])
    elif name == "gauss1d":
        x = np.column_stack([rng.uniform(-2, 10, 300),
                             rng.uniform(-1, 11, 300)])
    else:
        x = np.column_stack([rng.uniform(-2, 10, 300),
                             rng.uniform(-4, 8, 300)])
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["ma2", "gauss1d", "gauss2d"])
def test_model_prior_equals_jax(name):
    """logpdf (rtol 1e-5, -inf outside the support), gradient_logpdf
    (atol 1e-6; non-finite entries become 0 in both packages), pdf and box.

    Outside the support the autodiff gradient has no meaning and each
    package keeps what its backward pass gives, cleaned of non-finite
    entries.  On MA2 rows outside the triangle the port's is 0 in every
    entry, while JAX keeps t1's own term where only t2 is outside (its
    ``0 * inf`` in the backward pass of the indicator product comes out 0,
    autograd's nan), so those rows are checked for 0 only."""
    pt, pj = _prior_pair(name)
    x = _prior_points(name)
    lp_t, lp_j = pt.logpdf(x), np.asarray(pj.logpdf(x))
    outside = ~np.isfinite(lp_j)
    assert outside.any() and (~outside).any()
    np.testing.assert_array_equal(~np.isfinite(lp_t), outside)
    np.testing.assert_allclose(lp_t[~outside], lp_j[~outside], rtol=1e-5)
    assert np.all(lp_t[outside] == -np.inf)
    g_t, g_j = pt.gradient_logpdf(x), pj.gradient_logpdf(x)
    assert g_t.shape == x.shape and np.all(np.isfinite(g_t))
    same = ~outside if name == "ma2" else np.ones(len(x), bool)
    np.testing.assert_allclose(g_t[same], g_j[same], rtol=1e-5, atol=1e-6)
    if name == "ma2":
        assert np.all(g_t[outside] == 0.0)
    np.testing.assert_allclose(pt.pdf(x), pj.pdf(x), rtol=1e-5)
    assert np.ndim(pt.logpdf(x[:1])) == 0
    bt, bj = pt.box(), pj.box()
    if bj is None:
        assert bt is None
    else:
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["ma2", "gauss1d", "gauss2d"])
def test_model_prior_rvs_inside_support(name):
    pt, _ = _prior_pair(name)
    x = pt.rvs(size=500, seed=3)
    assert x.shape == (500, pt.dim)
    assert np.all(np.isfinite(pt.logpdf(x)))
    np.testing.assert_array_equal(x, pt.rvs(size=500, seed=3))
    assert not np.array_equal(x, pt.rvs(size=500, seed=4))
    assert pt.numerical_gradient_logpdf(x[0]).shape == (pt.dim,)


def test_model_prior_refuses_host_distributions():
    class HostDist(et.Distribution):
        host = True

    m = et.Model(name="host_prior")
    et.Prior(HostDist, model=m, name="a")
    # host priors are ported now: the prior builds, and only its device
    # density is refused, as in the JAX package
    prior = ModelPrior(m)
    assert prior.host
    with pytest.raises(ValueError, match="host"):
        prior.traceable_logpdf()


# -- GMDistribution -----------------------------------------------------------

def _mixture(seed=4):
    rng = np.random.default_rng(seed)
    means = rng.normal(0.3, 0.5, (40, 2))
    weights = rng.uniform(0.1, 1.0, 40)
    cov = np.diag([0.05, 0.02])
    return means, cov, weights


def test_gm_logpdf_equals_jax():
    means, cov, weights = _mixture()
    x = np.random.default_rng(5).normal(0.3, 0.7, (300, 2))
    got = _np(GMDistribution.logpdf(x, means, cov, weights))
    want = np.asarray(JaxGM.logpdf(x, means, cov, weights))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    prepared = GMDistribution.prepare(means, cov, weights)
    np.testing.assert_array_equal(
        _np(GMDistribution.logpdf(torch.tensor(x), prepared)), got)
    np.testing.assert_allclose(_np(GMDistribution.pdf(x, means, cov,
                                                      weights)),
                               np.exp(want), rtol=1e-5)


def test_gm_rvs_statistics_and_support():
    """Draws follow the mixture (mean and covariance of a mixture with
    shared covariance), and with the MA2 prior every row lies inside its
    triangle; one generator seed gives one draw."""
    means, cov, weights = _mixture()
    w = weights / weights.sum()
    g = torch.Generator().manual_seed(0)
    x = _np(GMDistribution.rvs(means, cov, weights, size=50000, generator=g))
    mu = w @ means
    np.testing.assert_allclose(x.mean(0), mu, atol=0.01)
    want_cov = cov + (means - mu).T @ ((means - mu) * w[:, None])
    np.testing.assert_allclose(np.cov(x, rowvar=False), want_cov, atol=0.01)

    prior = ModelPrior(ma2.get_model(seed_obs=4))
    wide = (np.array([[0.3, 0.2], [1.5, 0.8]]), np.diag([0.4, 0.3]),
            np.array([0.5, 0.5]))

    def draw(seed):
        return _np(GMDistribution.rvs(
            *wide, size=256, prior_logpdf=prior.traceable_logpdf(),
            generator=torch.Generator().manual_seed(seed)))

    x = draw(42)
    assert np.all(np.isfinite(prior.logpdf(x)))
    np.testing.assert_array_equal(x, draw(42))
    assert not np.array_equal(x, draw(43))


def test_gm_rvs_raises_when_support_is_unreachable():
    means, cov, weights = _mixture()
    with pytest.raises(RuntimeError, match="prior support"):
        GMDistribution.rvs(means, cov, weights, size=8,
                           prior_logpdf=lambda x: torch.full(
                               (x.shape[0],), -np.inf),
                           generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Generator"):
        GMDistribution.rvs(means, cov, weights, size=8)


def test_gm_takes_a_tuple_of_rows_as_means():
    """Only a PreparedGM is read as a prepared mixture: means given as a
    tuple of rows are means, as an array of them is."""
    means, cov, weights = _mixture()
    x = np.random.default_rng(7).normal(0.3, 0.7, (50, 2))
    rows = tuple(tuple(r) for r in means)
    np.testing.assert_array_equal(
        _np(GMDistribution.logpdf(x, rows, cov, weights)),
        _np(GMDistribution.logpdf(x, means, cov, weights)))
    a = GMDistribution.rvs(rows, cov, weights, size=64,
                           generator=torch.Generator().manual_seed(3))
    b = GMDistribution.rvs(means, cov, weights, size=64,
                           generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    prepared = GMDistribution.prepare(means, cov, weights)
    assert isinstance(prepared, PreparedGM)
    assert torch.equal(GMDistribution.rvs(
        prepared, size=64, generator=torch.Generator().manual_seed(3)), b)


# -- density-ratio estimation -------------------------------------------------

def _dre_inputs(seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.5, (300, 2))
    y = rng.normal(0.2, 1.0, (300, 2))
    wx = rng.uniform(0.5, 1.5, 300)
    wy = rng.uniform(0.5, 1.5, 300)
    return x, y, wx, wy


@pytest.mark.parametrize("max_iter,abs_tol", [(150, 0.01), (60, 1e-9)])
def test_density_ratio_equals_jax(max_iter, abs_tol):
    """fit, then max_ratio and w on the same x, y, weights and sigma.  Both
    compute in float32 (sums in another order), so the ratios agree to rtol
    1e-4; the second case runs every iteration without converging."""
    x, y, wx, wy = _dre_inputs()
    sigma = dre.calculate_densratio_basis_sigma(0.5, 1.0)
    assert sigma == jax_dre.calculate_densratio_basis_sigma(0.5, 1.0)
    kw = dict(n=50, epsilon=0.001, max_iter=max_iter, abs_tol=abs_tol)
    est_t = dre.DensityRatioEstimation(**kw)
    est_j = jax_dre.DensityRatioEstimation(**kw)
    est_t.fit(x, y, weights_x=wx, weights_y=wy, sigma=sigma)
    est_j.fit(x, y, weights_x=wx, weights_y=wy, sigma=sigma)
    np.testing.assert_allclose(_np(est_t._alpha), est_j._alpha, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(est_t.max_ratio(), est_j.max_ratio(),
                               rtol=1e-4)
    probe = np.random.default_rng(8).normal(0, 0.7, (64, 2))
    np.testing.assert_allclose(est_t.w(probe), est_j.w(probe), rtol=1e-4,
                               atol=1e-6)


def test_density_ratio_lcv_picks_the_jax_sigma():
    x, y, wx, wy = _dre_inputs(9)
    kw = dict(n=40, epsilon=0.001, max_iter=80, abs_tol=0.01, fold=3,
              optimize=True)
    est_t = dre.DensityRatioEstimation(**kw)
    est_j = jax_dre.DensityRatioEstimation(**kw)
    cand = [0.1, 0.3, 1.0, 3.0]
    est_t.fit(x, y, weights_x=wx, weights_y=wy, sigma=cand)
    est_j.fit(x, y, weights_x=wx, weights_y=wy, sigma=cand)
    assert est_t.sigma == est_j.sigma
    with pytest.raises(ValueError, match="larger"):
        dre.DensityRatioEstimation(n=400).fit(x, y, sigma=1.0)


def test_adaptive_threshold_smc_keeps_the_estimator_on_its_device():
    """The default estimator is made on the sampler's device; a given one
    on another device is refused, not moved."""
    node = ma2.get_model(seed_obs=4)["d"]
    smc = et.AdaptiveThresholdSMC(node, batch_size=64, device="cpu")
    assert smc.densratio.device == torch.device("cpu")
    est = dre.DensityRatioEstimation(n=20, device="cpu")
    assert et.AdaptiveThresholdSMC(node, batch_size=64,
                                   densratio_estimation=est).densratio is est
    with pytest.raises(ValueError, match="densratio_estimation is on"):
        et.AdaptiveThresholdSMC(node, batch_size=64,
                                densratio_estimation=dre.DensityRatioEstimation(
                                    n=20, device="meta"))


# -- the Gaussian models ------------------------------------------------------

@pytest.mark.parametrize("kw", [GAUSS2D, dict(seed_obs=3),
                                dict(seed_obs=None)])
def test_committed_gauss_observations_are_the_jax_draw(kw):
    want = jax_gauss.get_model(**kw).observed["gauss"]
    got = gauss.get_model(**kw).observed["gauss"]
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32


def test_unstored_gauss_observations_raise():
    """The settings no file holds, once refused, give the JAX package's
    observed sample (rtol 1e-6), the n-D model with any SPD covariance."""
    for kw in (dict(seed_obs=5), dict(n_obs=20),
               dict(nd_mean=True, cov_matrix=np.eye(2)),      # [4, 4]
               {**GAUSS2D, "cov_matrix": [[2., .3], [.3, .5]]}):
        want = jax_gauss.get_model(**kw).observed["gauss"]
        got = gauss.get_model(**kw).observed["gauss"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_gauss_summaries_and_distance_equal_jax():
    """ss_mean, ss_var and euclidean_multidim on the same samples
    (rtol 1e-6)."""
    rng = np.random.default_rng(10)
    y1 = rng.normal(4.0, 0.4, (64, 50)).astype(np.float32)
    y2 = rng.normal(4.0, 1.0, (64, 50, 2)).astype(np.float32)
    for y in (y1, y2):
        for fn in ("ss_mean", "ss_var"):
            np.testing.assert_allclose(
                _np(getattr(gauss, fn)(torch.tensor(y))),
                np.asarray(getattr(jax_gauss, fn)(jnp.asarray(y))),
                rtol=1e-6, err_msg=fn)
    s = [gauss.ss_mean(torch.tensor(y2)), gauss.ss_var(torch.tensor(y2))]
    obs = [v[:1] for v in s]
    got = _np(gauss.euclidean_multidim(*s, observed=obs))
    want = np.asarray(jax_gauss.euclidean_multidim(
        *(np.asarray(v) for v in s), observed=[np.asarray(v) for v in obs]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kw", [GAUSS2D, dict(seed_obs=3)])
def test_gauss_graph_equals_jax(kw):
    mt, mj = gauss.get_model(**kw), jax_gauss.get_model(**kw)
    assert list(mt.dag.nodes) == list(mj.dag.nodes)
    assert mt.parameter_names == mj.parameter_names
    out = mt.generate(batch_size=16, seed=1)
    ref = mj.generate(batch_size=16, seed=1)
    for k in ("gauss", "ss_mean", "ss_var", "d"):
        assert out[k].shape == np.shape(ref[k]), k
        assert np.all(np.isfinite(out[k]))


# -- one SMC round from a JAX population --------------------------------------

def test_next_round_from_a_jax_population():
    """Carry the JAX package's round-1 population over, then weigh its
    round-2 population in the port: the importance weights (rtol 1e-4:
    exp of a difference of float32 log-densities), ``cov`` (rtol 1e-4) and
    the round-3 quantile threshold (exact)."""
    m_j = jax_ma2.get_model(seed_obs=4)
    smc_j = elfi.SMC(m_j["d"], batch_size=500, seed=12)
    res = smc_j.sample(100, quantiles=[0.3, 0.5, 0.5], bar=False,
                       fused=False)
    pops = res.populations
    names = pops[0].parameter_names

    def carried(pop):
        return population_from_numpy(
            {k: np.asarray(v) for k, v in pop.outputs.items()},
            np.asarray(pop.weights), pop.meta["cov"], names,
            discrepancy_name="d", threshold=pop.meta["threshold"],
            n_batches=pop.meta["n_batches"])

    smc_t = et.SMC(ma2.get_model(seed_obs=4)["d"], batch_size=500, seed=12)
    smc_t._populations = [carried(pops[0])]
    smc_t._spawn_round_rejection(1)          # round 1's mixture, prepared
    theta, w, cov = smc_t._weigh_population(carried(pops[1]))
    np.testing.assert_array_equal(theta, pops[1].means)
    assert w.dtype == pops[1].weights.dtype
    np.testing.assert_allclose(w, pops[1].weights, rtol=1e-4)
    np.testing.assert_allclose(cov, pops[1].meta["cov"], rtol=1e-4)
    smc_t._populations.append(carried(pops[1]))
    assert smc_t._quantile_threshold(2, 0.5) == \
        smc_j.schedule.thresholds[2]
