"""ROMC in the PyTorch port end to end on the CPU: the port's versions of
the JAX package's ``tests/functional/test_romc.py`` (marked ``slow`` there)
on the same 1-D Gaussian data, each region also held to its analytic
bound, the BO path and its surrogate posterior, g-and-k, and the MA2
accuracy gate of ``tests/functional/test_inference.py:115-120``."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import gnk, ma2

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS = 0.2
#: the last refinement's step: a region's limit is found to within it
LINE_SEARCH_STEP = 1.0 / 2 ** 9


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def jax_observed(seed_obs=1):
    """The JAX fixture's observed data: ``N(1, 1)`` x 5 from
    ``jax.random.key(seed_obs)``."""
    import jax
    import jax.numpy as jnp
    y = jnp.asarray([1.0])[:, None] + jax.random.normal(
        jax.random.key(seed_obs), (1, 5))
    return np.array(y, np.float32)[0]


def build_gauss_1d(seed_obs=1):
    """theta ~ U(-2.5, 2.5); data ~ N(theta, 1) x 5; summary the mean."""
    y = jax_observed(seed_obs)
    m = et.Model(name="romc_gauss")
    et.Prior("uniform", -2.5, 5.0, model=m, name="theta")

    def sim(theta, batch_size, generator):
        return theta[:, None] + torch.randn((batch_size, 5),
                                            generator=generator,
                                            device=theta.device)

    et.Simulator(sim, m["theta"], observed=y, model=m, name="sim")
    et.Summary(lambda x: torch.mean(x, dim=1), m["sim"], model=m, name="S")
    et.Distance("euclidean", m["S"], model=m, name="d")
    return m, float(np.mean(y))


@pytest.fixture(scope="module")
def romc_fitted():
    m, obs_mean = build_gauss_1d()
    # module-scoped, so built before the autouse client: the CPU by name
    romc = et.ROMC(m["d"], bounds=[(-2.5, 2.5)], seed=3, device=CPU)
    romc.solve_problems(n1=30, seed=7)
    romc.estimate_regions(eps_filter=EPS)
    return romc, obs_mean


def test_solve_problems(romc_fitted):
    romc, _ = romc_fitted
    assert sum(romc.inference_state["solved"]) >= 25
    f_mins = [p.result.f_min for p in romc.optim_problems
              if p.state["solved"]]
    assert np.median(f_mins) < 1e-3


def test_regions(romc_fitted):
    """Each region of (theta - theta*_i)^2 < eps is theta*_i +- sqrt(eps):
    the line search stops within its last step inside that bound; the
    optimum is theta*_i to within sqrt(f_min)."""
    romc, _ = romc_fitted
    assert len(romc.posterior.regions) >= 20
    half = np.sqrt(EPS)
    for p in romc.optim_problems:
        if not p.state["region"]:
            continue
        region = p.regions[0]
        assert region.volume > 0 and region.contains(region.center)
        off = np.sqrt(p.result.f_min) + 1e-5
        for lim in (-region.limits[0, 0], region.limits[0, 1]):
            assert half - LINE_SEARCH_STEP - off <= lim <= half + off, \
                (p.ind, region.limits, p.result.f_min)


def test_sampling_posterior_mean(romc_fitted):
    romc, obs_mean = romc_fitted
    res = romc.sample(n2=50, seed=5)
    assert res.n_samples == len(romc.posterior.regions) * 50
    w = res.weights
    assert np.sum(w) > 0
    post_mean = np.sum(res.samples["theta"] * w) / np.sum(w)
    assert abs(post_mean - obs_mean) < 0.5
    assert romc.compute_ess() > 10
    again = romc.posterior.sample(50, seed=5)
    np.testing.assert_array_equal(again[0], romc.samples)
    np.testing.assert_array_equal(again[1], romc.weights)


def test_eval_posterior(romc_fitted):
    romc, obs_mean = romc_fitted
    theta = np.linspace(-2.4, 2.4, 25)[:, None]
    pdf = romc.eval_posterior(theta)
    assert np.all(pdf >= 0)
    integral = np.sum(pdf) * (theta[1, 0] - theta[0, 0])
    assert 0.6 < integral < 1.4
    assert abs(theta[np.argmax(pdf), 0] - obs_mean) < 0.6


def test_expectation(romc_fitted):
    romc, obs_mean = romc_fitted
    romc.sample(n2=50, seed=5)
    mean = romc.compute_expectation(lambda t: np.squeeze(t, -1))
    assert abs(mean - obs_mean) < 0.5


def test_local_surrogates():
    m, obs_mean = build_gauss_1d()
    romc = et.ROMC(m["d"], bounds=[(-2.5, 2.5)], seed=3)
    romc.fit_posterior(n1=15, eps_filter=EPS, seed=7, fit_models=True)
    assert romc.posterior._local_coeffs is not None
    res = romc.sample(n2=30, seed=4)
    w = res.weights
    post_mean = np.sum(res.samples["theta"] * w) / np.sum(w)
    assert abs(post_mean - obs_mean) < 0.6


def test_romc_2d():
    romc = et.ROMC(ma2.get_model(seed_obs=4)["d"], bounds=[(-2, 2), (-1, 1)],
                   seed=1)
    romc.solve_problems(n1=20, seed=2)
    assert romc.compute_eps(quantile=0.9) < 0.1
    romc.estimate_regions(eps_filter=0.05)
    res = romc.sample(n2=20, seed=3)
    assert res.samples["t1"].shape == (len(romc.posterior.regions) * 20,)
    assert np.sum(res.weights) > 0


def test_romc_gnk_end_to_end():
    """ROMC on the 4-d g-and-k model (dict bounds, multi-restart gradient
    solves) at n1 = 20."""
    m = gnk.get_model(n_obs=50, seed_obs=2)
    romc = et.ROMC(m["d"], bounds={p: (0.0, 10.0)
                                   for p in m.parameter_names}, seed=3)
    romc.solve_problems(n1=20, use_bo=False, seed=4)
    eps = romc.compute_eps(0.5)
    assert np.isfinite(eps)
    romc.estimate_regions(eps_filter=eps)
    assert sum(romc.inference_state["accepted"]) >= 5
    res = romc.sample(n2=10, seed=5)
    means = res.sample_means
    assert set(means) == set(m.parameter_names)
    for v in means.values():
        assert np.all(np.isfinite(np.asarray(v)))
        assert 0.0 <= float(np.ravel(v)[0]) <= 10.0


@pytest.fixture(scope="module")
def bo_fitted():
    """Deterministic BO solves (reference ``romc.py:1446-1500``): a GP
    surrogate per problem, regions built on the stacked surrogates."""
    m, obs_mean = build_gauss_1d()
    romc = et.ROMC(m["d"], bounds=[(-2.5, 2.5)], seed=11, device=CPU)
    romc.solve_problems(n1=6, use_bo=True,
                        optimizer_args={"n_evidence": 14}, seed=13)
    romc.estimate_regions(eps_filter=0.5)
    return romc, obs_mean


def test_romc_bo_path_with_batched_surrogate_regions(bo_fitted):
    """The BO path end to end: surrogate regions, posterior sampling
    through the surrogates, and the stacked-surrogate regions equal each
    problem's own search."""
    romc, obs_mean = bo_fitted
    assert romc.inference_state["_has_fitted_surrogate_model"]
    built = [p for p in romc.optim_problems if p.state["region"]]
    assert built, "no regions built via the surrogate path"
    assert all(p.state["has_built_region_with_surrogate"] for p in built)
    res = romc.sample(n2=30, seed=17)
    w = res.weights
    assert w.sum() > 0
    mean = float(np.sum(res.samples_array.ravel() * w) / w.sum())
    assert abs(mean - obs_mean) < 0.75

    for p in built:
        batched = p.regions[0]
        p.build_region(eps_region=0.5, use_surrogate=True)
        np.testing.assert_allclose(p.regions[0].limits, batched.limits,
                                   rtol=1e-4, atol=1e-5)


def test_romc_bo_posterior_evaluates_surrogates(bo_fitted):
    """Under use_bo the posterior evaluates the fitted GP surrogates (the
    reference's ``self.funcs``): every column of its distances equals the
    region's host surrogate callable."""
    romc, _ = bo_fitted
    post = romc.posterior
    assert post._surrogate_aux is not None, \
        "surrogate factors were not stacked into the posterior"
    thetas = np.linspace(-2.0, 2.0, 7, dtype=np.float32)[:, None]
    dists = post._all_distances(thetas)
    assert dists.shape == (7, len(post.regions))
    for j, fn in enumerate(post.funcs):
        want = np.array([fn(t) for t in thetas])
        np.testing.assert_allclose(dists[:, j], want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"region {j}")


def test_romc_accuracy_ma2():
    """The JAX package's MA2 gate (``test_inference.py:115-120``): weighted
    means within 0.1 of (0.6, 0.2) at ``seed_obs=271``."""
    m = ma2.get_model(seed_obs=271)
    romc = et.ROMC(m["d"], bounds=[(-2, 2), (-1, 1)], seed=7)
    romc.solve_problems(n1=60, seed=8)
    romc.estimate_regions(eps_filter=0.1)
    res = romc.sample(n2=30, seed=9)
    w = res.weights / res.weights.sum()
    means = np.array([np.sum(res.samples[k] * w) for k in ("t1", "t2")])
    err = np.abs(means - np.array([0.6, 0.2]))
    assert np.all(err < 0.1), f"posterior means {means}, err {err}"
