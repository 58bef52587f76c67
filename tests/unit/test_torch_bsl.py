"""BSL's pieces in the PyTorch port against the JAX package's on the same
seeded numpy inputs: the framework-free helpers and host estimators (the
port's own copies), the device estimators of the fused chain, the logit
transforms, the chain diagnostics, ``ModelBased``'s observed matrix and
``BslSample``.

This file imports JAX only inside the tests that compare with it, so on a
machine with a card and no JAX

    python -m pytest --noconftest -m cuda tests/unit/test_torch_bsl.py

runs its ``cuda`` tests alone: the fused chain under
``torch.cuda.set_sync_debug_mode("error")`` and the device estimators on
the card.
"""

import math

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods import mcmc
from elfi_tpu_torch.methods.bsl import method as tmethod
from elfi_tpu_torch.methods.bsl import pdf_methods as tpdf
from elfi_tpu_torch.methods.bsl.cov_warton import corr_warton, cov_warton
from elfi_tpu_torch.methods.bsl.gaussian_copula_density import \
    gaussian_copula_density
from elfi_tpu_torch.methods.bsl.gaussian_rank_corr import (gaussian_rank_corr,
                                                          p2P)
from elfi_tpu_torch.models import ma2

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


# the helpers and host estimators are the same numpy code in both packages
HELPER_RTOL = 1e-12
HOST_RTOL = 1e-10
# the device estimators run in float32 in both frameworks, whose sums and
# factorizations take their own orders
DEVICE_RTOL, DEVICE_ATOL = 1e-5, 1e-5


def _jax_bsl():
    from elfi_tpu.methods import bsl as jbsl
    from elfi_tpu.methods.bsl import cov_warton as jcw
    from elfi_tpu.methods.bsl import gaussian_copula_density as jgcd
    from elfi_tpu.methods.bsl import gaussian_rank_corr as jgrc
    from elfi_tpu.methods.bsl import method as jmethod
    from elfi_tpu.methods.bsl import pdf_methods as jpdf
    return jbsl, jcw, jgcd, jgrc, jmethod, jpdf


def _ssx_ssy():
    """The data of the JAX package's ``tests/functional/test_bsl.py``."""
    rng = np.random.RandomState(0)
    ssx = rng.multivariate_normal([1.0, -1.0], [[1.0, 0.3], [0.3, 0.5]],
                                  size=300)
    return ssx, np.array([1.1, -0.9])


def _whitening(ssx):
    z = (ssx - ssx.mean(0)) / ssx.std(0)
    w, v = np.linalg.eigh(np.atleast_2d(np.cov(z.T)))
    return np.diag(w ** -0.5) @ v.T


# -- framework-free helpers ------------------------------------------------------

def test_warton_p2P_and_rank_corr_equal_jax():
    _, jcw, _, jgrc, _, _ = _jax_bsl()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4)) @ rng.normal(size=(4, 4))
    S = np.cov(x, rowvar=False)
    R = S / np.sqrt(np.outer(np.diag(S), np.diag(S)))
    for gamma in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(cov_warton(S, gamma),
                                   jcw.cov_warton(S, gamma), rtol=HELPER_RTOL)
        np.testing.assert_allclose(corr_warton(R, gamma),
                                   jcw.corr_warton(R, gamma),
                                   rtol=HELPER_RTOL)
    with pytest.raises(ValueError, match="between 0 and 1"):
        cov_warton(S, 1.5)
    param = rng.uniform(-0.5, 0.5, 6)
    np.testing.assert_allclose(p2P(param, 4), jgrc.p2P(param, 4),
                               rtol=HELPER_RTOL)
    np.testing.assert_allclose(gaussian_rank_corr(x),
                               jgrc.gaussian_rank_corr(x), rtol=HELPER_RTOL)


@pytest.mark.parametrize("whitened", [False, True])
def test_copula_density_equals_jax(whitened):
    _, _, jgcd, jgrc, _, _ = _jax_bsl()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 3)) @ rng.normal(size=(3, 3))
    rho = jgrc.gaussian_rank_corr(x)
    u = rng.uniform(0.05, 0.95, 3)
    W = _whitening(x) if whitened else None
    eta_cov = np.cov(x.T) if whitened else None
    got = gaussian_copula_density(rho, u, W, eta_cov)
    want = jgcd.gaussian_copula_density(rho, u, W, eta_cov)
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=HELPER_RTOL)


def test_wcon_equals_jax():
    *_, jpdf = _jax_bsl()
    for k, nu in ((1, 10), (2, 298), (5, 498), (3, 7.5)):
        np.testing.assert_allclose(tpdf.wcon(k, nu), jpdf.wcon(k, nu),
                                   rtol=HELPER_RTOL)


# -- host estimators ---------------------------------------------------------------

def _host_cases(pdf, W):
    return {
        "plain": lambda x, y: pdf.gaussian_syn_likelihood(x, y),
        "warton": lambda x, y: pdf.gaussian_syn_likelihood(
            x, y, shrinkage="warton", penalty=0.3),
        "glasso": lambda x, y: pdf.gaussian_syn_likelihood(
            x, y, shrinkage="glasso", penalty=0.1),
        "ghurye_olkin": pdf.gaussian_syn_likelihood_ghurye_olkin,
        "semiparametric": pdf.semi_param_kernel_estimate,
        "semiparametric_whitened": lambda x, y: pdf.semi_param_kernel_estimate(
            x, y, shrinkage="warton", penalty=0.3, whitening=W),
        "misspec_mean": lambda x, y: pdf.robust_likelihood("mean")(
            x, y, gamma=np.array([0.2, -0.1])),
        "misspec_variance": lambda x, y: pdf.robust_likelihood("variance")(
            x, y, gamma=np.array([0.5, 0.25])),
    }


@pytest.mark.parametrize("case", list(_host_cases(tpdf, None)))
def test_host_estimator_equals_jax(case):
    *_, jpdf = _jax_bsl()
    ssx, ssy = _ssx_ssy()
    W = _whitening(ssx)
    got = np.ravel(_host_cases(tpdf, W)[case](ssx, ssy))[0]
    want = np.ravel(_host_cases(jpdf, W)[case](ssx, ssy))[0]
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=HOST_RTOL)


# -- device estimators -------------------------------------------------------------

def _traceable_case(pdf, case, W):
    return {
        "plain": lambda: pdf.standard_likelihood(),
        "warton": lambda: pdf.standard_likelihood(shrinkage="warton",
                                                  penalty=0.3),
        "plain_whitened": lambda: pdf.standard_likelihood(whitening=W),
        "warton_whitened": lambda: pdf.standard_likelihood(
            shrinkage="warton", penalty=0.3, whitening=W),
        "unbiased": lambda: pdf.unbiased_likelihood(),
    }[case]()


def _float32_data(d, seed=0, n=300):
    rng = np.random.default_rng(seed)
    A = np.eye(d) + 0.3 * rng.normal(size=(d, d))
    ssx = (rng.normal(size=(n, d)) @ A.T + rng.normal(size=d)) \
        .astype(np.float32)
    ssy = (ssx.mean(0) + 0.5 * ssx.std(0)).astype(np.float32)
    return ssx, ssy


def _jax_value(jpdf, case, W, ssx, ssy):
    import jax.numpy as jnp
    fn = jpdf.traceable_likelihood(_traceable_case(jpdf, case, W))
    return float(fn(jnp.asarray(ssx), jnp.asarray(ssy)))


def _torch_value(case, W, ssx, ssy, device="cpu"):
    fn = tpdf.traceable_likelihood(_traceable_case(tpdf, case, W),
                                   device=device)
    return float(fn(torch.as_tensor(ssx, device=device),
                    torch.as_tensor(ssy, device=device)))


@pytest.mark.parametrize("case", ["plain", "warton", "plain_whitened",
                                  "warton_whitened", "unbiased"])
@pytest.mark.parametrize("d", [1, 2, 5])
def test_traceable_likelihood_equals_jax(d, case):
    *_, jpdf = _jax_bsl()
    # the unbiased estimate is a difference of terms (n - d) / 2 times a
    # float32 log-determinant, so their rounding is multiplied by about
    # n / 2: at n = 300 and d = 5 the JAX package's value is 2.4e-4 from
    # the float64 one (the port's 2e-6); at n = 50 both are within 3e-5
    ssx, ssy = _float32_data(d, n=50 if case == "unbiased" else 300)
    W = _whitening(ssx.astype(np.float64)) if "whitened" in case else None
    got = _torch_value(case, W, ssx, ssy)
    want = _jax_value(jpdf, case, W, ssx, ssy)
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=DEVICE_RTOL, atol=DEVICE_ATOL)


@pytest.mark.parametrize("case", ["plain", "unbiased"])
def test_traceable_likelihood_is_minus_inf_on_rank_deficient_ssx(case):
    *_, jpdf = _jax_bsl()
    ssx, ssy = _float32_data(3, seed=2)
    ssx[:, 1] = 0.5       # a constant feature: a singular covariance
    assert _torch_value(case, None, ssx, ssy) == -math.inf
    assert _jax_value(jpdf, case, None, ssx, ssy) == -math.inf


_FACTORIES = {
    "default": lambda pdf: None,
    "gaussian_syn_likelihood": lambda pdf: pdf.gaussian_syn_likelihood,
    "standard": lambda pdf: pdf.standard_likelihood(),
    "warton": lambda pdf: pdf.standard_likelihood(shrinkage="warton",
                                                  penalty=0.5),
    "unbiased": lambda pdf: pdf.unbiased_likelihood(),
    "glasso": lambda pdf: pdf.standard_likelihood(shrinkage="glasso",
                                                  penalty=0.1),
    "standardise": lambda pdf: pdf.standard_likelihood(standardise=True),
    "semiparametric": lambda pdf: pdf.semiparametric_likelihood(),
    "robust_mean": lambda pdf: pdf.robust_likelihood("mean"),
    "robust_variance": lambda pdf: pdf.robust_likelihood("variance"),
}


@pytest.mark.parametrize("name", list(_FACTORIES))
def test_traceable_likelihood_exists_where_jax_has_one(name):
    *_, jpdf = _jax_bsl()
    got = tpdf.traceable_likelihood(_FACTORIES[name](tpdf), device="cpu")
    want = jpdf.traceable_likelihood(_FACTORIES[name](jpdf))
    assert (got is None) == (want is None)
    assert (got is None) == (name in ("glasso", "standardise",
                                      "semiparametric", "robust_mean",
                                      "robust_variance"))


# -- logit transforms --------------------------------------------------------------

_BOUNDS = {
    "both finite": ([[-1.0, 2.0], [0.0, 1.0]], [0.3, 0.9]),
    "upper only": ([[-np.inf, 3.0], [-np.inf, 0.5]], [1.0, -4.0]),
    "lower only": ([[0.5, np.inf], [-2.0, np.inf]], [2.0, -1.5]),
    "none": ([[-np.inf, np.inf], [-np.inf, np.inf]], [-0.7, 3.0]),
    "all four": ([[-1.0, 2.0], [-np.inf, 3.0], [0.5, np.inf],
                  [-np.inf, np.inf]], [0.3, 1.0, 2.0, -0.7]),
}


@pytest.mark.parametrize("kind", list(_BOUNDS))
def test_numpy_logit_triple_equals_jax(kind):
    *_, jmethod, _ = _jax_bsl()
    bound, theta = (np.asarray(v, np.float64) for v in _BOUNDS[kind])
    tilde = tmethod._logit_transform(theta, bound)
    np.testing.assert_array_equal(tilde,
                                  jmethod._logit_transform(theta, bound))
    np.testing.assert_array_equal(
        tmethod._logit_back_transform(tilde + 0.25, bound),
        jmethod._logit_back_transform(tilde + 0.25, bound))
    assert tmethod._logit_jacobian(theta, bound) == \
        jmethod._logit_jacobian(theta, bound)
    np.testing.assert_allclose(tmethod._logit_back_transform(tilde, bound),
                               theta, rtol=1e-12)


@pytest.mark.parametrize("kind", list(_BOUNDS) + ["no bound"])
def test_torch_logit_triple_equals_jax(kind):
    import jax.numpy as jnp
    *_, jmethod, _ = _jax_bsl()
    if kind == "no bound":
        bound, theta = None, np.array([0.3, -0.2])
    else:
        bound, theta = (np.asarray(v, np.float64) for v in _BOUNDS[kind])
    d = len(theta)
    j_tilde, j_back, j_jac = jmethod._traceable_logit(bound, d)
    t_tilde, t_back, t_jac = tmethod._traceable_logit(bound, d, "cpu")
    x = theta.astype(np.float32)
    y = np.asarray(j_tilde(jnp.asarray(x))) + np.float32(0.25)
    np.testing.assert_allclose(t_tilde(torch.as_tensor(x)).numpy(),
                               np.asarray(j_tilde(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(t_back(torch.as_tensor(y)).numpy(),
                               np.asarray(j_back(jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_allclose(float(t_jac(torch.as_tensor(x))),
                               float(j_jac(jnp.asarray(x))), rtol=1e-6)


# -- chain diagnostics -------------------------------------------------------------

# both run the FFT and sums in float32, in their own orders
DIAG_RTOL = 1e-4


def _ar1(shape, phi=0.7, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=shape)
    x = np.empty(shape)
    x[:, 0] = e[:, 0]
    for t in range(1, shape[1]):
        x[:, t] = phi * x[:, t - 1] + e[:, t]
    return x


def _chains(shape_name):
    if shape_name == "(n,)":
        return _ar1((1, 501))[0]
    if shape_name == "(m, n)":
        return _ar1((4, 400), seed=1) + np.arange(4)[:, None] * 0.1
    x = _ar1((3, 300, 2), seed=2)
    return x * np.array([1.0, 5.0]) + np.array([0.0, 2.0])


@pytest.mark.parametrize("shape_name", ["(n,)", "(m, n)", "(m, n, p)"])
def test_chain_diagnostics_equal_jax(shape_name):
    from elfi_tpu.methods import mcmc as jmcmc
    chains = _chains(shape_name)
    for fn in ("eff_sample_size", "gelman_rubin_statistic"):
        got = getattr(mcmc, fn)(chains)
        want = getattr(jmcmc, fn)(chains)
        assert np.shape(got) == np.shape(want)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=DIAG_RTOL, err_msg=fn)


def test_chain_diagnostics_of_a_constant_chain():
    from elfi_tpu.methods import mcmc as jmcmc
    chains = np.full((2, 100), 0.25)
    assert mcmc.gelman_rubin_statistic(chains) == 1.0
    assert mcmc.eff_sample_size(chains) == jmcmc.eff_sample_size(chains)


# -- ModelBased and BslSample ------------------------------------------------------

def test_model_based_observed_matrix_equals_jax():
    from elfi_tpu.methods.bsl import BSL as JBSL
    from elfi_tpu.models import ma2 as jma2
    got = et.BSL(ma2.get_model(seed_obs=4), n_sim_round=10, seed=1)
    want = JBSL(jma2.get_model(seed_obs=4), n_sim_round=10, seed=1)
    assert got.feature_names == want.feature_names == ["S1", "S2"]
    assert got.observed.shape == want.observed.shape == (1, 2)
    # autocov is a float32 mean in both: one rounding apart at most
    np.testing.assert_allclose(got.observed, want.observed, rtol=1e-6)


def test_model_based_checks_its_arguments():
    m = ma2.get_model(seed_obs=4)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        et.ModelBased(m, n_sim_round=10, batch_size=3)
    with pytest.raises(ValueError, match="not found"):
        et.ModelBased(m, n_sim_round=10, feature_names="nope")
    mb = et.ModelBased(m, n_sim_round=10, feature_names="S2", batch_size=5)
    assert mb.feature_names == ["S2"] and mb.batch_size == 5
    mb.set_objective(3)
    assert mb.objective == {"round": 3, "n_batches": 6}


def test_bsl_sample_burn_in_equals_jax():
    from elfi_tpu.methods.results import BslSample as JBslSample
    rng = np.random.default_rng(3)
    samples_all = {"t1": _ar1((1, 200))[0], "t2": rng.normal(size=200)}
    kw = dict(method_name="BSL", samples_all=samples_all,
              parameter_names=["t1", "t2"], burn_in=40, acc_rate=0.3,
              n_sim=200 * 50)
    got, want = et.BslSample(**kw), JBslSample(**kw)
    assert got.n_samples == want.n_samples == 160
    for n in ("t1", "t2"):
        np.testing.assert_array_equal(got.samples[n], samples_all[n][40:])
        np.testing.assert_array_equal(got.samples_all[n], samples_all[n])
    np.testing.assert_array_equal(got.sample_means_array,
                                  want.sample_means_array)
    assert got.acc_rate == 0.3 and got.burn_in == 40
    g, w = got.compute_ess(), want.compute_ess()
    assert set(g) == set(w) == {"t1", "t2"}
    for n in g:
        np.testing.assert_allclose(g[n], w[n], rtol=DIAG_RTOL)


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check is of the card's queue")
    return torch.device("cuda", 0)


def _sync_guarded(fn):
    """``fn`` run with every synchronisation of the host with the card
    raising an error."""
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("likelihood", ["warton", "unbiased", "logit"])
def test_fused_chain_never_waits_for_the_card(cuda, monkeypatch, likelihood):
    monkeypatch.setattr(tmethod.BSL, "_fused_chain",
                        _sync_guarded(tmethod.BSL._fused_chain))
    m = ma2.get_model(seed_obs=271)
    lik = {"warton": tpdf.standard_likelihood(shrinkage="warton",
                                              penalty=0.3),
           "unbiased": tpdf.unbiased_likelihood(),
           "logit": None}[likelihood]
    bound = [[-2.0, 2.0], [-1.0, 1.0]] if likelihood == "logit" else None

    def run(seed):
        bsl = et.BSL(m, n_sim_round=500, likelihood=lik, seed=seed,
                     device=cuda)
        return bsl.sample(40, sigma_proposals=np.diag([.05, .05]),
                          params0=np.array([[.6, .2]]), burn_in=10,
                          logit_transform_bound=bound, fused=True, bar=False)

    a, b = run(4), run(4)
    assert np.all(np.isfinite(a.samples_array))
    np.testing.assert_array_equal(a.samples_array, b.samples_array)
    assert 0.0 < a.acc_rate <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "warton_whitened", "unbiased"])
@pytest.mark.parametrize("d", [2, 5])
def test_device_estimators_on_the_card_equal_the_cpu(cuda, d, case):
    ssx, ssy = _float32_data(d)
    W = _whitening(ssx.astype(np.float64)) if "whitened" in case else None
    np.testing.assert_allclose(_torch_value(case, W, ssx, ssy, cuda),
                               _torch_value(case, W, ssx, ssy),
                               rtol=DEVICE_RTOL, atol=DEVICE_ATOL)
    ssx[:, 1] = 0.5
    if "warton" not in case:
        assert _torch_value(case, W, ssx, ssy, cuda) == -math.inf
