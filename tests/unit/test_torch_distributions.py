"""The port's distributions (``elfi_tpu_torch/ops/distributions.py``) and
``ops/special.betainc``: the mirror of ``tests/unit/test_distributions.py``
(scipy parity, moments, the distribution contract), each new distribution's
``logpdf``, ``cdf`` and ``ppf`` against the JAX package's on the same x,
their draws' moments, and ``betainc`` against scipy and JAX over a grid
that crosses the continued fraction's symmetry switch.

Tolerances: the closed forms at rtol 1e-5 / atol 1e-6 of the JAX package;
``betainc`` within 5e-5 of scipy (float64) and of JAX (both float32, on
a, b up to 50) and the functions built on it (beta's and t's cdf and ppf)
at rtol 1e-4 / atol 5e-5; bisected ppfs (gamma, chi2) at rtol 1e-5 /
atol 1e-5."""

import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as ss
import torch

import jax
import jax.scipy.special as jsp

import elfi_tpu_torch as et
from elfi_tpu.ops import distributions as jd
from elfi_tpu_torch.ops import distributions as d
from elfi_tpu_torch.ops import special

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dist,params,ss_dist", [
    (d.uniform, (1.0, 3.0), ss.uniform(1.0, 3.0)),
    (d.norm, (2.0, 0.5), ss.norm(2.0, 0.5)),
    (d.expon, (0.0, 2.0), ss.expon(0.0, 2.0)),
    (d.gamma, (3.0, 0.0, 2.0), ss.gamma(3.0, 0.0, 2.0)),
    (d.beta, (2.0, 5.0), ss.beta(2.0, 5.0)),
    (d.lognorm, (0.5, 0.0, 1.0), ss.lognorm(0.5, 0.0, 1.0)),
    (d.truncnorm, (-1.0, 2.0, 0.5, 1.5), ss.truncnorm(-1.0, 2.0, 0.5, 1.5)),
    (d.t, (3.0, 0.5, 2.0), ss.t(3.0, 0.5, 2.0)),
    (d.cauchy, (1.0, 2.0), ss.cauchy(1.0, 2.0)),
    (d.laplace, (0.5, 1.5), ss.laplace(0.5, 1.5)),
    (d.chi2, (4.0, 0.0, 1.5), ss.chi2(4.0, 0.0, 1.5)),
    (d.skewnorm, (4.0, 0.5, 2.0), ss.skewnorm(4.0, 0.5, 2.0)),
    (d.weibull_min, (1.8, 0.0, 2.0), ss.weibull_min(1.8, 0.0, 2.0)),
])
def test_logpdf_matches_scipy(dist, params, ss_dist):
    x = np.asarray(ss_dist.rvs(size=50, random_state=np.random.RandomState(0)),
                   np.float32)
    ours = _np(dist.logpdf(torch.as_tensor(x), *params))
    np.testing.assert_allclose(ours, ss_dist.logpdf(x), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("dist,params,ss_dist", [
    (d.uniform, (1.0, 3.0), ss.uniform(1.0, 3.0)),
    (d.norm, (2.0, 0.5), ss.norm(2.0, 0.5)),
    (d.expon, (0.0, 2.0), ss.expon(0.0, 2.0)),
    (d.gamma, (3.0, 0.0, 2.0), ss.gamma(3.0, 0.0, 2.0)),
    (d.truncnorm, (-1.0, 2.0, 0.5, 1.5), ss.truncnorm(-1.0, 2.0, 0.5, 1.5)),
    (d.t, (5.0, 0.5, 2.0), ss.t(5.0, 0.5, 2.0)),
    (d.laplace, (0.5, 1.5), ss.laplace(0.5, 1.5)),
    (d.chi2, (4.0, 0.0, 1.5), ss.chi2(4.0, 0.0, 1.5)),
    (d.skewnorm, (4.0, 0.5, 2.0), ss.skewnorm(4.0, 0.5, 2.0)),
    (d.weibull_min, (1.8, 0.0, 2.0), ss.weibull_min(1.8, 0.0, 2.0)),
    (d.beta, (2.0, 5.0, -1.0, 3.0), ss.beta(2.0, 5.0, -1.0, 3.0)),
    (d.lognorm, (0.5, 0.0, 2.0), ss.lognorm(0.5, 0.0, 2.0)),
    (d.binom, (20, 0.3), ss.binom(20, 0.3)),
    (d.poisson, (4.0,), ss.poisson(4.0)),
])
def test_rvs_moments(dist, params, ss_dist):
    """Mean within 5 standard errors and std within 10 % of scipy's, as
    float32 draws from a CPU generator."""
    x = dist.rvs(*params, size=20000, generator=gen())
    assert x.shape == (20000,) and x.dtype == torch.float32
    x = x.numpy().astype(np.float64)
    se = ss_dist.std() / np.sqrt(len(x))
    assert abs(x.mean() - ss_dist.mean()) < 5 * se
    np.testing.assert_allclose(x.std(), ss_dist.std(), rtol=0.1)


def test_cauchy_quantiles():
    x = d.cauchy.rvs(1.0, 2.0, size=20000, generator=gen()).numpy()
    np.testing.assert_allclose(np.median(x), 1.0, atol=0.1)
    iqr = np.subtract(*np.percentile(x, [75, 25]))
    np.testing.assert_allclose(iqr, 4.0, rtol=0.05)


def test_rvs_support():
    x = d.uniform.rvs(1.0, 3.0, size=1000, generator=gen()).numpy()
    assert x.min() >= 1.0 and x.max() <= 4.0
    x = d.truncnorm.rvs(-1.0, 2.0, 0.0, 1.0, size=1000,
                        generator=gen()).numpy()
    assert x.min() >= -1.0 and x.max() <= 2.0
    x = d.beta.rvs(0.5, 0.5, size=1000, generator=gen()).numpy()
    assert x.min() >= 0.0 and x.max() <= 1.0
    x = d.weibull_min.rvs(1.8, size=1000, generator=gen()).numpy()
    assert np.all(np.isfinite(x)) and x.min() > 0
    x = d.binom.rvs(10, 0.3, size=1000, generator=gen()).numpy()
    assert np.all(x == np.round(x)) and x.min() >= 0 and x.max() <= 10


def test_mvn():
    mean = np.array([1.0, -1.0])
    cov = np.array([[2.0, 0.5], [0.5, 1.0]])
    x = d.multivariate_normal.rvs(mean, cov, size=20000,
                                  generator=gen()).numpy()
    assert x.shape == (20000, 2)
    np.testing.assert_allclose(x.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.1)
    lp = d.multivariate_normal.logpdf(x[:10], mean, cov).numpy()
    np.testing.assert_allclose(lp, ss.multivariate_normal(mean, cov)
                               .logpdf(x[:10]), rtol=1e-4, atol=1e-4)


def test_batched_params():
    locs = torch.linspace(0, 10, 100)
    x = d.norm.rvs(locs, 1e-4, size=100, generator=gen()).numpy()
    np.testing.assert_allclose(x, locs.numpy(), atol=1e-2)
    a = torch.linspace(1, 5, 100)
    x = d.gamma.rvs(a, 0.0, 1e-3, size=100, generator=gen())
    assert x.shape == (100,) and bool(torch.all(x > 0))


def test_gradient_logpdf():
    g = d.norm.gradient_logpdf(np.float32(1.0), 0.0, 1.0).numpy()
    np.testing.assert_allclose(g, -1.0, rtol=1e-5)
    x = np.array([0.5, 1.0, 3.0], np.float32)
    g = d.gamma.gradient_logpdf(x, 3.0, 0.0, 2.0).numpy()
    np.testing.assert_allclose(g, 2.0 / x - 0.5, rtol=1e-5)
    jg = np.asarray(jd.gamma.gradient_logpdf(x, 3.0, 0.0, 2.0))
    np.testing.assert_allclose(g, jg, rtol=1e-5)


def test_from_name():
    assert d.from_name("uniform") is d.uniform
    assert d.from_name("normal") is d.norm
    for name in ("lognorm", "gamma", "beta", "binom", "poisson", "t",
                 "cauchy", "laplace", "chi2", "skewnorm", "weibull_min"):
        assert d.from_name(name) is getattr(d, name)
    assert d.from_name("student_t") is d.t
    with pytest.raises(ValueError):
        d.from_name("nope")


def test_custom_distribution_pdf_from_logpdf():
    class MyDist(d.Distribution):
        @classmethod
        def logpdf(cls, x, a):
            return -torch.abs(torch.as_tensor(x)) * a

    assert np.isclose(float(MyDist.pdf(0.0, 1.0)), 1.0)


def test_cdf_ppf_match_scipy():
    x = torch.linspace(-3, 8, 23)
    q = torch.linspace(0.01, 0.99, 9)
    xn, qn = x.numpy(), q.numpy()
    cases = [
        (d.uniform.cdf(x, 1, 3), ss.uniform.cdf(xn, 1, 3)),
        (d.uniform.ppf(q, 1, 3), ss.uniform.ppf(qn, 1, 3)),
        (d.norm.cdf(x, 1, 2), ss.norm.cdf(xn, 1, 2)),
        (d.norm.ppf(q, 1, 2), ss.norm.ppf(qn, 1, 2)),
        (d.truncnorm.cdf(x, -1, 2, 1, 2), ss.truncnorm.cdf(xn, -1, 2, 1, 2)),
        (d.truncnorm.ppf(q, -1, 2, 1, 2), ss.truncnorm.ppf(qn, -1, 2, 1, 2)),
        (d.lognorm.cdf(x, 0.5, 0, 2), ss.lognorm.cdf(xn, 0.5, 0, 2)),
        (d.lognorm.ppf(q, 0.5, 0, 2), ss.lognorm.ppf(qn, 0.5, 0, 2)),
        (d.expon.cdf(x, 0.5, 2), ss.expon.cdf(xn, 0.5, 2)),
        (d.expon.ppf(q, 0.5, 2), ss.expon.ppf(qn, 0.5, 2)),
        (d.gamma.cdf(x, 2.5, 0, 1.5), ss.gamma.cdf(xn, 2.5, 0, 1.5)),
        (d.beta.cdf(torch.linspace(-.2, 1.2, 15), 2, 3),
         ss.beta.cdf(np.linspace(-.2, 1.2, 15, dtype=np.float32), 2, 3)),
        (d.cauchy.cdf(x, 1, 2), ss.cauchy.cdf(xn, 1, 2)),
        (d.cauchy.ppf(q, 1, 2), ss.cauchy.ppf(qn, 1, 2)),
        (d.laplace.cdf(x, 0.5, 1.5), ss.laplace.cdf(xn, 0.5, 1.5)),
        (d.laplace.ppf(q, 0.5, 1.5), ss.laplace.ppf(qn, 0.5, 1.5)),
        (d.t.cdf(x, 3, 0.5, 2), ss.t.cdf(xn, 3, 0.5, 2)),
        (d.chi2.cdf(x, 4, 0, 1.5), ss.chi2.cdf(xn, 4, 0, 1.5)),
        (d.skewnorm.cdf(x, 4, 0.5, 2), ss.skewnorm.cdf(xn, 4, 0.5, 2)),
        (d.weibull_min.cdf(x, 1.8, 0, 2), ss.weibull_min.cdf(xn, 1.8, 0, 2)),
        (d.weibull_min.ppf(q, 1.8, 0, 2), ss.weibull_min.ppf(qn, 1.8, 0, 2)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-6)


def test_gamma_beta_ppf_match_scipy():
    # bisection-inverted cdf: slightly looser tolerance than closed forms
    q = torch.tensor([0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0])
    qn = q.numpy()
    for a in [0.5, 1.0, 3.7]:
        np.testing.assert_allclose(d.gamma.ppf(q, a, 1.0, 2.0).numpy(),
                                   ss.gamma.ppf(qn, a, 1.0, 2.0), rtol=2e-4,
                                   atol=1e-5)
    for a, b in [(0.5, 0.5), (2.0, 5.0)]:
        np.testing.assert_allclose(d.beta.ppf(q, a, b, -1.0, 3.0).numpy(),
                                   ss.beta.ppf(qn, a, b, -1.0, 3.0),
                                   rtol=2e-4, atol=2e-5)
    qmid = torch.tensor([0.05, 0.25, 0.5, 0.9, 0.99])
    for df in [2.0, 7.0]:
        np.testing.assert_allclose(d.t.ppf(qmid, df, 0.5, 2.0).numpy(),
                                   ss.t.ppf(qmid.numpy(), df, 0.5, 2.0),
                                   rtol=5e-4, atol=1e-4)


def test_ppf_nan_outside_unit_interval():
    bad = torch.tensor([-0.1, 1.1])
    for dist, args in [(d.uniform, ()), (d.expon, ()), (d.gamma, (2.0,)),
                       (d.beta, (2.0, 3.0)), (d.truncnorm, (-1.0, 1.0)),
                       (d.lognorm, (0.5,)), (d.cauchy, ()),
                       (d.laplace, ()), (d.t, (3.0,)),
                       (d.weibull_min, (1.8,))]:
        out = dist.ppf(bad, *args).numpy()
        assert np.all(np.isnan(out)), (dist.name, out)


@pytest.mark.parametrize("dist,params", [
    (d.uniform, (1.0, 3.0)), (d.norm, (2.0, 0.5)),
    (d.expon, (0.0, 2.0)), (d.gamma, (3.0, 0.0, 2.0)),
    (d.beta, (2.0, 5.0)), (d.lognorm, (0.5, 0.0, 1.0)),
    (d.truncnorm, (-1.0, 2.0, 0.5, 1.5)), (d.t, (3.0,)),
    (d.cauchy, ()), (d.laplace, ()), (d.chi2, (4.0,)),
    (d.skewnorm, (4.0,)), (d.weibull_min, (1.8,)),
    (d.binom, (10, 0.3)), (d.poisson, (2.5,)),
    (d.levy_stable, (1.7, 0.5)),
])
def test_distribution_contract(dist, params):
    """rvs/pdf/logpdf obey scipy's shape conventions, including tuple sizes
    and batched parameters; a draw is a function of the generator's
    seed."""
    x = dist.rvs(*params, size=7, generator=gen())
    assert tuple(x.shape) == (7,)
    x2 = dist.rvs(*params, size=(7,), generator=gen())
    assert tuple(x2.shape) == (7,)
    np.testing.assert_array_equal(x.numpy(), x2.numpy())
    if dist is not d.levy_stable:
        lp = dist.logpdf(x, *params).numpy()
        assert lp.shape == (7,)
        pdf = dist.pdf(x, *params).numpy()
        assert pdf.shape == (7,)
        finite = np.isfinite(lp)
        np.testing.assert_allclose(pdf[finite], np.exp(lp[finite]),
                                   rtol=1e-4)
    if params and np.ndim(params[0]) == 0:
        # batched leading parameter (hierarchical priors)
        batched = (torch.full((7,), float(params[0])),) + params[1:]
        xb = dist.rvs(*batched, size=7, generator=gen())
        assert tuple(xb.shape) == (7,)


# -- against the JAX package -------------------------------------------------

_RNG = np.random.default_rng(0)
_Q = np.concatenate([_RNG.uniform(0, 1, 60),
                     [0.0, 1.0, 1e-6, 1 - 1e-6]]).astype(np.float32)

#: (name, params, x range or None for the counts 0..20, functions)
JAX_CASES = [
    ("lognorm", (0.5, 0.0, 2.0), (0.05, 8.0), ("logpdf", "cdf", "ppf")),
    ("gamma", (2.0, 0.0, 1.5), (0.01, 15.0), ("logpdf", "cdf", "ppf")),
    ("beta", (2.0, 5.0), (0.001, 0.999), ("logpdf", "cdf", "ppf")),
    ("binom", (20, 0.3), None, ("logpdf",)),
    ("poisson", (4.0,), None, ("logpdf",)),
    ("t", (10.0, 0.5, 2.0), (-8.0, 8.0), ("logpdf", "cdf", "ppf")),
    ("cauchy", (1.0, 2.0), (-20.0, 20.0), ("logpdf", "cdf", "ppf")),
    ("laplace", (0.5, 2.0), (-10.0, 10.0), ("logpdf", "cdf", "ppf")),
    ("chi2", (4.0,), (0.01, 20.0), ("logpdf", "cdf", "ppf")),
    ("skewnorm", (3.0, 0.2, 1.5), (-3.0, 6.0), ("logpdf", "cdf")),
    ("weibull_min", (1.5, 0.0, 2.0), (0.01, 8.0), ("logpdf", "cdf", "ppf")),
]

#: functions on betainc, then on a bisection, then the closed forms
_TOL = {("beta", "cdf"): (1e-4, 5e-5), ("beta", "ppf"): (1e-4, 5e-5),
        ("t", "cdf"): (1e-4, 5e-5), ("t", "ppf"): (1e-4, 5e-5),
        ("gamma", "ppf"): (1e-5, 1e-5), ("chi2", "ppf"): (1e-5, 1e-5)}


@pytest.mark.parametrize("name,params,xr,fns", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_equals_jax(name, params, xr, fns):
    x = np.arange(21, dtype=np.float32) if xr is None else \
        np.random.default_rng(1).uniform(*xr, 64).astype(np.float32)
    J, T = getattr(jd, name), getattr(d, name)
    for fn in fns:
        arg = _Q if fn == "ppf" else x
        want = np.asarray(getattr(J, fn)(arg, *params))
        got = getattr(T, fn)(torch.as_tensor(arg), *params).numpy()
        rtol, atol = _TOL.get((name, fn), (1e-5, 1e-6))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{name}.{fn}")


def test_batched_tensor_params_equal_jax():
    """Per-element parameters (a hierarchical prior's) through logpdf and
    cdf."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.05, 0.95, 32).astype(np.float32)
    a = rng.uniform(0.5, 5.0, 32).astype(np.float32)
    b = rng.uniform(0.5, 5.0, 32).astype(np.float32)
    for name, args in (("gamma", (a,)), ("beta", (a, b))):
        J, T = getattr(jd, name), getattr(d, name)
        targs = tuple(torch.as_tensor(v) for v in args)
        for fn in ("logpdf", "cdf"):
            np.testing.assert_allclose(
                getattr(T, fn)(torch.as_tensor(x), *targs).numpy(),
                np.asarray(getattr(J, fn)(x, *args)), rtol=1e-4, atol=5e-5)


def _betainc_grid():
    """a and b in [0.2, 50] on a log grid, x in (0, 1) on both sides of the
    switch x = (a + 1) / (a + b + 2), and the ends 0 and 1."""
    ab = np.geomspace(0.2, 50.0, 9)
    a, b = np.meshgrid(ab, ab, indexing="ij")
    a, b = a.ravel(), b.ravel()
    switch = (a + 1) / (a + b + 2)
    xs = [switch * 0.5, switch * 0.99, switch + (1 - switch) * 0.01,
          switch + (1 - switch) * 0.5, np.full_like(a, 0.0),
          np.full_like(a, 1.0), np.full_like(a, 1e-4),
          np.full_like(a, 1 - 1e-4)]
    x = np.concatenate(xs)
    return (np.tile(a, len(xs)).astype(np.float32),
            np.tile(b, len(xs)).astype(np.float32), x.astype(np.float32))


def test_betainc_equals_scipy_and_jax():
    a, b, x = _betainc_grid()
    got = special.betainc(torch.as_tensor(a), torch.as_tensor(b),
                          torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    want = sps.betainc(a.astype(np.float64), b.astype(np.float64),
                       x.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(jsp.betainc(a, b, x)),
                               rtol=0, atol=5e-5)
    assert np.all(got[x == 0] == 0) and np.all(got[x == 1] == 1)
    # scalar parameters broadcast over a tensor x
    np.testing.assert_array_equal(
        special.betainc(2.0, 3.0, torch.as_tensor(x[:9])).numpy(),
        special.betainc(torch.full((9,), 2.0), torch.full((9,), 3.0),
                        torch.as_tensor(x[:9])).numpy())


def test_gamma_beta_prior_graph_runs_on_the_device_path():
    """``Prior("gamma")`` and ``Prior("beta")`` resolve to the port's own
    distributions: the graph is not a host graph, and ``ModelPrior`` takes
    their densities and gradients with autograd."""
    m = et.Model(name="gamma_beta")
    et.Prior("gamma", 2.0, 0.0, 1.0, model=m, name="a")
    et.Prior("beta", 2.0, 5.0, model=m, name="b")
    from elfi_tpu_torch.compile.compiler import compile_program
    prog = compile_program(m, ("a", "b"), device="cpu")
    assert not prog.host
    prior = et.ModelPrior(m)
    assert not prior.host
    x = np.array([[1.0, 0.3], [2.5, 0.1]], np.float32)
    want = ss.gamma.logpdf(x[:, 0], 2.0) + ss.beta.logpdf(x[:, 1], 2.0, 5.0)
    np.testing.assert_allclose(prior.logpdf(x), want, rtol=1e-5)
    g = prior.gradient_logpdf(x)
    np.testing.assert_allclose(g[:, 0], 1.0 / x[:, 0] - 1.0, rtol=1e-5)
    np.testing.assert_allclose(g[:, 1], 1.0 / x[:, 1] - 4.0 / (1 - x[:, 1]),
                               rtol=1e-4)
    draws = prior.rvs(1000, seed=1)
    assert draws.shape == (1000, 2) and np.all(draws > 0)
    assert np.all(draws[:, 1] < 1)
