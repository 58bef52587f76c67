"""Distributions and distances of the PyTorch port against the JAX
package's on the same numpy inputs."""

import numpy as np
import pytest
import torch

from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu.ops import distances as jdist
from elfi_tpu.ops import distributions as jdists
import elfi_tpu_torch as et
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.ops import distances, distributions

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL, **kw)


@pytest.mark.parametrize("name", ["uniform", "norm"])
def test_density_functions_equal_jax(name):
    dt, dj = distributions.from_name(name), jdists.from_name(name)
    x = np.linspace(-3, 4, 57).astype(np.float32)
    q = np.linspace(-0.1, 1.1, 25).astype(np.float32)
    for loc, scale in ((0.0, 1.0), (-1.0, 3.0)):
        for fn in ("logpdf", "pdf", "cdf"):
            _close(getattr(dt, fn)(torch.tensor(x), loc, scale),
                   getattr(dj, fn)(x, loc, scale), err_msg=fn)
        _close(dt.ppf(torch.tensor(q), loc, scale), dj.ppf(q, loc, scale),
               equal_nan=True)


@pytest.mark.parametrize("size,params", [
    (5, ()), (5, (np.zeros(5, np.float32),)), (4, (np.zeros(3, np.float32),)),
    ((2, 3), ()), ((4, 3), (np.zeros(3, np.float32),))])
def test_draw_shape_equals_jax(size, params):
    tp = [torch.tensor(p) for p in params]
    assert distributions._draw_shape(size, *tp) == \
        tuple(jdists._draw_shape(size, *params))


@pytest.mark.parametrize("name", ["uniform", "norm"])
def test_rvs_moments(name):
    g = torch.Generator().manual_seed(0)
    x = distributions.from_name(name).rvs(2.0, 3.0, size=200_000,
                                          generator=g)
    assert x.shape == (200_000,) and x.dtype == torch.float32
    mean, var = (3.5, 0.75) if name == "uniform" else (2.0, 9.0)
    assert abs(float(x.mean()) - mean) < 0.02
    assert abs(float(x.var()) / var - 1) < 0.02


def test_unknown_distribution_raises():
    # a scipy.stats name the port lacks ("gumbel_r") resolves to the host
    # adapter; a name scipy lacks too still raises
    with pytest.raises(ValueError, match="Unknown distribution"):
        distributions.from_name("definitely_not_a_distribution")


def test_ma2_priors_and_summaries_equal_jax():
    rng = np.random.default_rng(0)
    t1 = rng.uniform(-2.5, 2.5, 64).astype(np.float32)
    x = rng.uniform(-1.5, 1.5, 64).astype(np.float32)
    _close(ma2.CustomPrior1.pdf(torch.tensor(t1), 2),
           jax_ma2.CustomPrior1.pdf(t1, 2))
    _close(ma2.CustomPrior2.pdf(torch.tensor(x), torch.tensor(t1), 1),
           jax_ma2.CustomPrior2.pdf(x, t1, 1))
    y = rng.standard_normal((16, 100)).astype(np.float32)
    for lag in (1, 2):
        _close(ma2.autocov(torch.tensor(y), lag), jax_ma2.autocov(y, lag))


def test_ma2_priors_draw_inside_their_support():
    g = torch.Generator().manual_seed(1)
    t1 = ma2.CustomPrior1.rvs(2, size=10_000, generator=g)
    t2 = ma2.CustomPrior2.rvs(t1, 1, size=10_000, generator=g)
    assert float(t1.abs().max()) <= 2
    assert bool((t2 >= torch.maximum(-1 - t1, -1 + t1)).all())
    assert bool((t2 <= 1).all())
    # the triangular prior's mean is 0 and its variance b^2 / 6
    assert abs(float(t1.mean())) < 0.05
    assert abs(float(t1.var()) - 4 / 6) < 0.03


@pytest.mark.parametrize("w", [None, [1.0, 4.0, 0.5]])
def test_euclidean_distance_equals_jax(w):
    rng = np.random.default_rng(3)
    s1 = rng.normal(size=32).astype(np.float32)
    s2 = rng.normal(size=(32, 2)).astype(np.float32)
    o1 = np.float32([0.3])
    o2 = np.float32([[0.1, -0.2]])
    op_t = distances.distance_op("euclidean", w=w)
    op_j = jdist.distance_op("euclidean", w=w)
    _close(op_t(torch.tensor(s1), torch.tensor(s2),
                observed=(torch.tensor(o1), torch.tensor(o2))),
           op_j(s1, s2, observed=(o1, o2)))
    stacked = distances.stack_summaries([torch.tensor(s1), torch.tensor(s2)])
    _close(stacked, jdist.stack_summaries([s1, s2]))


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="Unknown metric"):
        distances.distance_op("nosuchmetric")
