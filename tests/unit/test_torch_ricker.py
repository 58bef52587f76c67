"""The Ricker model in the PyTorch port against the JAX package's: the
deterministic map, the summaries and the chi-squared discrepancy on the
same inputs, the committed observed series against the JAX package's
draws, the stochastic simulator's Poisson counts statistically, the
exponential prior, and ``get_model``."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import ricker as tricker
from elfi_tpu_torch.ops import distributions as tdists

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


# float32 exp and products in both packages, one rounding apart per step
RTOL = 1e-6


def test_deterministic_ricker_equals_jax():
    import jax.numpy as jnp
    from elfi_tpu.models import ricker as jricker
    # stable and periodic rates: the 50 steps agree to float32 rounding
    rates = np.linspace(0.2, 2.4, 23).astype(np.float32)
    want = np.asarray(jricker.ricker(jnp.asarray(rates), batch_size=23))
    got = tricker.ricker(torch.as_tensor(rates), batch_size=23).numpy()
    assert got.shape == (23, 50)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # chaotic rates (3.8): a one-ulp gap of exp doubles about every step,
    # so only the first steps are held, at a gap that grows from 1e-7
    rates = np.array([3.2, 3.8, 4.0], np.float32)
    want = np.asarray(jricker.ricker(jnp.asarray(rates), batch_size=3))
    got = tricker.ricker(torch.as_tensor(rates), batch_size=3).numpy()
    np.testing.assert_allclose(got[:, :8], want[:, :8], rtol=1e-5)


def _counts(seed=0, n=64):
    rng = np.random.RandomState(seed)
    x = rng.poisson(rng.gamma(0.5, 40.0, size=(n, 50))).astype(np.float32)
    x[::7] = 0.0
    return x


def test_summaries_and_chi_squared_equal_jax():
    import jax.numpy as jnp
    from elfi_tpu.models import ricker as jricker
    x, obs = _counts(), _counts(1, 1)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    np.testing.assert_array_equal(tricker.num_zeros(tx).numpy(),
                                  np.asarray(jricker.num_zeros(jx)))
    np.testing.assert_allclose(tricker.mean(tx).numpy(),
                               np.asarray(jnp.mean(jx, axis=1)), rtol=RTOL)
    np.testing.assert_allclose(tricker.var(tx).numpy(),
                               np.asarray(jnp.var(jx, axis=1)), rtol=1e-5)
    tsims = [tricker.mean(tx), tricker.var(tx), tricker.num_zeros(tx)]
    jsims = [jnp.mean(jx, axis=1), jnp.var(jx, axis=1), jricker.num_zeros(jx)]
    jo = jnp.asarray(obs)
    jobs = [jnp.mean(jo, axis=1), jnp.var(jo, axis=1), jricker.num_zeros(jo)]
    tobs = [v.numpy() for v in (tricker.mean(torch.as_tensor(obs)),
                                tricker.var(torch.as_tensor(obs)),
                                tricker.num_zeros(torch.as_tensor(obs)))]
    got = tricker.chi_squared(*tsims, observed=tobs)
    want = jricker.chi_squared(*jsims, observed=jobs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_observed_series_are_the_jax_draws():
    import jax
    import jax.numpy as jnp
    from elfi_tpu.models import ricker as jricker
    for seed in (0, 3):
        want = jricker.get_model(seed_obs=seed)["Ricker"].observed
        np.testing.assert_array_equal(
            tricker.get_model(seed_obs=seed)["Ricker"].observed,
            np.asarray(want))
    want = jricker.get_model(stochastic=False)["Ricker"].observed
    np.testing.assert_array_equal(
        tricker.get_model(stochastic=False)["Ricker"].observed,
        np.asarray(want))
    bench = jricker.stochastic_ricker(
        jnp.asarray([3.8]), jnp.asarray([0.3]), jnp.asarray([10.0]),
        n_obs=50, batch_size=1, key=jax.random.key(4))
    np.testing.assert_array_equal(tricker.bench_observed(),
                                  np.asarray(bench)[0])
    # a seed no file holds, once refused, gives the JAX package's series
    np.testing.assert_array_equal(
        tricker.get_model(seed_obs=5)["Ricker"].observed,
        np.asarray(jricker.get_model(seed_obs=5)["Ricker"].observed))


def test_stochastic_ricker_counts_match_jax():
    """Poisson counts at the same parameters: the summaries' means within
    five standard errors of the JAX package's, and the share of zeros."""
    import jax
    import jax.numpy as jnp
    from elfi_tpu.models import ricker as jricker
    n = 20000
    params = (3.8, 0.3, 10.0)
    j = np.asarray(jricker.stochastic_ricker(
        *[jnp.full((n,), p, jnp.float32) for p in params], batch_size=n,
        key=jax.random.key(11)))
    t = tricker.stochastic_ricker(
        *[torch.full((n,), p) for p in params], batch_size=n,
        generator=torch.Generator().manual_seed(11)).numpy()
    assert t.shape == j.shape == (n, 50) and t.dtype == np.float32
    assert np.array_equal(t, np.round(t)) and t.min() >= 0
    for f in (lambda x: x.mean(1), lambda x: x.var(1),
              lambda x: (x == 0).sum(1)):
        a, b = f(t), f(j)
        se = np.sqrt(a.var() / n + b.var() / n)
        assert abs(a.mean() - b.mean()) < 5 * se
    np.testing.assert_allclose((t == 0).mean(), (j == 0).mean(), atol=0.01)


def test_expon_equals_jax():
    from elfi_tpu.ops.distributions import expon as jexpon
    x = np.linspace(1.0, 12.0, 23).astype(np.float32)
    q = np.linspace(0.0, 0.99, 12).astype(np.float32)
    for name, arg in (("logpdf", x), ("cdf", x), ("ppf", q)):
        np.testing.assert_allclose(
            getattr(tdists.expon, name)(torch.as_tensor(arg), np.e,
                                        2.0).numpy(),
            np.asarray(getattr(jexpon, name)(arg, np.e, 2.0)), rtol=RTOL,
            err_msg=name)
    assert tdists.expon.logpdf(torch.tensor(2.0), np.e, 2.0) == -np.inf
    assert np.isnan(tdists.expon.ppf(torch.tensor(1.5)).item())
    draws = tdists.expon.rvs(np.e, 2.0, size=40000,
                             generator=torch.Generator().manual_seed(0))
    assert draws.min() >= np.e
    np.testing.assert_allclose(float(draws.mean()), np.e + 2.0, atol=0.05)
    np.testing.assert_allclose(float(draws.std()), 2.0, atol=0.05)
    assert tdists.from_name("expon") is tdists.expon


def test_get_model_generates_on_the_cpu():
    m = tricker.get_model(seed_obs=0)
    out = m.generate(16, outputs=["t1", "t2", "t3", "Ricker", "d"], seed=2)
    assert out["Ricker"].shape == (16, 50)
    assert out["d"].shape == (16,) and np.isfinite(out["d"]).all()
    assert (out["t1"] >= np.float32(np.e)).all() and (out["t2"] >= 0).all()
    assert ((out["t3"] >= 0) & (out["t3"] <= 100)).all()
    m1 = tricker.get_model(stochastic=False)
    d = m1.generate(8, outputs=["d"], seed=2)["d"]
    assert d.shape == (8,) and np.isfinite(d).all()
