"""NUTS and Metropolis in the PyTorch port: the leapfrog, the U-turn test,
the bit counts and the initial step-size search against the JAX package's
on the same inputs, then the JAX package's statistical checks of
``tests/unit/test_mcmc.py`` on the port's batched chains."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods import mcmc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


# float32 arithmetic of a few terms in both packages
RTOL = 1e-6


def std_normal(x):
    return -0.5 * torch.sum(x ** 2, dim=-1)


def _banana(lib):
    def target(x):
        x0, x1 = x[..., 0], x[..., 1]
        return -0.5 * (x0 ** 2 / 4.0 + (x1 - 0.5 * x0 ** 2) ** 2)
    return target


def test_popcount_and_trailing_ones_equal_jax():
    import jax.numpy as jnp
    from elfi_tpu.methods import mcmc as jmcmc
    n = np.arange(0, 4096, dtype=np.int32)
    np.testing.assert_array_equal(
        mcmc._popcount(torch.as_tensor(n)).numpy(),
        np.asarray(jmcmc._popcount(jnp.asarray(n))))
    np.testing.assert_array_equal(
        mcmc._trailing_ones(torch.as_tensor(n)).numpy(),
        np.asarray(jmcmc._trailing_ones(jnp.asarray(n))))
    big = np.array([2**31 - 1, 2**20 + 7, 123456789], np.int64)
    np.testing.assert_array_equal(mcmc._popcount(torch.as_tensor(big)).numpy(),
                                  [bin(int(v)).count("1") for v in big])


def test_leapfrog_and_uturn_equal_jax():
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods import mcmc as jmcmc
    rng = np.random.RandomState(0)
    x = rng.randn(6, 2).astype(np.float32)
    m = rng.randn(6, 2).astype(np.float32)
    step = np.float32(0.3)
    jtarget = _banana(jnp)
    jx, jm = jax.vmap(lambda a, b: jmcmc._leapfrog(jax.grad(jtarget), a, b,
                                                   step))(x, m)
    vg = mcmc._value_and_grad(_banana(torch))
    _, g = vg(torch.as_tensor(x))
    px, pm, plogp, pg = mcmc._leapfrog(g, vg, torch.as_tensor(x),
                                       torch.as_tensor(m), step)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(plogp.numpy(), np.asarray(jax.vmap(jtarget)(
        jx)), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jax.vmap(jax.grad(
        jtarget))(jx)), rtol=RTOL, atol=1e-6)
    # non-finite gradients are zeroed, as the JAX leapfrog's
    inf_g = torch.full((6, 2), float("nan"))
    qx, _, _, _ = mcmc._leapfrog(inf_g, vg, torch.as_tensor(x),
                                 torch.as_tensor(m), step)
    np.testing.assert_allclose(qx.numpy(), x + step * m, rtol=RTOL)
    xl, xr, ml, mr = (rng.randn(50, 3).astype(np.float32) for _ in range(4))
    np.testing.assert_array_equal(
        mcmc._uturn(*map(torch.as_tensor, (xl, xr, ml, mr))).numpy(),
        np.asarray(jax.vmap(jmcmc._uturn)(xl, xr, ml, mr)))


def test_find_stepsize_equals_jax_with_the_same_momentum(monkeypatch):
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods import mcmc as jmcmc
    rng = np.random.RandomState(1)
    x0 = rng.randn(5, 2).astype(np.float32)
    m0 = rng.randn(5, 2).astype(np.float32)
    jtarget = _banana(jnp)
    want = []
    for x, m in zip(x0, m0):
        monkeypatch.setattr(jax.random, "normal",
                            lambda *a, m=m, **k: jnp.asarray(m))
        want.append(float(jmcmc._find_stepsize(
            jax.random.key(0), jtarget, jax.grad(jtarget), jnp.asarray(x))))
    monkeypatch.undo()
    got = mcmc._find_stepsize(mcmc._value_and_grad(_banana(torch)),
                              torch.as_tensor(x0), torch.as_tensor(m0))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # a start whose trial steps leave the support backs off as in JAX
    def walled(lib):
        def target(x):
            inside = x[..., 0] < 0.5
            return lib.where(inside, -0.5 * (x ** 2).sum(-1), -lib.inf)
        return target
    x, m = np.array([0.4, 0.0], np.float32), np.array([1.0, 0.2], np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(m))
    jt = walled(jnp)
    want = float(jmcmc._find_stepsize(jax.random.key(0), jt, jax.grad(jt),
                                      jnp.asarray(x)))
    monkeypatch.undo()
    got = mcmc._find_stepsize(mcmc._value_and_grad(walled(torch)),
                              torch.as_tensor(x[None]),
                              torch.as_tensor(m[None]))
    np.testing.assert_allclose(got.numpy(), [want], rtol=RTOL)


# -- the JAX package's checks (tests/unit/test_mcmc.py) -----------------------

def test_nuts_standard_normal():
    chains = mcmc.nuts_chains(1200, np.zeros((2, 2)) + 0.5, std_normal,
                              seed=0)
    post = chains[:, 600:, :].reshape(-1, 2)
    np.testing.assert_allclose(post.mean(0), 0, atol=0.12)
    np.testing.assert_allclose(post.std(0), 1.0, atol=0.15)
    # every chain ran its own leaves: at least one a draw, at most 63
    assert mcmc.stats["iterations"] == 1200 and mcmc.stats["chains"] == 2
    assert 2 * 1200 <= mcmc.stats["leapfrogs"] <= 2 * 1200 * 63


def test_nuts_deterministic():
    a = mcmc.nuts(200, np.array([0.5]), std_normal, seed=3)
    b = mcmc.nuts(200, np.array([0.5]), std_normal, seed=3)
    c = mcmc.nuts(200, np.array([0.5]), std_normal, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (200, 1)


def test_nuts_bad_init_raises():
    def target(x):
        return torch.where(x[..., 0] > 0, -x[..., 0], -torch.inf)
    with pytest.raises(ValueError):
        mcmc.nuts(100, np.array([-1.0]), target, seed=0)


def test_nuts_target_args_matches_closure():
    mu = np.array([0.7, -0.3], np.float32)

    def target_closure(x):
        return -0.5 * torch.sum((x - torch.as_tensor(mu)) ** 2, dim=-1)

    def target_args(x, mu_):
        return -0.5 * torch.sum((x - mu_) ** 2, dim=-1)

    x0s = np.zeros((2, 2), np.float32)
    a = mcmc.nuts_chains(300, x0s, target_closure, seed=5)
    b = mcmc.nuts_chains(300, x0s, target_args, seed=5,
                         target_args=(torch.as_tensor(mu),))
    np.testing.assert_array_equal(a, b)
    assert abs(b[:, 150:].mean(axis=(0, 1)) - mu).max() < 0.25


def test_nuts_scales_preconditioning():
    sd = torch.tensor([0.1, 10.0])

    def target(x):
        return -0.5 * torch.sum((x / sd) ** 2, dim=-1)

    x0s = np.zeros((4, 2), np.float32)
    ch = mcmc.nuts_chains(1500, x0s, target, n_adapt=750, seed=7,
                          scales=np.array([0.1, 10.0], np.float32))
    post = ch[:, 750:, :].reshape(-1, 2)
    np.testing.assert_allclose(post.std(0), [0.1, 10.0], rtol=0.15)
    ess = mcmc.eff_sample_size(ch[:, 750:, :])
    assert np.all(ess > 500)


def test_nuts_scales_none_equals_default():
    a = mcmc.nuts(200, np.array([0.5]), std_normal, seed=3)
    b = mcmc.nuts(200, np.array([0.5]), std_normal, seed=3, scales=None)
    np.testing.assert_array_equal(a, b)


def test_nuts_matches_the_jax_chains_statistically():
    """The banana target sampled by both packages: the same posterior
    moments within their Monte Carlo error (the streams differ)."""
    import jax.numpy as jnp
    from elfi_tpu.methods import mcmc as jmcmc
    x0s = np.zeros((4, 2), np.float32) + 0.1
    j = jmcmc.nuts_chains(1000, x0s, _banana(jnp), seed=2)[:, 500:]
    p = mcmc.nuts_chains(1000, x0s, _banana(torch), seed=2)[:, 500:]
    jf, pf = j.reshape(-1, 2), p.reshape(-1, 2)
    ess = np.minimum(mcmc.eff_sample_size(p), mcmc.eff_sample_size(j))
    se = np.sqrt(jf.var(0) / ess + pf.var(0) / ess)
    assert np.all(np.abs(pf.mean(0) - jf.mean(0)) < 4 * se)
    np.testing.assert_allclose(pf.std(0), jf.std(0), rtol=0.2)


def test_metropolis_normal():
    s = mcmc.metropolis(8000, np.array([0.0]),
                        lambda x: -0.5 * torch.sum(x ** 2, dim=-1) / 0.25,
                        np.array([0.4]), warmup=500, seed=1)
    assert s.shape == (8000, 1)
    assert abs(s.mean()) < 0.1
    np.testing.assert_allclose(s.std(), 0.5, atol=0.08)


def test_metropolis_target_args():
    s = mcmc.metropolis_chains(
        4000, np.zeros((2, 1), np.float32),
        lambda x, v: -0.5 * torch.sum(x ** 2, dim=-1) / v, np.array([0.4]),
        warmup=500, seed=1, target_args=(torch.tensor(0.25),))
    assert s.shape == (2, 4000, 1)
    np.testing.assert_allclose(np.asarray(s).std(), 0.5, atol=0.08)
