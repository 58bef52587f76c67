"""Three faults of the PyTorch port against the JAX package, each held to
the JAX package: ``NodeReference.become``, the stochastic-volatility
simulators ``log_vol`` and ``shock_term``, and ``RomcPosterior(prior=None)``
on the global backend's device."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elfi_tpu as elfi
import elfi_tpu_torch as et
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu.models import stochastic_volatility as jsv
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.models import stochastic_volatility as tsv

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _graph(model):
    dag = model.dag
    return {n: (dag.get_state(n)["kind"], tuple(dag.parents(n)))
            for n in dag.nodes}


@pytest.mark.parametrize("metric", ["cityblock", "euclidean"])
def test_become_gives_the_jax_graph_and_outputs(metric):
    """The JAX test's swap (``tests/unit/test_model.py::test_become``) in
    both packages: the same nodes, parents and observed entries, and the
    same distances of the same summaries after it."""
    mj, mt = jax_ma2.get_model(seed_obs=4), ma2.get_model(seed_obs=4)
    for pkg, m in ((elfi, mj), (et, mt)):
        new = pkg.Distance(metric, m["S1"], m["S2"], model=m, name="dnew")
        m["d"].become(new)
        assert "dnew" not in m
    assert _graph(mj) == _graph(mt)
    assert sorted(mj.observed) == sorted(mt.observed)
    assert mt.dag.get_state("d")["kind"] == "discrepancy"
    # the same summaries in both packages, through the swapped node
    oj = mj.generate(batch_size=64, outputs=["S1", "S2"], seed=1)
    with_values = {k: np.asarray(v) for k, v in oj.items()}
    got = mt.generate(batch_size=64, outputs=["d"], seed=1,
                      with_values=with_values)["d"]
    want = mj.generate(batch_size=64, outputs=["d"], seed=1,
                       with_values={k: jnp.asarray(v) for k, v in
                                    with_values.items()})["d"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_become_carries_the_observed_entry():
    for pkg, mod in ((elfi, jax_ma2), (et, ma2)):
        m = mod.get_model(seed_obs=4)
        obs = np.asarray(m.observed["MA2"])
        sim = m["MA2"].state
        new = pkg.Simulator(sim["op"], m["t1"], m["t2"], observed=obs + 1,
                            model=m, name="MA2b")
        m["MA2"].become(new)
        assert "MA2b" not in m.observed
        np.testing.assert_array_equal(np.asarray(m.observed["MA2"]),
                                      obs + 1)


def _sv_jax_noise(key, batch, n_obs):
    k0, k1 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k0, (batch,))),
            np.asarray(jax.random.normal(k1, (n_obs - 1, batch))))


def test_log_vol_on_the_jax_draw_equals_jax():
    key = jax.random.key(21)
    mu, phi, sigma = 0.1, 0.9, 0.3
    want = np.asarray(jsv.log_vol(mu, phi, sigma, 40, batch_size=16,
                                  key=key))
    z0, ws = _sv_jax_noise(key, 16, 40)
    got = tsv.log_vol_from_noise(mu, phi, sigma, torch.as_tensor(z0),
                                 torch.as_tensor(ws)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_log_vol_draws_then_transforms():
    g = torch.Generator().manual_seed(5)
    got = tsv.log_vol(0.1, 0.9, 0.3, 40, batch_size=16, generator=g)
    g = torch.Generator().manual_seed(5)
    z0 = torch.randn((16,), generator=g)
    ws = torch.randn((39, 16), generator=g)
    want = tsv.log_vol_from_noise(0.1, 0.9, 0.3, z0, ws)
    assert got.shape == (16, 40)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_shock_term_draws_then_transforms():
    from elfi_tpu_torch.ops.distributions import levy_stable
    g = torch.Generator().manual_seed(6)
    got = tsv.shock_term(1.5, 0.3, 1.0, 0.0, 30, batch_size=8, generator=g)
    g = torch.Generator().manual_seed(6)
    U, W = levy_stable.draw((8, 30), g)
    want = levy_stable.transform(U, W, 1.5, 0.3, 0.0, 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_log_vol_moments_equal_jax():
    """20,000 series: the stationary AR(1)'s mean and variance of every
    step against the JAX function's draws."""
    n, mu, phi, sigma = 20_000, 0.2, 0.8, 0.5
    want = np.asarray(jsv.log_vol(mu, phi, sigma, 20, batch_size=n,
                                  key=jax.random.key(3)))
    got = tsv.log_vol(mu, phi, sigma, 20, batch_size=n,
                      generator=torch.Generator().manual_seed(3)).numpy()
    sd = sigma / np.sqrt(1 - phi ** 2)
    # 5 standard errors of each step's mean and variance
    np.testing.assert_allclose(got.mean(0), want.mean(0),
                               atol=5 * sd * np.sqrt(2 / n))
    np.testing.assert_allclose(got.var(0), want.var(0),
                               atol=5 * sd ** 2 * np.sqrt(4 / n))


def test_shock_term_quantiles_equal_jax():
    """Alpha-stable shocks have no variance: their quantiles against the
    JAX function's, within the sampling error of 100,000 draws."""
    args = (1.6, 0.4, 1.0, 0.0, 10)
    want = np.asarray(jsv.shock_term(*args, batch_size=10_000,
                                     key=jax.random.key(4))).ravel()
    got = tsv.shock_term(*args, batch_size=10_000,
                         generator=torch.Generator().manual_seed(4))
    q = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(got.numpy().ravel(), q),
                               np.quantile(want, q), atol=0.05)


def test_romc_posterior_without_prior_takes_the_global_device(monkeypatch):
    """``RomcPosterior(prior=None)`` put itself on the CPU; it now takes the
    global backend's device like every entry point."""
    from elfi_tpu_torch.methods.romc import RomcPosterior
    assert RomcPosterior([], []).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    et.set_client("native")
    assert RomcPosterior([], []).device == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    et.reset_client()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RomcPosterior([], [])
