"""BOLFI end to end in the PyTorch port on the CPU, at the point of the JAX
package's ``tests/functional/test_bolfi.py`` (MA2, ``seed_obs=4``, 16
initial points to 40 evidence, 2 chains of 400): the fused fit and the host
loop, the posterior, NUTS and Metropolis sampling, a continued fit, the
zero-noise fused fit and ``BayesianOptimization``."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods.posteriors import BolfiPosterior
from elfi_tpu_torch.models import ma2

torch.set_num_threads(1)

BOUNDS = {"t1": (-2, 2), "t2": (-1, 1)}


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture(scope="module")
def ma2_log():
    # the model draws its observed data on the global backend's device,
    # and a module's fixture runs before the per-test CPU client is set
    et.set_client("native", device="cpu")
    m = ma2.get_model(seed_obs=4)
    et.Operation(torch.log, m["d"], model=m, name="log_d")
    return m


def _bolfi(m, seed=42, **kw):
    kw = {"initial_evidence": 16, "update_interval": 8, "bounds": BOUNDS,
          "acq_noise_var": 0.1, **kw}
    return et.BOLFI(m["log_d"], batch_size=1, seed=seed, device="cpu", **kw)


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "host"])
def fitted_bolfi(request, ma2_log):
    bolfi = _bolfi(ma2_log)
    post = bolfi.fit(n_evidence=40, bar=False, fused=request.param)
    return bolfi, post


def test_bolfi_fit(fitted_bolfi):
    bolfi, post = fitted_bolfi
    gp = bolfi.target_model
    assert gp.n_evidence == 40 and bolfi.n_evidence == 40
    assert gp.X.shape == (40, 2) and gp.Y.shape == (40, 1)
    assert np.all(np.isfinite(gp.X)) and np.all(np.isfinite(gp.Y))
    assert np.isfinite(post.threshold)
    res = bolfi.extract_result()
    assert isinstance(res, et.OptimizationResult)
    assert set(res.x_min) == {"t1", "t2"}
    for k, (lo, hi) in BOUNDS.items():
        assert lo <= res.x_min[k][0] <= hi
        assert np.all((gp.X[:, list(BOUNDS).index(k)] >= lo)
                      & (gp.X[:, list(BOUNDS).index(k)] <= hi))
    assert res.outputs["log_d"].shape == (40, 1)


def test_bolfi_posterior_logpdf(fitted_bolfi):
    _, post = fitted_bolfi
    x = np.array([0.6, 0.2], np.float32)
    assert np.isfinite(post.logpdf(x))
    g = post.gradient_logpdf(x)
    assert g.shape == (2,) and np.all(np.isfinite(g))
    # outside the prior's support
    assert post.logpdf(np.array([3.0, 0.0], np.float32)) == -np.inf
    lp = post.logpdf(np.array([[0.6, 0.2], [3.0, 0.0]], np.float32))
    assert lp.shape == (2,) and lp[1] == -np.inf


def test_bolfi_sample(fitted_bolfi):
    bolfi, _ = fitted_bolfi
    res = bolfi.sample(400, n_chains=2, bar=False)
    assert isinstance(res, et.BolfiSample)
    assert res.chains.shape == (2, 400, 2)
    assert res.n_samples == 2 * 200 and res.warmup == 200
    means = res.sample_means_array
    assert -2 < means[0] < 2 and -1 < means[1] < 1
    assert set(bolfi.ess) == set(bolfi.rhat) == {"t1", "t2"}
    assert all(np.isfinite(v) for v in bolfi.rhat.values())


def test_bolfi_metropolis_sample(fitted_bolfi):
    bolfi, _ = fitted_bolfi
    res = bolfi.sample(300, n_chains=2, algorithm="metropolis",
                       sigma_proposals={"t1": 0.2, "t2": 0.1}, bar=False)
    assert res.chains.shape == (2, 300, 2)
    assert np.all(np.isfinite(res.chains))
    with pytest.raises(ValueError):
        bolfi.sample(10, algorithm="hmc", bar=False)


def test_bolfi_continue_fit_on_the_host(ma2_log):
    bolfi = _bolfi(ma2_log, seed=7, acq_noise_var=0)
    bolfi.fit(n_evidence=20, bar=False)
    bolfi.infer(30, bar=False)
    assert bolfi.target_model.n_evidence == 30


def test_bolfi_fused_zero_acq_noise_stays_finite(ma2_log):
    """``acq_noise_var=0`` through the fused loop: the minimizer's clipping
    often lands theta on a bound, where the truncated normal's standardized
    bounds would be 0/0; zero-noise dimensions pass theta through."""
    bolfi = _bolfi(ma2_log, seed=7, initial_evidence=12, acq_noise_var=0)
    bolfi.fit(n_evidence=24, bar=False)
    gp = bolfi.target_model
    assert gp.n_evidence == 24
    assert np.all(np.isfinite(gp.X)) and np.all(np.isfinite(gp.Y))
    # the one refit came at 20 (12 + 8); the host loop would next refit at
    # 28, so that is where a continued fit refits too
    assert bolfi.state["last_GP_update"] == 20
    assert not bolfi._should_optimize()


def test_posterior_tracks_continued_fit(ma2_log):
    """A posterior held across a continued fit evaluates the refitted GP;
    its threshold stays as it was extracted."""
    bolfi = _bolfi(ma2_log, seed=21, initial_evidence=12)
    post = bolfi.fit(n_evidence=20, bar=False)
    x = np.array([[0.5, 0.2], [-0.3, 0.1]], np.float32)
    v1 = post.logpdf(x)
    bolfi.fit(n_evidence=28, bar=False)
    v2 = post.logpdf(x)
    fresh = BolfiPosterior(bolfi.target_model, threshold=post.threshold,
                           prior=post.prior)
    np.testing.assert_allclose(v2, fresh.logpdf(x), rtol=1e-6)
    assert not np.allclose(v1, v2)


def test_bayesian_optimization_result(ma2_log):
    bo = et.BayesianOptimization(ma2_log["log_d"], batch_size=1,
                                 initial_evidence=16, bounds=BOUNDS, seed=3,
                                 device="cpu")
    res = bo.infer(20, bar=False)
    assert isinstance(res, et.OptimizationResult)
    assert "log_d" in res.outputs and res.outputs["log_d"].shape == (20, 1)
    assert bo.target_model.n_evidence == 20
