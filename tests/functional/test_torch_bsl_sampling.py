"""BSL end to end in the PyTorch port, on the CPU: the host chain step for
step against the JAX package's on a model that draws no random numbers,
the port's mirrors of the JAX package's BSL chain tests
(``tests/functional/test_bsl.py``) and pre-sampling tool tests
(``tests/unit/test_bsl_tools.py``), and the BSL accuracy gate of
``tests/functional/test_inference.py`` on the fused chain."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods.bsl import (estimate_whitening_matrix,
                                        log_SL_stdev, plot_covariance_matrix,
                                        plot_features, robust_likelihood,
                                        select_penalty,
                                        semiparametric_likelihood,
                                        standard_likelihood,
                                        unbiased_likelihood)
from elfi_tpu_torch.methods.bsl.pre_sample_methods import _simulate_features
from elfi_tpu_torch.models import ma2

torch.set_num_threads(1)

TRUE = np.array([0.6, 0.2])


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def m4():
    return ma2.get_model(seed_obs=4)


# -- the host chain, step for step -------------------------------------------------

N_SIM_ROUND = 50
# fixed per-row offsets and scales, exact in float32: each feature is one
# float32 operation on a parameter, rounded alike in both frameworks
_ROWS = np.random.RandomState(11).randn(N_SIM_ROUND, 2)
OFFSET = (0.3 * _ROWS[:, 0]).astype(np.float32)
SCALE = (1.0 + 0.2 * _ROWS[:, 1]).astype(np.float32)
OBSERVED = np.array([0.55, 0.35])


def _deterministic_model(pkg, xp):
    """t1, t2 ~ U(0, 1); row r of a batch is (t1 + OFFSET[r], t2 *
    SCALE[r]), whatever the random stream.  ``pkg`` is either package,
    ``xp`` its array module."""
    def sim(t1, t2, batch_size=1, **_):
        off = xp.asarray(OFFSET[:batch_size])
        scale = xp.asarray(SCALE[:batch_size])
        return xp.stack([t1 + off, t2 * scale], 1)

    m = pkg.Model(name="det")
    pkg.Prior("uniform", 0, 1, model=m, name="t1")
    pkg.Prior("uniform", 0, 1, model=m, name="t2")
    pkg.Simulator(sim, m["t1"], m["t2"], observed=OBSERVED, model=m,
                  name="sim")
    pkg.Summary(lambda x: x[:, 0], m["sim"], model=m, name="S1")
    pkg.Summary(lambda x: x[:, 1], m["sim"], model=m, name="S2")
    return m


_CHAINS = {
    "plain": dict(likelihood=None, bound=None),
    "logit": dict(likelihood=None, bound=[[0.0, 1.0], [0.0, 1.0]]),
    "robust_mean": dict(likelihood="robust_mean", bound=None),
}


def _host_chain(pkg, xp, bsl_mod, case):
    spec = _CHAINS[case]
    lik = bsl_mod.robust_likelihood("mean") \
        if spec["likelihood"] == "robust_mean" else None
    bsl = pkg.BSL(_deterministic_model(pkg, xp), n_sim_round=N_SIM_ROUND,
                  batch_size=N_SIM_ROUND // 2, seed=9, likelihood=lik)
    res = bsl.sample(40, sigma_proposals=np.diag([0.09, 0.09]),
                     params0=np.array([[0.5, 0.5]]), burn_in=5,
                     logit_transform_bound=spec["bound"], fused=False,
                     bar=False)
    return res, bsl


@pytest.mark.parametrize("case", list(_CHAINS))
def test_host_chain_equals_jax_step_for_step(case):
    """A simulator without randomness makes both host chains a function of
    the ``RandomState`` alone: the round bookkeeping, the out-of-support
    rule, the MH ratio and the slice sampler must all agree."""
    import jax.numpy as jnp

    import elfi_tpu as elfi
    from elfi_tpu.methods import bsl as jbsl
    from elfi_tpu_torch.methods import bsl as tbsl

    got, tb = _host_chain(et, torch, tbsl, case)
    want, jb = _host_chain(elfi, jnp, jbsl, case)
    for p in ("t1", "t2"):
        np.testing.assert_allclose(got.samples_all[p], want.samples_all[p],
                                   rtol=1e-6, atol=1e-6)
    assert tb.num_accepted == jb.num_accepted > 0
    assert got.n_sim == want.n_sim
    np.testing.assert_allclose(tb.state["logposterior"],
                               jb.state["logposterior"], rtol=1e-6)
    if case == "plain":
        # the random walk left the unit square: rounds were skipped
        assert got.n_sim < 40 * N_SIM_ROUND
    if case == "robust_mean":
        np.testing.assert_allclose(got.samples_all["gamma"],
                                   want.samples_all["gamma"], rtol=1e-6,
                                   atol=1e-6)


# -- mirrors of TestBslSampling ----------------------------------------------------

def test_bsl_ma2(m4):
    bsl = et.BSL(m4, n_sim_round=300, batch_size=300, seed=5)
    res = bsl.sample(12, sigma_proposals=np.eye(2) * 0.1, burn_in=2,
                     bar=False)
    assert res.n_samples == 10
    assert set(res.samples) == {"t1", "t2"}
    assert 0 <= res.meta["acc_rate"] <= 1
    assert res.n_sim == 12 * 300
    ess = res.compute_ess()
    assert set(ess) == {"t1", "t2"}


@pytest.mark.parametrize("fused", [True, False])
def test_bsl_determinism(m4, fused):
    r1 = et.BSL(m4, n_sim_round=200, seed=3).sample(
        6, sigma_proposals=np.eye(2) * 0.1, fused=fused, bar=False)
    r2 = et.BSL(m4, n_sim_round=200, seed=3).sample(
        6, sigma_proposals=np.eye(2) * 0.1, fused=fused, bar=False)
    np.testing.assert_array_equal(r1.samples["t1"], r2.samples["t1"])


def test_bsl_logit_transform(m4):
    bsl = et.BSL(m4, n_sim_round=200, seed=7)
    res = bsl.sample(6, sigma_proposals=np.eye(2) * 0.1,
                     logit_transform_bound=[(-2, 2), (-1, 1)], bar=False)
    assert np.all(res.samples["t1"] > -2) and \
        np.all(res.samples["t1"] < 2)


def test_bsl_misspec(m4):
    bsl = et.BSL(m4, n_sim_round=200, seed=7,
                 likelihood=robust_likelihood("mean"))
    res = bsl.sample(5, sigma_proposals=np.eye(2) * 0.1, bar=False)
    assert "gamma" in res.samples_all
    assert res.samples_all["gamma"].shape == (5, 2)


def test_whitening_pipeline(m4):
    W = estimate_whitening_matrix(m4, 300, [0.6, 0.2], ["S1", "S2"], seed=1)
    assert W.shape == (2, 2)
    bsl = et.BSL(m4, n_sim_round=200, seed=2,
                 likelihood=standard_likelihood(
                     shrinkage="warton", penalty=0.5, whitening=W))
    res = bsl.sample(5, sigma_proposals=np.eye(2) * 0.1, bar=False)
    assert res.n_samples == 5


def test_params0_outside_the_prior_raises(m4):
    with pytest.raises(ValueError, match="outside prior support"):
        et.BSL(m4, n_sim_round=20, seed=1).sample(
            3, sigma_proposals=np.eye(2) * 0.1, params0=[[5.0, 0.0]],
            bar=False)


# -- mirrors of TestFusedBSL ------------------------------------------------------

def _run(m, fused, seed=4, likelihood=None, bound=None):
    bsl = et.BSL(m, n_sim_round=300, feature_names=["S1", "S2"], seed=seed,
                 likelihood=likelihood)
    return bsl.sample(120, sigma_proposals=np.diag([.05, .05]),
                      params0=np.array([[.6, .2]]), burn_in=20,
                      logit_transform_bound=bound, fused=fused, bar=False)


def test_fused_deterministic(m4):
    r1 = _run(m4, fused=True)
    r2 = _run(m4, fused=True)
    np.testing.assert_array_equal(r1.samples_array, r2.samples_array)
    r3 = _run(m4, fused=True, seed=5)
    assert not np.array_equal(r1.samples_array, r3.samples_array)
    assert r1.n_sim == 120 * 300 and r1.n_samples == 100


def test_fused_statistically_matches_host(m4):
    f = _run(m4, fused=True)
    u = _run(m4, fused=False)
    # different streams (a device generator against numpy) -> statistical
    # agreement
    np.testing.assert_allclose(f.sample_means_array, u.sample_means_array,
                               atol=0.15)
    assert 0.05 < f.meta["acc_rate"] < 1.0


@pytest.mark.parametrize("likelihood", ["warton", "unbiased"])
def test_fused_warton_and_unbiased(m4, likelihood):
    lik = standard_likelihood(shrinkage="warton", penalty=0.3) \
        if likelihood == "warton" else unbiased_likelihood()
    f = _run(m4, fused=True, likelihood=lik)
    assert np.all(np.isfinite(f.samples_array))


def test_fused_logit_transform(m4):
    bound = np.array([[-1.0, 1.0], [-1.0, 1.0]])
    f = _run(m4, fused=True, bound=bound)
    u = _run(m4, fused=False, bound=bound)
    assert np.all((f.samples_array > -1) & (f.samples_array < 1))
    np.testing.assert_allclose(f.sample_means_array, u.sample_means_array,
                               atol=0.15)


@pytest.mark.parametrize("case", ["semiparametric", "misspec", "batches"])
def test_fused_refused_where_the_chain_needs_the_host(m4, case):
    kw = {"semiparametric": dict(likelihood=semiparametric_likelihood()),
          "misspec": dict(likelihood=robust_likelihood("mean")),
          "batches": dict(batch_size=150)}[case]
    bsl = et.BSL(m4, n_sim_round=300, seed=4, **kw)
    with pytest.raises(ValueError, match="fused=True requires"):
        bsl.sample(5, sigma_proposals=np.diag([.05, .05]),
                   params0=np.array([[.6, .2]]), fused=True, bar=False)


def test_fused_chain_starts_at_batch_zero(m4):
    """Step 0 simulates batch index 0 at params0, as the JAX package's
    scan does: its log-posterior is the synthetic likelihood of that batch
    plus the log-prior."""
    from elfi_tpu_torch.compile.compiler import compile_program
    from elfi_tpu_torch.methods.bsl.pdf_methods import traceable_likelihood
    bsl = et.BSL(m4, n_sim_round=300, seed=4)
    bsl.sample(3, sigma_proposals=np.diag([.05, .05]),
               params0=np.array([[.6, .2]]), fused=True, bar=False)
    prog = compile_program(bsl.model, ("S1", "S2"),
                           override_names=("t1", "t2"), device="cpu")
    out = prog.run(4, 0, {"t1": np.float32(.6), "t2": np.float32(.2)},
                   batch_size=300)
    sx = torch.column_stack([out["S1"], out["S2"]])
    obs = torch.as_tensor(bsl.observed.ravel(), dtype=torch.float32)
    ll = traceable_likelihood(None, device="cpu")(sx, obs)
    lp = bsl.prior.logpdf(np.array([[.6, .2]]))
    np.testing.assert_allclose(bsl.state["logposterior"][0],
                               float(ll) + float(lp), rtol=1e-6)


# -- the accuracy gate of tests/functional/test_inference.py ----------------------

def test_fused_bsl_accuracy():
    m6 = ma2.get_model(seed_obs=271)
    bsl = et.BSL(m6, n_sim_round=600, batch_size=600, seed=6)
    res = bsl.sample(150, sigma_proposals=np.eye(2) * 0.05, burn_in=30,
                     bar=False)
    means = res.sample_means_array
    assert res.n_sim == 150 * 600      # the fused chain ran
    assert np.all(np.abs(means - TRUE) < 0.1), means


# -- mirrors of tests/unit/test_bsl_tools.py ---------------------------------------

FEATURES = ["S1", "S2"]
THETA = [0.6, 0.2]


@pytest.fixture
def plt():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")


def test_plot_features(m4, plt):
    axes = plot_features(m4, THETA, n_sim=60, feature_names=FEATURES, seed=1)
    assert axes.shape == (1, 2)
    assert all(len(ax.lines) == 1 for ax in axes.ravel())


def test_plot_features_dict_theta_and_str_name(m4, plt):
    axes = plot_features(m4, {"t1": 0.6, "t2": 0.2}, n_sim=40,
                         feature_names="S1", seed=1)
    assert axes.shape == (1, 1)


@pytest.mark.parametrize("kw", [{}, {"corr": True}, {"precision": True}])
def test_plot_covariance_matrix(m4, plt, kw):
    ax = plot_covariance_matrix(m4, THETA, n_sim=60, feature_names=FEATURES,
                                seed=1, **kw)
    mat = ax.images[0].get_array()
    assert mat.shape == (2, 2)
    if kw.get("corr"):
        np.testing.assert_allclose(np.diag(mat), 1.0, atol=1e-6)


def test_log_SL_stdev_shrinks_with_n_sim(m4):
    stds = log_SL_stdev(m4, THETA, n_sim=[20, 400], feature_names=FEATURES,
                        M=8, seed=2)
    assert stds.shape == (2,)
    assert np.all(np.isfinite(stds)) and np.all(stds > 0)
    assert stds[1] < stds[0]


def test_estimate_whitening_matrix(m4):
    W = estimate_whitening_matrix(m4, 400, THETA, FEATURES, seed=3)
    assert W.shape == (2, 2)
    # W whitens the standardized feature correlation: W C W^T = I, on the
    # same features simulated again with the same seed
    ssx = _simulate_features(m4, THETA, 400, FEATURES, seed=3, device="cpu")
    z = (ssx - ssx.mean(0)) / ssx.std(0)
    np.testing.assert_allclose(W @ np.cov(z.T) @ W.T, np.eye(2), atol=1e-5)


def test_estimate_whitening_matrix_semiparametric(m4):
    W = estimate_whitening_matrix(m4, 200, THETA, FEATURES,
                                  likelihood_type="semiparametric", seed=3)
    assert W.shape == (2, 2) and np.all(np.isfinite(W))
    with pytest.raises(ValueError):
        estimate_whitening_matrix(m4, 50, THETA, FEATURES,
                                  likelihood_type="bogus")


def test_select_penalty(m4):
    lmdas = [0.2, 0.5, 0.8]
    pick = select_penalty(m4, 60, THETA, FEATURES,
                          likelihood=standard_likelihood(), lmdas=lmdas, M=4,
                          shrinkage="warton", seed=4)
    assert pick in lmdas


def test_select_penalty_vector_n_sim(m4, capsys):
    lmdas = [0.3, 0.6]
    picks = select_penalty(m4, [40, 80], THETA, FEATURES,
                           likelihood=standard_likelihood(), lmdas=lmdas, M=3,
                           shrinkage="warton", seed=4, verbose=True)
    assert picks.shape == (2,)
    assert all(p in lmdas for p in picks)
    assert "log-SL stds per penalty" in capsys.readouterr().out
