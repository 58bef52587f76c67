"""SMC-ABC end to end in the PyTorch port, on the CPU: the port's mirrors
of the JAX package's ``tests/functional/test_smc.py``, the global batch
indices across rounds, the fused and batch-at-a-time proposals, the
slice's API on MA2 (both graphs) and the Gaussian models, and the
accuracy gates of ``tests/functional/test_inference.py`` for the three SMC
samplers."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.methods.density_ratio_estimation import \
    DensityRatioEstimation
from elfi_tpu_torch.methods.samplers import _GMProposals
from elfi_tpu_torch.methods.utils import GMDistribution
from elfi_tpu_torch.model.model import node_uid
from elfi_tpu_torch.models import gauss, ma2, ma2_kernel
from elfi_tpu_torch.utils import get_sub_seed
from elfi_tpu_torch.utils.rng import stream_seed

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


def _weighted_means(res):
    w = res.weights / res.weights.sum()
    return np.array([np.sum(np.asarray(res.samples[k]).reshape(len(w), -1)
                            * w[:, None], axis=0) for k in res.samples])


def _gate(res, atol=0.05):
    means = _weighted_means(res).ravel()
    err = np.abs(means - TRUE)
    assert np.all(err < atol), f"posterior means {means}, err {err}"


# -- mirrors of tests/functional/test_smc.py ----------------------------------

def test_smc_quantiles(m4):
    res = et.SMC(m4["d"], batch_size=200, seed=42).sample(
        50, quantiles=[0.5, 0.5], bar=False)
    assert res.n_samples == 50 and res.n_populations == 2
    assert res.weights is not None
    t0 = res.populations[0].meta["threshold"]
    assert np.max(res.populations[1].discrepancies) <= np.max(
        np.atleast_1d(t0))


@pytest.mark.parametrize("fused", [True, False])
def test_smc_thresholds(m4, fused):
    res = et.SMC(m4["d"], batch_size=200, seed=42).sample(
        30, thresholds=[1.0, 0.5], bar=False, fused=fused)
    assert np.all(res.populations[-1].discrepancies <= 0.5)
    assert np.all(res.populations[0].discrepancies <= 1.0)


def test_smc_determinism(m4):
    def run(seed):
        return et.SMC(m4["d"], batch_size=100, seed=seed).sample(
            20, quantiles=[0.5, 0.5], bar=False).samples["t1"]

    np.testing.assert_array_equal(run(7), run(7))
    assert not np.array_equal(run(7), run(8))


def test_smc_weights_cover_prior_change(m4):
    res = et.SMC(m4["d"], batch_size=200, seed=1).sample(
        40, quantiles=[0.5, 0.5], bar=False)
    assert np.all(res.weights >= 0) and np.sum(res.weights) > 0
    assert np.all(res.populations[0].weights == 1)
    cov = res.populations[0].meta["cov"]
    assert cov.shape == (2, 2) and np.all(np.diag(cov) > 0)


def test_smc_fused_equals_unfused_single_round(m4):
    """A quantile round 0 has a fixed batch count, so fused and
    batch-at-a-time runs agree bit for bit."""
    kw = dict(batch_size=500, seed=31)
    r1 = et.SMC(m4["d"], **kw).sample(100, quantiles=[0.2], bar=False,
                                      fused=False)
    r2 = et.SMC(m4["d"], **kw).sample(100, quantiles=[0.2], bar=False,
                                      fused=True)
    np.testing.assert_array_equal(r1.samples_array, r2.samples_array)
    np.testing.assert_array_equal(r1.discrepancies, r2.discrepancies)


def test_smc_fused_multiround(m4):
    kw = dict(batch_size=1000, seed=7)
    f1 = et.SMC(m4["d"], **kw).sample(300, thresholds=[1.0, 0.5, 0.25],
                                      bar=False, fused=True)
    f2 = et.SMC(m4["d"], **kw).sample(300, thresholds=[1.0, 0.5, 0.25],
                                      bar=False, fused=True)
    np.testing.assert_array_equal(f1.samples_array, f2.samples_array)
    assert f1.n_populations == 3
    assert float(np.max(f1.discrepancies)) <= 0.25
    u = et.SMC(m4["d"], batch_size=1000, seed=8).sample(
        300, thresholds=[1.0, 0.5, 0.25], bar=False, fused=False)
    np.testing.assert_allclose(_weighted_means(f1), _weighted_means(u),
                               atol=0.12)


def test_fused_overrides_actually_flow(m4):
    """A per-batch overrides builder replaces the parameter nodes inside
    the fused loop."""
    rej = et.Rejection(m4["d"], batch_size=100, seed=2)
    rej.set_objective(10, n_sim=300)
    prog = compile_program(rej.model, tuple(rej.output_names),
                           override_names=("t1", "t2"), device=rej.device)
    rej.bar = False
    rej._run_fused(prog, None, overrides_spec=lambda i: {
        "t1": torch.full((100,), 0.7), "t2": torch.full((100,), 0.15)})
    res = rej.extract_result()
    np.testing.assert_allclose(res.samples["t1"], 0.7, rtol=1e-6)
    np.testing.assert_allclose(res.samples["t2"], 0.15, rtol=1e-6)
    assert rej.state["n_batches"] == 3


def test_smc_fused_proposals_shrink_n_sim(m4):
    f = et.SMC(m4["d"], batch_size=1000, seed=9).sample(
        300, thresholds=[1.0, 0.3, 0.1], bar=False, fused=True)
    u = et.SMC(m4["d"], batch_size=1000, seed=10).sample(
        300, thresholds=[1.0, 0.3, 0.1], bar=False, fused=False)
    assert float(np.max(f.discrepancies)) <= 0.1
    assert f.n_sim <= 4 * u.n_sim
    # from the prior alone, d <= 0.1 accepts about 1 % of simulations
    assert u.n_sim < 300 / 0.01
    np.testing.assert_allclose(_weighted_means(f), _weighted_means(u),
                               atol=0.12)


def test_adaptive_threshold_smc_fused(m4):
    def make():
        return et.AdaptiveThresholdSMC(
            m4["d"], batch_size=500, seed=11, initial_quantile=0.3,
            densratio_estimation=DensityRatioEstimation(
                n=20, epsilon=0.001, max_iter=200, abs_tol=0.01))
    f1 = make().sample(100, max_iter=3, bar=False, fused=True)
    f2 = make().sample(100, max_iter=3, bar=False, fused=True)
    np.testing.assert_array_equal(f1.samples_array, f2.samples_array)
    assert 1 <= f1.n_populations <= 3
    u = make().sample(100, max_iter=3, bar=False, fused=False)
    np.testing.assert_allclose(_weighted_means(f1), _weighted_means(u),
                               atol=0.3)


def test_adaptive_distance_smc_three_rounds(m4):
    """Each round adds one weight vector, so each round's program outputs
    one more distance column; the thresholds are vectors from round 1."""
    et.AdaptiveDistance(m4["S1"], m4["S2"], model=m4, name="ad")
    smc = et.AdaptiveDistanceSMC(m4["ad"], batch_size=100, seed=5)
    res = smc.sample(20, rounds=3, quantile=0.5, bar=False)
    assert res.n_samples == 20 and res.n_populations == 3
    assert len(res.adaptive_distance_w) == 3
    assert all(w.shape == (2,) for w in res.adaptive_distance_w)
    thr = smc._rejection._merge_threshold()
    assert isinstance(thr, torch.Tensor) and thr.shape == (3,)
    assert thr[0] == np.inf and torch.all(thr[1:] > 0)
    assert smc._resolve_fused(None, {}) == (False, None)
    with pytest.raises(ValueError, match="adaptive"):
        smc._resolve_fused(True, {})


def test_adaptive_distance_smc_requires_adaptive_node(m4):
    with pytest.raises(TypeError, match="adaptive"):
        et.AdaptiveDistanceSMC(m4["d"], batch_size=100)


def test_smc_requires_an_objective(m4):
    with pytest.raises(ValueError, match="thresholds or quantiles"):
        et.SMC(m4["d"], batch_size=100, seed=1).sample(10, bar=False)


# -- batch indices and proposals ----------------------------------------------

def _record_kernel_seeds(monkeypatch):
    """Spy on the MA2 kernel graph's wrapper: the stream seed of each call
    in order (a bijection of the batch index for one seed and node)."""
    import elfi_tpu_torch.models.ma2_kernel as mk
    seeds = []
    real = mk.ma2_distance

    def spy(t1, t2, obs, n_obs, batch_size, generator):
        seeds.append(generator.initial_seed())
        return real(t1, t2, obs, n_obs=n_obs, batch_size=batch_size,
                    generator=generator)

    monkeypatch.setattr(mk, "ma2_distance", spy)
    return seeds


@pytest.mark.parametrize("fused", [True, False])
def test_batch_indices_run_on_across_rounds(monkeypatch, fused):
    """Every round simulates at fresh global batch indices 0, 1, 2, ...;
    a round that restarted at 0 would reuse round 0's noise.  Seen through
    the kernel graph's stream seeds: one kernel call per batch."""
    seeds = _record_kernel_seeds(monkeypatch)
    m = ma2_kernel.get_model(seed_obs=4)
    res = et.SMC(m["d"], batch_size=256, seed=3).sample(
        50, quantiles=[0.2, 0.5, 0.5], bar=False, fused=fused)
    uid = node_uid("d")
    want = [stream_seed(3, i, uid) & (2**64 - 1) for i in range(len(seeds))]
    # the CPU generator keeps the low 32 bits of its seed
    assert [s & 0xFFFFFFFF for s in seeds] == [w & 0xFFFFFFFF for w in want]
    assert len(seeds) == res.n_batches
    assert res.n_batches == sum(p.meta["n_batches"]
                                for p in res.populations)
    assert res.n_sim == res.n_batches * 256


def test_continuation_appends_rounds_at_fresh_batch_indices(monkeypatch):
    seeds = _record_kernel_seeds(monkeypatch)
    m = ma2_kernel.get_model(seed_obs=4)
    smc = et.SMC(m["d"], batch_size=256, seed=3)
    smc.sample(50, quantiles=[0.2, 0.5], bar=False)
    n_first = len(seeds)
    res = smc.sample(50, quantiles=[0.5], bar=False)
    assert res.n_populations == 3
    assert len(set(seeds)) == len(seeds) > n_first
    assert smc.state["_next_batch_index"] == len(seeds)


def test_prepare_new_batch_equals_fused_builder(m4):
    """Round 1 with a wide mixture (prior-support redraws happen): the
    batch-at-a-time proposals and a fused builder made afresh from the same
    population are equal bit for bit, and the draws depend on the batch
    index."""
    smc = et.SMC(m4["d"], batch_size=256, seed=13)
    smc.sample(100, quantiles=[0.5], bar=False)
    pop = smc._populations[-1]
    pop.meta["cov"] = np.diag([0.4, 0.3])
    smc.sample(100, quantiles=[0.5], bar=False)        # round 1 begins
    assert smc.state["round"] == 1
    builder = _GMProposals(
        smc.parameter_names, 256, smc._prior.traceable_logpdf(),
        GMDistribution.prepare(pop.means, np.diag([0.4, 0.3]), pop.weights),
        get_sub_seed(13, 1))
    for i in (5, 6):
        a, b = smc.prepare_new_batch(i), builder(i)
        for k in ("t1", "t2"):
            assert torch.equal(a[k], b[k]), k
        x = torch.stack([a["t1"], a["t2"]], dim=1)
        assert torch.all(torch.isfinite(smc._prior.traceable_logpdf()(x)))
    assert not torch.equal(smc.prepare_new_batch(5)["t1"],
                           smc.prepare_new_batch(6)["t1"])


def test_zero_weights_raise(m4):
    smc = et.SMC(m4["d"], batch_size=200, seed=1)
    smc.sample(40, quantiles=[0.5], bar=False)
    pop = smc._populations[-1]
    pop.weights = np.zeros_like(pop.weights)
    smc._spawn_round_rejection(1)       # round 1's mixture over that population
    with pytest.raises(RuntimeError, match="weight is zero"):
        smc._weigh_population(pop)


# -- the slice's API on every model -------------------------------------------

MODELS = {
    "ma2": lambda: ma2.get_model(seed_obs=4)["d"],
    "ma2_kernel": lambda: ma2_kernel.get_model(seed_obs=4)["d"],
    "gauss1d": lambda: gauss.get_model(seed_obs=3)["d"],
    "gauss2d": lambda: gauss.get_model(
        n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
        cov_matrix=np.eye(2))["d"],
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("method", ["SMC", "AdaptiveThresholdSMC"])
def test_samplers_run_on_every_model(model, method):
    node = MODELS[model]()
    if method == "SMC":
        res = et.SMC(node, batch_size=256, seed=2).sample(
            40, quantiles=[0.3, 0.5], bar=False)
        assert res.n_populations == 2
    else:
        res = et.AdaptiveThresholdSMC(
            node, batch_size=256, seed=2, densratio_estimation=
            DensityRatioEstimation(n=20, epsilon=0.001, max_iter=100)
        ).sample(40, max_iter=2, bar=False)
        assert 1 <= res.n_populations <= 2
    assert isinstance(res, et.SmcSample) and res.n_samples == 40
    assert np.all(np.isfinite(res.samples_array))
    assert np.all(np.isfinite(res.weights)) and np.any(res.weights > 0)
    assert res.posterior_means().keys() == res.samples.keys()


@pytest.mark.parametrize("model", ["gauss1d", "gauss2d"])
def test_adaptive_distance_smc_on_gauss(model):
    m = MODELS[model]().model
    et.AdaptiveDistance(m["ss_mean"], m["ss_var"], model=m, name="ad")
    res = et.AdaptiveDistanceSMC(m["ad"], batch_size=256, seed=4).sample(
        30, rounds=2, quantile=0.5, bar=False)
    assert res.n_populations == 2
    assert np.all(np.isfinite(res.samples_array))


def test_gauss2d_smc_recovers_the_observed_mean():
    """The bench's gauss2d operating point cut to batch 4096 and 500
    samples: within 0.05 of the observed sample mean."""
    m = gauss.get_model(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
                        cov_matrix=np.eye(2))
    obs_mean = m.observed["gauss"].reshape(-1, 2).mean(0)
    res = et.SMC(m["d"], batch_size=4096, seed=4).sample(
        500, thresholds=[2.0, 1.0, 0.5, 0.3], bar=False)
    assert float(np.max(res.discrepancies)) <= 0.3
    assert np.all(np.abs(_weighted_means(res).ravel() - obs_mean) < 0.05)


# -- the accuracy gates of tests/functional/test_inference.py ------------------

@pytest.mark.parametrize("graph", ["plain", "kernel"])
def test_smc_accuracy(graph):
    mod = ma2 if graph == "plain" else ma2_kernel
    res = et.SMC(mod.get_model(seed_obs=271)["d"], batch_size=2000,
                 seed=3).sample(500, quantiles=[0.25, 0.25, 0.25],
                                bar=False)
    _gate(res)


def test_adaptive_threshold_smc_accuracy():
    smc = et.AdaptiveThresholdSMC(
        ma2.get_model(seed_obs=271)["d"], batch_size=2000, seed=4,
        initial_quantile=0.25,
        densratio_estimation=DensityRatioEstimation(n=80, epsilon=0.001,
                                                    max_iter=150,
                                                    abs_tol=0.01))
    _gate(smc.sample(400, max_iter=4, bar=False))


def test_adaptive_distance_smc_accuracy():
    m = ma2.get_model(seed_obs=271)
    et.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
    smc = et.AdaptiveDistanceSMC(m["ad"], batch_size=2000, seed=10)
    _gate(smc.sample(500, rounds=3, quantile=0.25, bar=False))
