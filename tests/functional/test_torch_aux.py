"""The port's aux modules: the mirror of ``tests/functional/test_aux.py``
(regression adjustment, model comparison, two-stage selection, the
testbench, plotting entry points and live ``vis=``), plus
``adjust_posterior`` against the JAX package's and sklearn's on the same
sample, ``compare_models`` and the selection statistics against the JAX
package's on the same arrays, ``Timers``, and ``trace`` / ``annotate`` on
the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX side of the comparisons)

import elfi_tpu as jelfi
import elfi_tpu_torch as et
from elfi_tpu.methods.diagnostics import TwoStageSelection as JaxSelection
from elfi_tpu.methods.results import Sample as JaxSample
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu_torch.methods.diagnostics import TwoStageSelection
from elfi_tpu_torch.methods.post_processing import OLS
from elfi_tpu_torch.methods.results import Sample
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.utils.profiling import Timers, annotate, trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def m():
    return ma2.get_model(seed_obs=4)


@pytest.fixture
def rejection_sample(m):
    rej = et.Rejection(m["d"], output_names=["S1", "S2"], batch_size=100,
                       seed=3)
    return rej, rej.sample(50, n_sim=500, bar=False)


def test_adjust_posterior(rejection_sample):
    rej, res = rejection_sample
    adj = et.adjust_posterior(res, rej.model, ["S1", "S2"], ["t1", "t2"])
    assert adj.n_samples == 50
    assert set(adj.samples) == {"t1", "t2"}
    # adjusted samples differ from raw but stay in a sane range
    assert not np.allclose(adj.samples["t1"], res.samples["t1"])
    assert np.all(np.abs(adj.samples["t1"]) < 5)


def test_adjust_posterior_equals_jax_and_sklearn(rejection_sample):
    """The same sample arrays through the JAX package's adjustment (sklearn's
    LinearRegression on the JAX model's observed summaries) and the port's
    (numpy least squares): equal at rtol 1e-5."""
    from sklearn.linear_model import LinearRegression
    rej, res = rejection_sample
    adj = et.adjust_posterior(res, rej.model, ["S1", "S2"], ["t1", "t2"])
    jres = JaxSample(method_name="Rejection",
                     outputs={k: np.asarray(v) for k, v in
                              res.outputs.items()},
                     parameter_names=["t1", "t2"])
    jadj = jelfi.adjust_posterior(jres, jax_ma2.get_model(seed_obs=4),
                                  ["S1", "S2"], ["t1", "t2"])
    for k in ("t1", "t2"):
        np.testing.assert_allclose(adj.samples[k], jadj.samples[k],
                                   rtol=1e-5, atol=1e-6)
    la = et.LinearAdjustment()
    la.fit(res, rej.model, ["S1", "S2"], ["t1", "t2"])
    for i, k in enumerate(("t1", "t2")):
        sk = LinearRegression().fit(la.X, res.outputs[k])
        ols = la.regression_models[i]
        np.testing.assert_allclose(ols.coef_, sk.coef_, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ols.intercept_, sk.intercept_,
                                   rtol=1e-5, atol=1e-6)


def test_ols_with_intercept():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3))
    y = 2.0 + X @ np.array([1.0, -0.5, 0.25]) + 0.01 * rng.normal(size=200)
    ols = OLS().fit(X, y)
    np.testing.assert_allclose(ols.coef_, [1.0, -0.5, 0.25], atol=0.01)
    np.testing.assert_allclose(ols.intercept_, 2.0, atol=0.01)


def test_compare_models(m):
    r1 = et.Rejection(m["d"], batch_size=50, seed=1).sample(
        20, n_sim=200, bar=False)
    r2 = et.Rejection(m["d"], batch_size=50, seed=2).sample(
        20, n_sim=400, bar=False)
    p = et.compare_models([r1, r2])
    assert p.shape == (2,)
    np.testing.assert_allclose(p.sum(), 1.0)
    p2 = et.compare_models([r1, r2], model_priors=[0.9, 0.1])
    assert p2[0] > p[0]


def test_compare_models_equals_jax():
    rng = np.random.default_rng(1)
    ports, jaxes = [], []
    for n, n_sim in ((30, 300), (40, 900), (25, 500)):
        outputs = {"t1": rng.normal(size=n),
                   "d": np.sort(rng.exponential(size=n))}
        kw = dict(method_name="Rejection", outputs=outputs,
                  parameter_names=["t1"], discrepancy_name="d", n_sim=n_sim)
        ports.append(Sample(**kw))
        jaxes.append(JaxSample(**kw))
    for priors in (None, [0.5, 0.3, 0.2]):
        np.testing.assert_array_equal(
            et.compare_models(ports, model_priors=priors),
            jelfi.compare_models(jaxes, model_priors=priors))


def test_selection_statistics_equal_jax():
    rng = np.random.default_rng(2)
    thetas = rng.normal(size=(60, 2))
    for k in (2, 4):
        assert TwoStageSelection._calc_entropy(thetas, 60, k) == \
            JaxSelection._calc_entropy(thetas, 60, k)
    obs = thetas[:5]
    assert TwoStageSelection._calc_MRSSE(None, obs, thetas) == \
        JaxSelection._calc_MRSSE(None, obs, thetas)


def ss_mean(y):
    return torch.mean(y, 1)


def ss_var(y):
    return torch.var(y, 1, unbiased=False)


def test_two_stage_selection(m):
    selector = et.TwoStageSelection(m["MA2"], "euclidean",
                                    list_ss=[ss_mean, ss_var],
                                    max_cardinality=2, seed=4)
    best = selector.run(n_sim=400, n_acc=40, n_closest=4, batch_size=100)
    assert isinstance(best, tuple)
    assert 1 <= len(best) <= 2
    # every candidate's rejection saw the same pooled simulations
    assert len(selector.pool) == 4


def test_testbench(m):
    tb = et.Testbench(model=m, repetitions=2, seed=7, progress_bar=False)
    method = et.TestbenchMethod(
        et.Rejection, method_kwargs={"batch_size": 50,
                                     "discrepancy_name": "d"},
        sample_kwargs={"n_samples": 10, "n_sim": 100, "bar": False,
                       "fused": False},
        name="rejection")
    tb.add_method(method)
    tb.run()
    out = tb.get_testbench_results()
    assert len(out["results"]) == 1
    assert len(out["results"][0]["results"]) == 2
    diffs = tb.parameterwise_sample_mean_differences()
    assert set(diffs["rejection"]) == {"t1", "t2"}


def test_visualization_entry_points(m):
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    res = et.Rejection(m["d"], batch_size=50, seed=3).sample(
        20, n_sim=200, bar=False)
    res.plot_marginals()
    res.plot_pairs()
    et.draw(m)
    plt.close("all")


def test_live_vis_plumbing(m):
    """vis= drives plot_state every consumed batch, then once to close;
    BOLFI's vis runs the host loop and draws the GP contour."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    calls = []
    rej = et.Rejection(m["d"], batch_size=2000, seed=0)
    orig = rej.plot_state

    def counting(**kw):
        calls.append(kw)
        return orig(**kw)

    rej.plot_state = counting
    res = rej.sample(50, n_sim=8000, bar=False,
                     vis=dict(xlim=(-2, 2), ylim=(-1, 1)))
    assert res.n_samples == 50
    assert len(calls) == 8000 // 2000 + 1       # per batch + final close
    assert calls[0]["interactive"] and calls[0]["xlim"] == (-2, 2)
    assert calls[-1]["close"] and "interactive" not in calls[-1]

    mc = m.copy()
    et.Operation(torch.log, mc["d"], model=mc, name="log_d_vis")
    b = et.BOLFI(mc["log_d_vis"], batch_size=1, initial_evidence=10,
                 update_interval=5, seed=1,
                 bounds={"t1": (-2, 2), "t2": (-1, 1)})
    b.fit(n_evidence=12, bar=False, vis=True)
    assert b.target_model.n_evidence == 12
    b.plot_discrepancy()
    b.plot_gp(resol=5)
    plt.close("all")


def test_timers():
    t = Timers()
    with t.time("a"):
        pass
    with t.time("a"):
        pass
    with t.time("b"):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2 and rep["b"]["calls"] == 1
    assert rep["a"]["total_s"] >= 0 and "a" in repr(t)
    t.reset()
    assert t.report() == {} and repr(t) == "Timers()"


def test_trace_and_annotate_on_the_cpu(tmp_path, m):
    logdir = str(tmp_path / "trace")
    rej = et.Rejection(m["d"], batch_size=64, seed=1)
    with trace(logdir):
        with annotate("one_batch"):
            rej.sample(5, n_sim=64, bar=False)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "one_batch" for e in events)


def test_recorded_holds_the_block_once(m):
    """``recorded`` discards its warm-up step and records the block: the
    profile holds the block's annotation once, and its operators."""
    from elfi_tpu_torch.utils.profiling import recorded
    rej = et.Rejection(m["d"], batch_size=64, seed=1)
    with recorded() as prof:
        with annotate("the_block"):
            rej.sample(5, n_sim=64, bar=False)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("the_block") == 1
    assert any(k.startswith("aten::") for k in counts)


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a CUDA device, and no backend set."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    et.reset_client()


def _entry_points():
    from elfi_tpu_torch.methods.romc import RegionConstructor
    from elfi_tpu_torch.ops import distributions as dists
    # the model draws its observed data on the global backend's device:
    # the CPU here, then the backend is reset for the call that must raise
    et.set_client("native", device="cpu")
    m = ma2.get_model(seed_obs=4)
    et.reset_client()
    yield "RegionConstructor", lambda: RegionConstructor(
        None, lambda x: x.sum(-1), 2, 0.1)
    yield "TwoStageSelection", lambda: et.TwoStageSelection(
        m["MA2"], "euclidean", list_ss=[ss_mean]).run(
        n_sim=400, n_acc=40, n_closest=4, batch_size=100)
    yield "Testbench", lambda: et.Testbench(model=m, repetitions=2, seed=1)
    for name, args in (("gamma", (2.0,)), ("beta", (2.0, 5.0)),
                       ("poisson", (3.0,)), ("t", (5.0,)),
                       ("cauchy", ()), ("skewnorm", (2.0,))):
        yield f"{name}.rvs", lambda name=name, args=args: getattr(
            dists, name).rvs(*args, size=4)


@pytest.mark.parametrize("entry", [n for n, _ in _entry_points()])
def test_entry_point_without_a_device_raises_without_cuda(no_cuda, entry):
    """No CPU fallback: with no card and no CPU asked for, the call raises
    (``RegionConstructor`` defaulted to the CPU before)."""
    call = dict(_entry_points())[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_region_constructor_takes_the_global_device(m):
    from elfi_tpu_torch.methods.romc import RegionConstructor
    rc = RegionConstructor(None, lambda x: x.sum(-1), 2, 0.1)
    assert rc.device == torch.device("cpu")
