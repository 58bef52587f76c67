"""The port's plotting layer (``elfi_tpu_torch/visualization.py``) under
Agg: the mirror of ``tests/unit/test_visualization.py``, the result
objects' plotting methods (SMC populations, BSL and BOLFI traces),
``Sample.idata``'s dict fallback, tensors on the way in, and a fresh
process in which ``import elfi_tpu_torch`` leaves matplotlib unimported."""

import subprocess
import sys

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402

import elfi_tpu_torch as et  # noqa: E402
from elfi_tpu_torch import visualization as vis  # noqa: E402
from elfi_tpu_torch.methods.results import (BolfiSample,  # noqa: E402
                                            BslSample)
from elfi_tpu_torch.models import ma2  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()
    plt.close("all")


@pytest.fixture
def m():
    return ma2.get_model(seed_obs=4)


@pytest.fixture
def samples():
    rng = np.random.RandomState(0)
    return {"t1": rng.normal(0.6, 0.1, 200), "t2": rng.normal(0.2, 0.1, 200)}


def test_import_leaves_matplotlib_unimported():
    code = ("import sys, elfi_tpu_torch; "
            "print('matplotlib' in sys.modules, 'IPython' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.split() == ["False", "False"]


def test_plot_marginals(samples):
    axes = vis.plot_marginals(samples)
    assert len(axes) == 2
    assert axes[0].get_xlabel() == "t1"


def test_plot_marginals_selector(samples):
    axes = vis.plot_marginals(samples, selector=["t2"])
    assert len(axes) == 1
    assert axes[0].get_xlabel() == "t2"


def test_plot_pairs(samples):
    axes = vis.plot_pairs(samples)
    assert axes.shape == (2, 2)
    assert axes[1][0].get_xlabel() == "t1"
    assert axes[1][0].get_ylabel() == "t2"


def test_plot_pairs_of_tensors(samples):
    axes = vis.plot_pairs({k: torch.as_tensor(v) for k, v in
                           samples.items()})
    assert axes.shape == (2, 2)


def test_plot_traces():
    class FakeResult:
        chains = np.random.RandomState(1).normal(size=(4, 50, 2))
        parameter_names = ["a", "b"]
        warmup = 10

    axes = vis.plot_traces(FakeResult())
    assert len(axes) == 2
    # every chain drawn plus the warmup marker
    assert len(axes[0].lines) == 4 + 1


def test_result_traces():
    chains = np.random.RandomState(2).normal(size=(3, 40, 2))
    bolfi = BolfiSample("BOLFI", chains, ["a", "b"], warmup=5)
    assert len(bolfi.plot_traces()[0].lines) == 3 + 1
    bsl = BslSample("BSL", {"a": chains[0, :, 0], "b": chains[0, :, 1]},
                    ["a", "b"], burn_in=5)
    axes = bsl.plot_traces()
    assert len(axes) == 2 and len(axes[1].lines) == 1 + 1


def test_plot_sample_scatter_and_hist(samples):
    vis.plot_sample(samples)                      # 2-node scatter
    vis.plot_sample(samples, nodes="t1", close=True)  # 1-node histogram


class FakeGP:
    """Duck-typed stand-in for GPRegression in plot helpers."""

    def __init__(self, dim=2, n=30):
        rng = np.random.RandomState(2)
        self.x = rng.uniform(0, 1, size=(n, dim))
        self.y = rng.uniform(0, 1, size=(n, 1))
        self.bounds = [(0.0, 1.0)] * dim

    def predict(self, x):
        x = np.asarray(x)
        mu = np.sum(x, axis=1, keepdims=True)
        return mu, np.ones_like(mu)


def test_plot_discrepancy():
    axes = vis.plot_discrepancy(FakeGP(), ["p0", "p1"])
    assert len(axes) == 2
    assert axes[1].get_xlabel() == "p1"


def test_plot_gp():
    axes = vis.plot_gp(FakeGP(), ["p0", "p1"], resol=8,
                       true_params={"p0": 0.5, "p1": 0.5})
    assert axes.shape == (2, 2)


def test_plot_gp_real_surrogate(m):
    """plot_gp, plot_discrepancy and the posterior's plot against the real
    GP class, not just the duck type."""
    bolfi = et.BOLFI(m["d"], batch_size=4, initial_evidence=12,
                     update_interval=100, bounds={"t1": (-2, 2),
                                                  "t2": (-1, 1)}, seed=7)
    post = bolfi.fit(n_evidence=12, bar=False)
    vis.plot_gp(bolfi.target_model, ["t1", "t2"], resol=5)
    vis.plot_discrepancy(bolfi.target_model, ["t1", "t2"])
    bolfi.plot_state()
    assert post.plot().shape == (2, 2)


def test_nx_draw(m):
    # With or without graphviz this must not raise; graphviz returns a
    # Digraph, the matplotlib fallback returns None.
    vis.nx_draw(m)
    vis.nx_draw(m, internal=True)


def test_plot_params_vs_node(m):
    axes = vis.plot_params_vs_node(m["S1"], n_samples=20, seed=3)
    assert len(axes) == len(m.parameter_names)


def test_plot_params_vs_node_parameter(m):
    axes = vis.plot_params_vs_node(m["t1"], n_samples=20, seed=3)
    assert len(axes) == 1


def test_plot_predicted_summaries(m):
    axes = vis.plot_predicted_summaries(model=m, summary_names=["S1", "S2"],
                                        n_samples=20, seed=3)
    assert axes.shape == (2, 2)


def test_draw_contour():
    def fn(g):
        return np.sum(np.asarray(g) ** 2, axis=1)

    pts = np.array([[0.1, 0.2], [0.3, 0.4]])
    ax = vis.draw_contour(fn, [(-1, 1), (-1, 1)], resol=8,
                          parameter_names=["x", "y"], title="t", points=pts)
    assert ax.get_title() == "t"


def test_sample_plot_methods_and_idata(m):
    """Result-object plotting entry points used in the tutorials, the SMC
    populations, and the dict fallback of ``idata`` without arviz."""
    res = et.Rejection(m["d"], batch_size=64, seed=5).sample(
        20, quantile=0.2, bar=False)
    res.plot_marginals()
    res.plot_pairs()
    idata = res.idata
    try:
        import arviz  # noqa: F401
    except ImportError:
        assert set(idata) == {"t1", "t2"}
        np.testing.assert_array_equal(idata["t1"], res.samples["t1"])
    smc = et.SMC(m["d"], batch_size=200, seed=2).sample(
        20, quantiles=[0.5, 0.5], bar=False)
    n_figs = len(plt.get_fignums())
    smc.plot_populations()
    assert len(plt.get_fignums()) == n_figs + 2


def test_progress_bar(capsys):
    bar = vis.ProgressBar(prefix="P")
    bar.reinit_progressbar(reinit_msg="round 1")
    bar.update_progressbar(5, 10)
    bar.update_progressbar(10, 10)
    out = capsys.readouterr().out
    assert "round 1" in out and "100.0%" in out
    assert bar.finished


def test_sampler_progress_bar_reinit_as_jax(capsys):
    """``methods.base._ProgressBar.reinit`` (``elfi_tpu/methods/base.py:311``)
    prints the same text and keeps the same scaling as the JAX package's."""
    from elfi_tpu.methods.base import _ProgressBar as JaxBar
    from elfi_tpu_torch.methods.base import _ProgressBar
    outs = []
    for cls in (JaxBar, _ProgressBar):
        bar = cls()
        bar.reinit(scaling=3, msg="round 2")
        bar.reinit(scaling=4)
        bar.update(5, 10)
        bar.finish()
        outs.append((capsys.readouterr().out, bar.scaling))
    assert outs[0] == outs[1]
