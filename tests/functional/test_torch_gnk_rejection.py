"""g-and-k rejection-ABC end to end in the PyTorch port, on the CPU: both
g-and-k graphs agree with the JAX package's posterior at the bench's
ground-truth call, the fused and batch-at-a-time loops agree bit for bit,
the kernel graph goes through the kernel's wrapper, and the bivariate model
runs."""

import numpy as np
import pytest
import torch

import elfi_tpu as elfi
import elfi_tpu_torch as et
from elfi_tpu.models import gnk as jax_gnk
from elfi_tpu_torch.models import bignk, gnk, gnk_kernel

torch.set_num_threads(1)

MODELS = {"plain": gnk, "kernel": gnk_kernel}
NAMES = ["A", "B", "g", "k"]
# the bench's ground-truth call (bench.py:221-224)
CALL = dict(batch_size=1 << 14, seed=8)
N_SAMPLES, N_SIM = 1000, 1 << 20
# g is weakly identified (the skewness term saturates for g >~ 2), so its
# posterior mean moves most between random streams
TOL = np.array([0.2, 0.2, 1.0, 0.1])


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture(scope="module")
def jax_means():
    m = jax_gnk.get_model(n_obs=50, seed_obs=1)
    res = elfi.Rejection(m["d"], **CALL).sample(N_SAMPLES, n_sim=N_SIM,
                                                bar=False)
    return np.array([np.mean(res.samples[k]) for k in NAMES])


@pytest.mark.parametrize("graph", sorted(MODELS))
def test_gnk_posterior_agrees_with_jax(graph, jax_means):
    m = MODELS[graph].get_model(n_obs=50, seed_obs=1)
    res = et.Rejection(m["d"], **CALL, device="cpu").sample(
        N_SAMPLES, n_sim=N_SIM, bar=False)
    assert res.n_sim == N_SIM and res.n_batches == 64
    d = res.outputs["d"]
    assert d.shape == (N_SAMPLES,) and np.all(np.diff(d) >= 0)
    means = np.array([np.mean(res.samples[k]) for k in NAMES])
    err = np.abs(means - jax_means)
    assert np.all(err < TOL), f"means {means}, JAX {jax_means}, err {err}"


@pytest.mark.parametrize("graph", sorted(MODELS))
def test_fused_equals_batch_at_a_time(graph):
    m = MODELS[graph].get_model(seed_obs=2)
    kw = dict(batch_size=2048, seed=7, device="cpu")
    a = et.Rejection(m["d"], **kw).sample(200, n_sim=5 * 2048, bar=False)
    b = et.Rejection(m["d"], **kw).sample(200, n_sim=5 * 2048, bar=False,
                                          fused=False)
    assert a.n_sim == b.n_sim and sorted(a.outputs) == sorted(b.outputs)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)


def test_kernel_graph_runs_through_the_wrapper(monkeypatch):
    """The kernel graph's discrepancy node calls the kernel's wrapper once
    per batch, with the node's own generator."""
    import elfi_tpu_torch.models.gnk_kernel as gk
    calls = []
    real = gk.gnk_distance

    def spy(A, B, g, k, obs, n_obs, batch_size, generator):
        calls.append((batch_size, generator.initial_seed()))
        return real(A, B, g, k, obs, n_obs=n_obs, batch_size=batch_size,
                    generator=generator)

    monkeypatch.setattr(gk, "gnk_distance", spy)
    m = gk.get_model(seed_obs=1)
    et.Rejection(m["d"], batch_size=1024, seed=0).sample(
        10, n_sim=3 * 1024, bar=False)
    assert [c[0] for c in calls] == [1024] * 3
    assert len({c[1] for c in calls}) == 3


@pytest.mark.parametrize("mod", [gnk, bignk], ids=["gnk", "bignk"])
def test_smoke_rejection(mod):
    """The smoke run of the JAX package's test_examples.py."""
    res = et.Rejection(mod.get_model(seed_obs=3)["d"], batch_size=16,
                       seed=2).sample(4, quantile=0.5, bar=False)
    assert res.n_samples == 4
    assert np.all(np.isfinite(res.samples_array))
