"""Every zoo model's observed data, generated by the port from its Threefry
streams, against the JAX package's ``get_model`` at the committed settings
and at settings no file holds (another ``seed_obs``, ``n_obs`` and true
parameters, Lorenz-96 from another initial state, the n-D Gaussian with
other covariances).

Tolerances, as measured on the CPU (the draws themselves are bit for bit,
or within 2 ulp for the normals' tails, ``test_torch_threefry.py``):

- integer outputs equal: Ricker's counts, the toad's return decisions and
  refuge days, the daycare states (the event loop sums the hazards in
  XLA's CPU order, ``xla_math.reduce_sum`` and ``cumsum``, at the small
  sizes and at 29 x 53 x 33), the Lotka-Volterra populations (the event
  loop takes XLA's fused sum of the hazards, so the events and the
  interpolated counts are the JAX package's bit for bit);
- linear models (MA2, AR(1), the Gaussians, g-and-k, BiGNK): rtol 1e-6 of
  the array's largest magnitude (XLA fuses a multiply into an add where the
  port rounds twice; an AR(1) value near 0 keeps its neighbours' absolute
  rounding);
- the nonlinear recursions (ARCH, SV, M/G/1, the toad's positions): rtol
  1e-5 of the largest magnitude;
- Lorenz-96: atol 1e-2 (``LORENZ_ATOL``): chaotic over the 4 time units,
  the two packages' float32 RK4 steps part by an ulp and the gap grows;
  measured at most 2.7e-3 (absolute, on states of about 13) on these
  settings and 1.3e-3 on the committed ones.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

import elfi_tpu_torch as et
from elfi_tpu_torch.utils import threefry

torch.set_num_threads(1)

LINEAR = 1e-6
NONLINEAR = 1e-5
LORENZ_ATOL = 1e-2
SMALL_DAYCARE = dict(n_dcc=2, n_ind=8, n_strains=4, n_obs=6, time_end=0.5)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _pair(name, kw, node):
    want = np.asarray(importlib.import_module(
        f"elfi_tpu.models.{name}").get_model(**kw).observed[node])
    got = importlib.import_module(
        f"elfi_tpu_torch.models.{name}").get_model(**kw).observed[node]
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    return got, want


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


#: (model, get_model arguments, simulator node, tolerance); the first
#: cases of each model are committed settings, the rest are not
CASES = [
    ("ma2", dict(), "MA2", LINEAR),
    ("ma2", dict(seed_obs=271), "MA2", LINEAR),
    ("ma2", dict(seed_obs=1), "MA2", LINEAR),
    ("ma2", dict(n_obs=57, true_params=[.3, -.1], seed_obs=9), "MA2",
     LINEAR),
    ("gnk", dict(seed_obs=3), "GNK", LINEAR),
    ("gnk", dict(seed_obs=4), "GNK", LINEAR),
    ("gnk", dict(n_obs=100, seed=7), "GNK", LINEAR),
    ("gnk", dict(true_params=[2, .5, 1, .3], seed_obs=2), "GNK", LINEAR),
    ("bignk", dict(seed_obs=3), "BiGNK", LINEAR),
    ("bignk", dict(seed_obs=5, n_obs=70,
                   true_params=[2, 3, 1, .7, .5, 1.5, .3, .2, -.4]),
     "BiGNK", LINEAR),
    ("gauss", dict(seed_obs=3), "gauss", LINEAR),
    ("gauss", dict(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
                   cov_matrix=np.eye(2)), "gauss", LINEAR),
    ("gauss", dict(seed_obs=5, n_obs=20, true_params=[1., 2.]), "gauss",
     LINEAR),
    ("gauss", dict(nd_mean=True, cov_matrix=2 * np.eye(2)), "gauss", LINEAR),
    ("gauss", dict(nd_mean=True, true_params=[1, 2, 3], seed_obs=3,
                   cov_matrix=[[2, .5, .1], [.5, 1, .2], [.1, .2, .7]]),
     "gauss", LINEAR),
    ("ar1", dict(seed_obs=3), "AR1", LINEAR),
    ("ar1", dict(n_obs=500, seed_obs=2, true_params=[.5]), "AR1", LINEAR),
    ("arch", dict(seed_obs=3), "Y", NONLINEAR),
    ("arch", dict(seed_obs=6, n_obs=70, true_params=[.1, .4]), "Y",
     NONLINEAR),
    ("mg1", dict(seed_obs=3), "MG1", NONLINEAR),
    ("mg1", dict(seed_obs=6, n_obs=70, true_params=[.5, 3., .3]), "MG1",
     NONLINEAR),
    ("stochastic_volatility", dict(), "a_svm", NONLINEAR),
    ("stochastic_volatility", dict(seed_obs=8, n_obs=80,
                                   true_params=[1.5, -.3]), "a_svm",
     NONLINEAR),
    ("toad", dict(seed_obs=3, n_toads=10, n_days=20), "toad", NONLINEAR),
    ("toad", dict(seed_obs=9, n_toads=12, n_days=25,
                  true_params=[1.3, 20., .4]), "toad", NONLINEAR),
]


@pytest.mark.parametrize("name,kw,node,rtol", CASES)
def test_generated_observed_data_equal_jax(name, kw, node, rtol):
    got, want = _pair(name, kw, node)
    _close(got, want, rtol)


@pytest.mark.parametrize("kw", [
    dict(), dict(seed_obs=3), dict(seed_obs=11, n_obs=80,
                                   true_params=[4.2, .2, 20.]),
    dict(stochastic=False), dict(stochastic=False, true_params=[3.1],
                                 n_obs=70)])
def test_ricker_counts_equal_jax(kw):
    """The map is chaotic at these rates: the port runs it in XLA's float32
    arithmetic, and the Poisson counts (and the deterministic stocks) are
    equal."""
    got, want = _pair("ricker", kw, "Ricker")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(n_obs=8, seed_obs=3, time_end=5.),
    dict(n_obs=10, seed_obs=6, time_end=4.),
    dict(n_obs=10, seed_obs=2, time_end=4., true_params=[.8, .006, .5, 40,
                                                          90, 0.]),
    dict(n_obs=10, seed_obs=2, time_end=4., observation_noise=True)])
def test_lotka_volterra_populations_equal_jax(kw):
    got, want = _pair("lotka_volterra", kw, "LV")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(seed_obs=3, **SMALL_DAYCARE), dict(seed_obs=None, **SMALL_DAYCARE),
    dict(seed_obs=8, **{**SMALL_DAYCARE, "n_dcc": 3}),
    dict(seed_obs=2, true_params=[5., .4, .3],
         **{**SMALL_DAYCARE, "n_ind": 12, "n_strains": 6, "time_end": 1.}),
    dict(seed_obs=3, n_dcc=3, n_ind=40, n_strains=10, n_obs=6,
         time_end=3.),
    dict(seed_obs=7), dict(seed_obs=271, true_params=[5., .4, .3])])
def test_daycare_states_equal_jax(kw):
    got, want = _pair("daycare", kw, "DCC")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(seed_obs=3, n_timestep=40),
    dict(seed_obs=5, n_timestep=60, initial_state=np.linspace(-1, 5, 40)),
    dict(seed_obs=2, true_params=[1.5, .2], n_obs=20, n_timestep=80,
         initial_state=np.cos(np.arange(20)))])
def test_lorenz_trajectories_within_the_chaotic_gap(kw):
    got, want = _pair("lorenz", kw, "Lorenz")
    np.testing.assert_allclose(got, want, rtol=0, atol=LORENZ_ATOL)
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-5, atol=1e-5)


def test_toad_returns_and_refuges_equal_jax():
    """The integer draws of each day: the return decision ``u < p0`` and
    the refuge day, along the JAX simulator's key tree."""
    n_days, n_toads, p0 = 25, 12, np.float32(.4)
    k = jax.random.key(9)
    days_j, days_t = jax.random.split(k, n_days), threefry.split(
        threefry.key(9), n_days)
    for i in range(1, n_days):
        k1, _, k3 = jax.random.split(days_j[i], 3)
        t1, _, t3 = threefry.split(days_t[i], 3)
        np.testing.assert_array_equal(
            (threefry.uniform(t1, (1, n_toads)) < float(p0)).numpy(),
            np.asarray(jax.random.uniform(k1, (1, n_toads)) < p0))
        np.testing.assert_array_equal(
            threefry.randint(t3, (1, n_toads), 0, max(i, 1)).numpy(),
            np.asarray(jax.random.randint(k3, (1, n_toads), 0, max(i, 1))))


def test_kernel_graphs_take_the_generated_data():
    """K1's observed autocovariances and K2's sorted sample at settings no
    file holds (the chip's ``observed`` phase runs them)."""
    from elfi_tpu.models import gnk_pallas, ma2_pallas
    from elfi_tpu_torch.models import gnk_kernel, ma2_kernel
    for port, jax_mod, kw in [(ma2_kernel, ma2_pallas, dict(seed_obs=1)),
                              (gnk_kernel, gnk_pallas, dict(seed_obs=4))]:
        got = port.get_model(**kw).dag.get_state("d")["op"].obs
        want = jax_mod.get_model(**kw).dag.get_state("d")["op"].obs
        _close(got, np.asarray(want), LINEAR)


def test_observed_data_lands_on_the_device_asked_and_returns_numpy():
    from elfi_tpu_torch.models import ma2, ricker
    y = ma2.observed_data(seed_obs=1, device="cpu")
    assert isinstance(y, np.ndarray) and y.shape == (100,)
    np.testing.assert_array_equal(y, ma2.get_model(seed_obs=1).observed["MA2"])
    np.testing.assert_array_equal(ricker.bench_observed(device="cpu"),
                                  ricker.observed_data(seed_obs=4))
