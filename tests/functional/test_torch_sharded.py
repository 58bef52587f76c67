"""The PyTorch port's device list (``ShardedBackend``) on
``devices=["cpu", "cpu"]``: the ports of
``test_sharded_fused_equals_native_fused``,
``test_smc_fused_sharded_equals_native``,
``test_nuts_chains_sharded_equals_single`` and the cases of
``test_multichip_scaling.py`` that a device list has.

Rejection and SMC deal whole batches to the devices, so their samples
equal the native run's bit for bit.  BSL's chain, NUTS's chains and
ROMC's problems run on the list's first device, so they equal the
one-device run bit for bit too."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods.mcmc import nuts_chains
from elfi_tpu_torch.models import ma2, ma2_kernel

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]
MODELS = {"plain": ma2, "kernel": ma2_kernel}


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _both(run, devices=CPU2):
    """``run()`` on the native CPU backend, then on the device list."""
    et.set_client("native", device="cpu")
    native = run()
    et.set_client("sharded", devices=devices)
    return native, run()


def _equal(a, b):
    assert sorted(a.outputs) == sorted(b.outputs)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)


@pytest.mark.parametrize("graph", sorted(MODELS))
def test_sharded_fused_equals_native_fused(graph):
    m = MODELS[graph].get_model(seed_obs=4)
    _equal(*_both(lambda: et.Rejection(m["d"], batch_size=64, seed=21)
                  .sample(16, n_sim=640, fused=True, bar=False)))


@pytest.mark.parametrize("devices", [CPU2, ["cpu"] * 3])
def test_sharded_fused_threshold_equals_native(devices):
    """Threshold mode reads the acceptance count per chunk of batches: the
    same batches run, so the same rows come out."""
    m = ma2.get_model(seed_obs=4)
    _equal(*_both(lambda: et.Rejection(m["d"], batch_size=64, seed=3)
                  .sample(20, threshold=0.25, fused=True, bar=False),
                  devices))


def test_sharded_batch_at_a_time_equals_native():
    m = ma2_kernel.get_model(seed_obs=4)
    native, sharded = _both(lambda: et.Rejection(
        m["d"], batch_size=50, seed=9).sample(10, n_sim=500, fused=False,
                                              bar=False))
    _equal(native, sharded)


def test_fused_sharded_rejection_parity_at_scale():
    """At a larger batch, few samples, and a number of batches the list
    does not divide."""
    m = ma2_kernel.get_model(seed_obs=4)
    _equal(*_both(lambda: et.Rejection(m["d"], batch_size=2**14, seed=21)
                  .sample(500, n_sim=2**14 * 5, bar=False),
                  ["cpu"] * 3))


@pytest.mark.parametrize("graph", sorted(MODELS))
def test_smc_fused_sharded_equals_native(graph):
    m = MODELS[graph].get_model(seed_obs=4)
    native, sharded = _both(lambda: et.SMC(m["d"], batch_size=800, seed=13)
                            .sample(100, quantiles=[0.2], bar=False,
                                    fused=True))
    np.testing.assert_array_equal(native.samples_array,
                                  sharded.samples_array)


def test_smc_threshold_rounds_sharded_equal_native():
    m = ma2.get_model(seed_obs=4)
    native, sharded = _both(lambda: et.SMC(m["d"], batch_size=500, seed=2)
                            .sample(100, thresholds=[0.8, 0.4], bar=False,
                                    fused=True))
    np.testing.assert_array_equal(native.samples_array,
                                  sharded.samples_array)


def _target(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def test_nuts_chains_sharded_equals_single():
    """The chains over a device list of one or two entries are the
    one-device chains, which pass the JAX test's statistical gate."""
    x0s = np.linspace(-1, 1, 8)[:, None] * np.ones((8, 2))
    a = nuts_chains(200, x0s, _target, seed=3, device="cpu")
    for mesh in ([torch.device("cpu")], CPU2):
        np.testing.assert_array_equal(
            a, nuts_chains(200, x0s, _target, seed=3, device="cpu",
                           mesh=mesh))
    flat = a[:, 100:, :].reshape(-1, 2)
    assert np.all(np.abs(flat.mean(0)) < 0.15)
    assert np.all(np.abs(flat.std(0) - 1) < 0.2)


def _bsl(m, seed=4):
    return et.BSL(m, n_sim_round=300, feature_names=["S1", "S2"],
                  seed=seed).sample(
        120, sigma_proposals=np.diag([.05, .05]),
        params0=np.array([[.6, .2]]), burn_in=20, fused=True, bar=False)


@pytest.mark.parametrize("devices", [["cpu"], CPU2, ["cpu"] * 7])
def test_bsl_round_over_the_device_list(devices):
    """The fused chain over a device list is the one-device chain, also
    where the list does not divide the round."""
    m = ma2.get_model(seed_obs=4)
    native, listed = _both(lambda: _bsl(m), devices)
    np.testing.assert_array_equal(native.samples_array,
                                  listed.samples_array)
    assert listed.n_sim == native.n_sim == 120 * 300


def _romc(m, n2=20, fit_models=False):
    romc = et.ROMC(m["d"], bounds=[(-2, 2), (-1, 1)], seed=1)
    romc.solve_problems(n1=20, seed=2)
    romc.estimate_regions(eps_filter=0.05, fit_models=fit_models)
    return romc, romc.sample(n2=n2, seed=3)


def test_romc_over_the_device_list():
    """The MA2 point of ``test_torch_romc_sampling.py::test_romc_2d``: over
    two devices the problems solve as on one, to the same samples."""
    m = ma2.get_model(seed_obs=4)
    (rn, native), (rs, listed) = _both(lambda: _romc(m))
    for romc in (rn, rs):
        assert romc.compute_eps(quantile=0.9) < 0.1
        assert sum(romc.inference_state["solved"]) >= 18
    assert np.sum(native.weights) > 0
    np.testing.assert_array_equal(native.samples_array,
                                  listed.samples_array)
    np.testing.assert_array_equal(native.weights, listed.weights)


def test_romc_local_fits_split_the_posterior_draws():
    """With local fits, the posterior's draws and weights over the list are
    the one-device ones."""
    m = ma2.get_model(seed_obs=4)
    (_, native), (rs, listed) = _both(lambda: _romc(m, 40, True))
    assert rs.posterior._local_coeffs is not None
    np.testing.assert_array_equal(native.samples_array,
                                  listed.samples_array)
    np.testing.assert_array_equal(native.weights, listed.weights)
