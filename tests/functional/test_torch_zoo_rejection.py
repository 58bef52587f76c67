"""Rejection ABC on every zoo model of the PyTorch port, at the sizes of
``tests/functional/test_examples.py`` (the JAX package's mirror test)."""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def smoke_rejection(m, discrepancy="d", batch_size=16, n=4):
    rej = et.Rejection(m[discrepancy], batch_size=batch_size, seed=2)
    res = rej.sample(n, quantile=0.5, bar=False)
    assert res.n_samples == n
    assert np.all(np.isfinite(res.samples_array))
    # every sample inside its uniform prior's support
    prior = et.ModelPrior(m)
    assert np.all(np.isfinite(prior.logpdf(res.samples_array)))
    return res


def test_ar1():
    from elfi_tpu_torch.models import ar1
    smoke_rejection(ar1.get_model(seed_obs=3))


def test_arch():
    from elfi_tpu_torch.models import arch
    smoke_rejection(arch.get_model(seed_obs=3))


def test_mg1():
    from elfi_tpu_torch.models import mg1
    smoke_rejection(mg1.get_model(seed_obs=3))


def test_lorenz():
    from elfi_tpu_torch.models import lorenz
    smoke_rejection(lorenz.get_model(seed_obs=3, n_timestep=40),
                    batch_size=8)


def test_lotka_volterra():
    from elfi_tpu_torch.models import lotka_volterra
    m = lotka_volterra.get_model(n_obs=8, seed_obs=3, time_end=5.)
    smoke_rejection(m, batch_size=8)


def test_toad():
    from elfi_tpu_torch.models import toad
    m = toad.get_model(seed_obs=3, n_toads=10, n_days=20)
    smoke_rejection(m, batch_size=8)


def test_stochastic_volatility():
    from elfi_tpu_torch.models import stochastic_volatility
    smoke_rejection(stochastic_volatility.get_model(seed_obs=3))


def test_daycare():
    from elfi_tpu_torch.models import daycare
    m = daycare.get_model(seed_obs=3, n_dcc=2, n_ind=8, n_strains=4,
                          n_obs=6, time_end=0.5)
    res = smoke_rejection(m, batch_size=4)
    assert np.all(np.isfinite(res.outputs["d"]))
    out = m.generate(4, outputs=["d", "logd"], seed=1)
    np.testing.assert_allclose(out["logd"], np.log(out["d"]), rtol=1e-6)


def test_scratch_assay():
    from elfi_tpu_torch.models import scratch_assay
    m = scratch_assay.get_model(seed_obs=3, init_params=[8, 8, 10, 3],
                                obs_period=2, obs_interval=1, tau=1 / 2)
    smoke_rejection(m, batch_size=4)


def test_bdm(tmp_path):
    from elfi_tpu_torch.models import bdm
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        exe = bdm.ensure_executable(str(tmp_path))
        if exe is None:
            pytest.skip("could not compile bdm")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = bdm.get_model()
        smoke_rejection(m, batch_size=16)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", ["ar1", "mg1", "toad"])
def test_zoo_rejection_is_deterministic_per_seed(name):
    import importlib
    kw = dict(seed_obs=3, n_toads=10, n_days=20) if name == "toad" \
        else dict(seed_obs=3)
    m = importlib.import_module(f"elfi_tpu_torch.models.{name}").get_model(
        **kw)
    runs = [et.Rejection(m["d"], batch_size=64, seed=s).sample(
        8, n_sim=256, bar=False).samples_array for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
