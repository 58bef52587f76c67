"""Batch submission of the PyTorch port: in-order consumption, deterministic
replay of a failed batch, and cancellation."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.model.model import ComputationContext
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.ops import distributions as dists
from elfi_tpu_torch.parallel import BatchHandler, NativeBackend

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a CUDA device, and no backend set: the state in
    which an entry point called with no device must raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    et.reset_client()


def _entry_points():
    from elfi_tpu_torch.methods.density_ratio_estimation import \
        DensityRatioEstimation
    # the model draws its observed data on the global backend's device:
    # the CPU here, then the backend is reset for the call that must raise
    et.set_client("native", device="cpu")
    m = ma2.get_model(seed_obs=4)
    et.reset_client()
    yield "Rejection", lambda: et.Rejection(m["d"], batch_size=8).sample(
        10, n_sim=16, bar=False)
    yield "SMC", lambda: et.SMC(m["d"], batch_size=8).sample(
        10, thresholds=[1.0], bar=False)
    yield "Model.generate", lambda: m.generate(8)
    yield "node.generate", lambda: m["d"].generate(8)
    yield "ModelPrior", lambda: et.ModelPrior(m).rvs(4, seed=0)
    yield "DensityRatioEstimation", lambda: DensityRatioEstimation(n=2)
    yield "BSL", lambda: et.BSL(m, n_sim_round=8).sample(
        3, sigma_proposals=np.eye(2) * 0.1, bar=False)
    yield "estimate_whitening_matrix", lambda: \
        et.methods.bsl.estimate_whitening_matrix(m, 8, [0.6, 0.2],
                                                 ["S1", "S2"])
    bounds = {"t1": (-2, 2), "t2": (-1, 1)}
    yield "BOLFI", lambda: et.BOLFI(m["d"], initial_evidence=4,
                                    bounds=bounds).fit(6, bar=False)
    yield "BOLFIRE", lambda: et.BOLFIRE(m, n_training_data=8, bounds=bounds,
                                      n_initial_evidence=2).fit(3, bar=False)
    yield "ROMC", lambda: et.ROMC(m["d"], bounds=bounds).solve_problems(
        2, seed=1)
    labels = np.array([1.0, 1.0, -1.0, -1.0])
    yield "LogisticRegression", lambda: et.methods.LogisticRegression().fit(
        np.eye(4, 2), labels)
    yield "GPClassifier", lambda: et.methods.GPClassifier().fit(
        np.eye(4, 2), labels)
    yield "BayesianOptimization", lambda: et.BayesianOptimization(
        m["d"], initial_evidence=4, bounds=bounds).infer(6, bar=False)
    yield "GPRegression", lambda: et.GPRegression(["t1"]).update(
        np.zeros((3, 1)), np.ones(3))
    yield "mcmc.nuts_chains", lambda: et.mcmc.nuts_chains(
        10, np.zeros((2, 1)), lambda x: -0.5 * (x ** 2).sum(-1))
    # a draw with no generator lands on the global backend's device
    yield "norm.rvs", lambda: dists.norm.rvs(size=4)
    yield "uniform.rvs", lambda: dists.uniform.rvs(size=4)
    yield "truncnorm.rvs", lambda: dists.truncnorm.rvs(-1.0, 1.0, size=4)
    yield "multivariate_normal.rvs", lambda: dists.multivariate_normal.rvs(
        [0.0, 0.0], 1.0, size=4)
    yield "CustomPrior1.rvs", lambda: ma2.CustomPrior1.rvs(2.0, size=4)


@pytest.mark.parametrize("entry", [n for n, _ in _entry_points()])
def test_entry_point_without_a_device_raises_without_cuda(no_cuda, entry):
    """No CPU fallback: with no card and no CPU asked for, the call raises
    and nothing runs."""
    call = dict(_entry_points())[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def _lower_layers():
    from elfi_tpu_torch.compile.compiler import compile_program
    # the model draws its observed data on the global backend's device:
    # the CPU here, then the backend is reset for the calls under test
    et.set_client("native", device="cpu")
    m = ma2.get_model(seed_obs=4)
    et.reset_client()
    ctx = ComputationContext(batch_size=8, seed=1)
    yield "compile_program", lambda **kw: compile_program(m, ("d",), **kw)
    yield "BatchHandler", lambda **kw: BatchHandler(m, ctx, ("d",), **kw)


@pytest.mark.parametrize("layer", [n for n, _ in _lower_layers()])
def test_lower_layers_take_the_device_they_are_given(no_cuda, layer):
    """The entry points resolve the default device once; the program and
    the batch handler below them are always given one and keep it."""
    make = dict(_lower_layers())[layer]
    with pytest.raises(TypeError, match="device"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_cpu_asked_for_runs_without_cuda(no_cuda):
    # the model draws its observed data on the global backend's device:
    # the CPU here, then the backend is reset, so that generate has only
    # its own device= to go by
    et.set_client("native", device="cpu")
    m = ma2.get_model(seed_obs=4)
    et.reset_client()
    assert m.generate(8, outputs="d", device="cpu")["d"].shape == (8,)
    et.set_client("native", device="cpu")
    res = et.Rejection(m["d"], batch_size=8, seed=1).sample(4, n_sim=16,
                                                           bar=False)
    assert res.samples["t1"].shape == (4,)


def _handler(m, outputs=("t1", "d"), client=None, batch_size=16, seed=3):
    ctx = ComputationContext(batch_size=batch_size, seed=seed)
    return BatchHandler(m, ctx, outputs, client=client or NativeBackend(),
                        device="cpu")


def test_batches_are_consumed_in_submission_order():
    m = ma2.get_model(seed_obs=4)
    bh = _handler(m)
    for _ in range(3):
        bh.submit()
    assert bh.num_pending == 3 and bh.total == 3 and bh.has_ready()
    got = [bh.wait_next() for _ in range(3)]
    assert [i for _, i in got] == [0, 1, 2]
    ref = _handler(m)
    for batch, i in got:
        ref.next_index = i
        ref.submit()
        again, j = ref.wait_next()
        assert j == i
        for k in batch:
            assert torch.equal(batch[k], again[k]), k


def test_failed_batch_is_replayed_with_the_same_streams():
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")
    fails = {"left": 2}

    def flaky(p, batch_size, generator):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("transient")
        return p[:, None] + torch.rand((batch_size, 2), generator=generator)

    et.Simulator(flaky, m["p"], observed=np.zeros(2), model=m, name="sim")
    bh = _handler(m, outputs=("sim",))
    bh.submit()
    batch, idx = bh.wait_next()
    assert idx == 0 and fails["left"] == 0
    clean = _handler(m, outputs=("sim",))
    clean.submit()
    assert torch.equal(batch["sim"], clean.wait_next()[0]["sim"])


def test_failure_surfaces_after_the_retries():
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")

    def broken(p, batch_size, generator):
        raise RuntimeError("always")

    et.Simulator(broken, m["p"], observed=np.zeros(1), model=m, name="sim")
    bh = _handler(m, outputs=("sim",))
    bh.submit()
    with pytest.raises(RuntimeError, match="Batch 0 failed after 2 retries"):
        bh.wait_next()


def test_cancel_pending_rewinds():
    m = ma2.get_model(seed_obs=4)
    bh = _handler(m)
    for _ in range(3):
        bh.submit()
    bh.wait_next()
    bh.cancel_pending()
    assert bh.num_pending == 0 and bh.next_index == 1
    with pytest.raises(ValueError, match="no batches are pending"):
        bh.wait_next()
    bh.submit({"t1": np.zeros(16, np.float32)})
    batch, idx = bh.wait_next()
    assert idx == 1 and torch.equal(batch["t1"], torch.zeros(16))
    bh.reset()
    assert bh.next_index == 0
