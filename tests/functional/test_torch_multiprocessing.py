"""The PyTorch port's process pool on the CPU: the two tests of
``test_multiprocessing.py`` (a pool run equals the native run for the same
seed), a task past ``task_timeout``, and an unpicklable op whose error
surfaces at ``get_result``."""

import time

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.models import ma2, ma2_kernel

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture(scope="module")
def mp_client():
    c = et.MultiprocessingBackend(num_processes=2, device="cpu")
    yield c
    c.close()


@pytest.mark.parametrize("mod", [ma2, ma2_kernel], ids=["plain", "kernel"])
def test_rejection_through_process_pool(mod, mp_client):
    m = mod.get_model(seed_obs=4)
    ref = et.Rejection(m["d"], batch_size=20, seed=11).sample(
        5, n_sim=60, fused=False, bar=False)
    et.set_client(mp_client)
    res = et.Rejection(m["d"], batch_size=20, seed=11).sample(
        5, n_sim=60, fused=False, bar=False)
    assert res.n_samples == 5
    for k in ref.outputs:
        np.testing.assert_allclose(res.outputs[k], ref.outputs[k],
                                   rtol=1e-6)


def _ran_without_sympy(program):
    """In a worker: one batch of ``program``, then whether sympy is
    loaded.  Torch imports it lazily for some shape helpers, at a second
    or more in each new process."""
    import sys
    program.on("cpu").run(1, 0, {}, 64)
    return "sympy" not in sys.modules


@pytest.mark.parametrize("mod", [ma2, ma2_kernel], ids=["plain", "kernel"])
def test_worker_batch_loads_no_sympy(mod, mp_client):
    prog = compile_program(mod.get_model(seed_obs=4), ("d",), device="cpu")
    assert mp_client.get_result(mp_client.apply(_ran_without_sympy, prog))


def _host_sim(mu, batch_size, random_state):
    # module-level: ops must pickle for the process pool
    return np.asarray(mu)[:, None] + random_state.randn(batch_size, 4)


def _host_mean(x):
    return np.mean(np.asarray(x), axis=1)


@pytest.mark.parametrize("prior", [("uniform", -1, 2),
                                   ("gumbel_r", 0.5, 0.3)])
def test_host_simulator_through_process_pool(prior, mp_client):
    """External-style (host) simulators farm to the workers, with a device
    prior or a scipy one, and give the native run's samples."""
    m = et.Model(name="mp_host")
    et.Prior(*prior, model=m, name="mu")
    et.Simulator(_host_sim, m["mu"], host=True,
                 observed=np.array([.4, .6, .5, .4]), model=m, name="sim")
    et.Summary(_host_mean, m["sim"], model=m, name="S", host=True)
    et.Distance("euclidean", m["S"], model=m, name="d")
    ref = et.Rejection(m["d"], batch_size=25, seed=3).sample(
        5, n_sim=50, bar=False)
    et.set_client(mp_client)
    res = et.Rejection(m["d"], batch_size=25, seed=3).sample(
        5, n_sim=50, bar=False)
    assert res.n_samples == 5
    assert np.all(np.isfinite(res.samples_array))
    np.testing.assert_allclose(res.samples_array, ref.samples_array,
                               rtol=1e-6)


def test_task_past_its_timeout_raises(mp_client):
    mp_client.task_timeout = 0.3
    try:
        tid = mp_client.apply(time.sleep, 1.5)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="exceeded"):
            mp_client.get_result(tid)
        assert time.monotonic() - t0 < 1.4
    finally:
        mp_client.task_timeout = 600
    # the pool still serves once the sleeping worker is free
    assert mp_client.get_result(mp_client.apply(divmod, 7, 2)) == (3, 1)


def test_unpicklable_op_raises_at_get_result(mp_client):
    m = ma2.get_model(seed_obs=4)
    et.Operation(lambda d: d * 2, m["d"], model=m, name="twice")
    prog = compile_program(m, ("twice",), device="cpu")
    tid = mp_client.submit(prog, 1, 0, {}, 8)     # does not raise here
    with pytest.raises(Exception, match="(?i)pickl"):
        mp_client.get_result(tid)


def test_reset_cancels_queued_tasks(mp_client):
    busy = [mp_client._pool.submit(time.sleep, 1.0) for _ in range(2)]
    prog = compile_program(ma2.get_model(seed_obs=4), ("d",), device="cpu")
    tids = [mp_client.submit(prog, 1, i, {}, 8) for i in range(8)]
    futures = [mp_client._tasks[t].future for t in tids]
    mp_client.reset()
    assert not mp_client._tasks
    # the two workers and the call queue hold at most three; the rest are
    # cancelled before they start
    assert sum(f.cancelled() for f in futures) >= 5
    for f in busy:
        f.result()
