"""The PyTorch port's elastic cluster on the CPU: ports of the nine tests
of ``test_cluster.py``.  Workers attach to the master's socket, batches
farm to them, a late worker joins, a killed worker's batches are replayed,
a hung worker is quarantined, and with nobody attached the master
computes locally -- every run equal to the native run for the same seed.

One worker process (``python -m elfi_tpu_torch.worker``) serves the file
and is killed by its last test; where a worker's death or a timeout is
not the point, workers are threads of this process running
``worker_main``."""

import os
import shutil
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Client as ConnClient

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.models import ma2, ma2_kernel
from elfi_tpu_torch.parallel.cluster import (ClusterBackend, parse_address,
                                             worker_main)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _spawn_worker(address, cwd=None, **extra_env):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra_env.items()})
    return subprocess.Popen(
        [sys.executable, "-m", "elfi_tpu_torch.worker", address],
        cwd=cwd or ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def _thread_worker(address, cache=32):
    t = threading.Thread(target=worker_main, args=(address,),
                         kwargs=dict(program_cache_size=cache), daemon=True)
    t.start()
    return t


def _wait_for_workers(backend, n=1, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        backend._absorb_joined()
        if len(backend._workers) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"{n} worker(s) never attached")


def _echo_model(name):
    """A host simulator through the external-command bridge (its ops
    pickle, so they unpickle in a worker)."""
    m = et.Model(name=name)
    p = et.Prior("uniform", 0, 1, model=m, name="p")
    sim = et.tools.external_operation("echo {0} {seed}")
    et.Simulator(et.tools.vectorize(sim), p, observed=np.array([0.5, 1.0]),
                 model=m, name="sim")
    et.Distance("euclidean", m["sim"], model=m, name="d")
    return m


@pytest.fixture(scope="module")
def cluster():
    """A master with one worker process, started now and attached a few
    seconds later (its import of torch takes that long)."""
    backend = ClusterBackend(device="cpu")
    worker = _spawn_worker(backend.address)
    yield backend, worker
    backend.close()
    try:
        worker.wait(timeout=10)
    except subprocess.TimeoutExpired:
        worker.kill()


def _native(model, **kw):
    et.set_client("native", device="cpu")
    return et.Rejection(model["d"], **kw).sample(10, n_sim=100, bar=False,
                                                 fused=False)


def test_cluster_backend_elastic(cluster):
    backend, _ = cluster
    m = _echo_model("cluster_echo")
    et.set_client(backend)
    # no worker attached yet: the master computes the batches itself
    assert not backend._workers
    res0 = et.Rejection(m["d"], batch_size=20, seed=5).sample(
        10, n_sim=100, bar=False)
    assert res0.n_samples == 10
    # the worker joins late and the tasks farm to it
    _wait_for_workers(backend)
    shipped = backend.programs_shipped
    res1 = et.Rejection(m["d"], batch_size=20, seed=5).sample(
        10, n_sim=100, bar=False)
    assert backend.programs_shipped > shipped
    np.testing.assert_array_equal(res0.samples_array, res1.samples_array)
    res2 = _native(m, batch_size=20, seed=5)
    np.testing.assert_array_equal(res1.samples_array, res2.samples_array)


@pytest.mark.parametrize("mod", [ma2, ma2_kernel], ids=["plain", "kernel"])
def test_cluster_device_graph_ships_program_once(cluster, mod):
    """A device graph farms to the worker with its program sent once per
    (worker, program key); the kernel graph runs its kernel's plain
    version on the worker's CPU."""
    backend, _ = cluster
    _wait_for_workers(backend)
    m = mod.get_model(seed_obs=4)
    et.set_client(backend)
    shipped = backend.programs_shipped
    res = et.Rejection(m["d"], batch_size=100, seed=11).sample(
        20, n_sim=1000, bar=False)        # 10 batches, one worker
    assert backend.programs_shipped - shipped == 1
    et.set_client("native", device="cpu")
    ref = et.Rejection(m["d"], batch_size=100, seed=11).sample(
        20, n_sim=1000, bar=False, fused=False)
    np.testing.assert_array_equal(res.samples_array, ref.samples_array)


def test_cluster_worker_program_cache_eviction_reships():
    """A worker's program cache is bounded and the master's record of what
    it sent is not: a task naming an evicted key is answered "noprog" and
    the program is sent again with the requeued task."""
    ma, mb = ma2.get_model(seed_obs=4), ma2.get_model(seed_obs=0)
    backend = ClusterBackend(local_fallback=False, device="cpu")
    _thread_worker(backend.address, cache=1)
    try:
        _wait_for_workers(backend)
        et.set_client(backend)

        def run(m, seed):
            return et.Rejection(m["d"], batch_size=50, seed=seed).sample(
                10, n_sim=100, bar=False)

        ra1 = run(ma, 11)                  # ships program A
        run(mb, 12)                        # cache of 1: evicts A
        ra2 = run(ma, 11)                  # A named by key -> noprog
        np.testing.assert_array_equal(ra1.samples_array, ra2.samples_array)
        assert backend.programs_shipped == 3
        ref = _native(ma, batch_size=50, seed=11)
        np.testing.assert_array_equal(ra2.samples_array, ref.samples_array)
    finally:
        backend.close()


def test_cluster_authkey_is_random_and_required():
    """Every master makes its own HMAC secret; a connection with the wrong
    key does not become a worker."""
    b1, b2 = ClusterBackend(device="cpu"), ClusterBackend(device="cpu")
    try:
        assert b1._authkey != b2._authkey
        addr, key = parse_address(b1.address)
        assert key == b1._authkey
        with pytest.raises(Exception):
            ConnClient(addr, authkey=b"wrong-key-entirely").close()
        time.sleep(0.2)
        b1._absorb_joined()
        assert not b1._workers
    finally:
        b1.close()
        b2.close()


def test_cluster_is_ready_on_thunk():
    backend = ClusterBackend(device="cpu")
    try:
        tid = backend.apply(lambda x: x + 1, 1)
        assert backend.is_ready(tid)
        assert backend.get_result(tid) == 2
    finally:
        backend.close()


def test_cluster_slow_worker_quarantined_not_killed():
    """A worker past ``task_timeout`` is quarantined (its task replays
    elsewhere) and keeps its connection; when it finally replies it rejoins
    the idle pool."""
    m = _echo_model("cluster_echo_slow")
    backend = ClusterBackend(task_timeout=0.5, device="cpu")
    addr, key = parse_address(backend.address)
    hung = ConnClient(tuple(addr), authkey=key)  # takes a task, never replies
    try:
        _wait_for_workers(backend)
        et.set_client(backend)
        res = et.Rejection(m["d"], batch_size=20, seed=11).sample(
            10, n_sim=40, bar=False)      # must not stall
        assert res.n_samples == 10
        assert len(backend._workers) == 1
        w = backend._workers[0]
        assert w.reclaimed, "the task was never reclaimed from the hung worker"
        assert w.inflight, "a quarantined worker keeps its in-flight id"
        ref = _native(m, batch_size=20, seed=11)
        np.testing.assert_array_equal(res.samples_array, ref.samples_array)
        # the worker finally replies and rejoins the idle pool
        assert hung.poll(5), "no task ever reached the fake worker"
        msg = hung.recv()
        assert msg[0] == "task"
        hung.send(("result", msg[1], {}))
        deadline = time.monotonic() + 10
        while w.inflight and time.monotonic() < deadline:
            backend._pump()
            time.sleep(0.02)
        assert not w.inflight and not w.reclaimed
    finally:
        hung.close()
        backend.close()


def test_cluster_canceled_inflight_task_does_not_stall_master():
    """``remove_task`` on an assigned batch (every SMC round's cancel) marks
    the assignment reclaimed, so the next task falls back to the master
    instead of waiting for the hung worker."""
    prog = compile_program(ma2.get_model(seed_obs=4), ("d",), device="cpu")
    backend = ClusterBackend(task_timeout=0.5, device="cpu")
    addr, key = parse_address(backend.address)
    hung = ConnClient(tuple(addr), authkey=key)
    try:
        _wait_for_workers(backend)
        tid1 = backend.submit(prog, 3, 0, {}, 10)
        assert backend._tasks[tid1].worker is not None
        backend.remove_task(tid1)
        tid2 = backend.submit(prog, 3, 1, {}, 10)
        t0 = time.monotonic()
        res = backend.get_result(tid2)
        assert time.monotonic() - t0 < 10
        assert tuple(res["d"].shape) == (10,)
    finally:
        hung.close()
        backend.close()


def test_cluster_bdm_external_farm(tmp_path):
    """The reference's external-simulator workflow: the C++ BDM binary,
    file handshake and all, farmed over the cluster (two worker threads in
    the binary's directory) and equal to the local fallback."""
    from elfi_tpu_torch.models import bdm
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    cwd = os.getcwd()
    backend = ClusterBackend(device="cpu")
    try:
        os.chdir(tmp_path)
        if bdm.ensure_executable(str(tmp_path)) is None:
            pytest.skip("could not compile bdm")
        m = bdm.get_model()
        et.set_client(backend)
        res_local = et.Rejection(m["d"], batch_size=50, seed=7).sample(
            20, n_sim=200, bar=False)
        for _ in range(2):
            _thread_worker(backend.address)
        _wait_for_workers(backend, 2)
        res_farm = et.Rejection(m["d"], batch_size=50, seed=7).sample(
            20, n_sim=200, bar=False)
        assert backend.programs_shipped == 2
        np.testing.assert_array_equal(res_local.samples_array,
                                      res_farm.samples_array)
        assert np.all(res_farm.samples["alpha"] >= 0.005)
    finally:
        backend.close()
        os.chdir(cwd)


def test_cluster_worker_death_reassigns(cluster):
    """Killing the worker mid-run loses no batch: the master replays the
    batch index (here, locally) with the native batch's values."""
    backend, worker = cluster
    _wait_for_workers(backend)
    m = _echo_model("cluster_echo_kill")
    et.set_client(backend)
    rej = et.Rejection(m["d"], batch_size=20, seed=7)
    rej.set_objective(10, n_sim=100)
    rej.batches.submit(rej.prepare_new_batch(0))
    worker.kill()
    worker.wait()
    rej.batches.submit(rej.prepare_new_batch(1))
    b0, _ = rej.batches.wait_next()
    b1, _ = rej.batches.wait_next()
    assert set(b0) >= {"d", "p"}
    et.set_client("native", device="cpu")
    rej2 = et.Rejection(m["d"], batch_size=20, seed=7)
    rej2.set_objective(10, n_sim=100)
    for i in range(2):
        rej2.batches.submit(rej2.prepare_new_batch(i))
    n0, _ = rej2.batches.wait_next()
    n1, _ = rej2.batches.wait_next()
    torch.testing.assert_close(b0["d"], n0["d"], rtol=0, atol=0)
    torch.testing.assert_close(b1["d"], n1["d"], rtol=0, atol=0)
