"""The PyTorch port's backend layer on the CPU: program pickling and
``cache_key``, the ``apply`` thunks, ``reset`` through ``remove_task``,
``set_client``'s names, and the task protocol held against the JAX
package's on the same call sequence (native and worker-less cluster
backends), with ``parse_address`` on the same strings."""

import pickle

import numpy as np
import pytest
import torch

import elfi_tpu as elfi
import elfi_tpu_torch as et
from elfi_tpu.compile.compiler import compile_program as jax_compile
from elfi_tpu.models import ma2 as jax_ma2
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


@pytest.mark.parametrize("mod", [ma2, ma2_kernel], ids=["plain", "kernel"])
def test_program_pickles_without_its_device_caches(mod):
    m = mod.get_model(seed_obs=4)
    prog = compile_program(m, ("d", "t1"), device="cpu")
    want = prog.run(7, 3, {}, 32)
    assert prog._traceables
    copy = pickle.loads(pickle.dumps(prog))
    assert copy._observed == {} and copy._traceables == {}
    assert "_program_cache" not in copy.model.__dict__
    assert copy.cache_key == prog.cache_key
    got = copy.on("cpu").run(7, 3, {}, 32)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_cache_key_is_the_jax_programs():
    """(revision, outputs, override names, adaptive versions), as the JAX
    package's; the device is not in it."""
    mj, mt = jax_ma2.get_model(seed_obs=4), ma2.get_model(seed_obs=4)
    et.AdaptiveDistance(mt["S1"], mt["S2"], model=mt, name="ad")
    elfi.AdaptiveDistance(mj["S1"], mj["S2"], model=mj, name="ad")
    for names in ((), ("t1", "t2")):
        kj = jax_compile(mj, ("ad", "t1"), override_names=names).cache_key
        kt = compile_program(mt, ("ad", "t1"), override_names=names,
                             device="cpu").cache_key
        assert kt[0] == mt.revision and kj[0] == mj.revision
        assert kt[1:] == kj[1:]
    a = compile_program(mt, ("d",), device="cpu")
    assert compile_program(mt, ("d",), device="meta").cache_key == \
        a.cache_key
    mt.update_node("d", dummy=1)
    assert compile_program(mt, ("d",), device="cpu").cache_key != \
        a.cache_key


def test_program_with_a_lambda_does_not_pickle():
    m = ma2.get_model(seed_obs=4)
    et.Operation(lambda d: d * 2, m["d"], model=m, name="twice")
    prog = compile_program(m, ("twice",), device="cpu")
    with pytest.raises(Exception):
        pickle.dumps(prog)


def test_thunks_resolve_at_get_result():
    b = et.NativeBackend(device="cpu")
    calls = []
    tid = b.apply(lambda x, y=0: calls.append(x) or x + y, 2, y=3)
    assert calls == [] and b.is_ready(tid)
    assert b.get_result(tid) == 5 and calls == [2]
    assert b.apply_sync(divmod, 9, 4) == (2, 1)
    bad = b.apply(divmod, 1, 0)
    assert b.is_ready(bad)
    with pytest.raises(ZeroDivisionError):
        b.get_result(bad)


def test_reset_goes_through_remove_task():
    removed = []

    class Recording(et.NativeBackend):
        def remove_task(self, task_id):
            removed.append(task_id)
            super().remove_task(task_id)

    b = Recording(device="cpu")
    prog = compile_program(ma2.get_model(seed_obs=4), ("d",), device="cpu")
    tids = [b.submit(prog, 1, i, {}, 8) for i in range(2)]
    tids.append(b.apply(divmod, 1, 1))
    b.reset()
    assert removed == tids and not b._tasks


def test_set_client_names(monkeypatch):
    from elfi_tpu_torch.parallel import dask_client
    from elfi_tpu_torch.parallel.cluster import ClusterBackend
    from elfi_tpu_torch.parallel.multihost import MultihostBackend
    assert isinstance(et.set_client("native", device="cpu"),
                      et.NativeBackend)
    sharded = et.set_client("sharded", devices=["cpu", "cpu"])
    assert isinstance(sharded, et.ShardedBackend)
    assert sharded.mesh == [torch.device("cpu")] * 2
    assert sharded.n_devices == 2 and sharded.num_cores == 4
    assert sharded.device == torch.device("cpu")
    pool = et.set_client("multiprocessing", num_processes=1, device="cpu")
    try:
        assert isinstance(pool, et.MultiprocessingBackend)
        assert pool.num_cores == 1
    finally:
        pool.close()
    cluster = et.set_client("cluster", device="cpu")
    try:
        assert isinstance(cluster, ClusterBackend)
        assert cluster.device == torch.device("cpu")
    finally:
        cluster.close()
    mh = et.set_client("multihost", device="cpu")
    assert isinstance(mh, MultihostBackend) and mh.num_processes == 1

    class FakeDask:
        def ncores(self):
            return {"a": 3}

    adapter = et.set_client("elfi_tpu_torch.parallel.dask_client",
                            dask_client=FakeDask(), device="cpu")
    assert isinstance(adapter, dask_client.Client)
    assert adapter.num_cores == 3
    with pytest.raises(ModuleNotFoundError):
        et.set_client("elfi_tpu_torch.parallel.no_such_backend")
    # no card: the device list of every CUDA device cannot be made
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.set_client("sharded")
    with pytest.raises(ValueError):
        et.ShardedBackend(devices=[])


def test_sharded_deals_whole_batches():
    """Batch i runs whole on device i % n and equals the native batch."""
    m = ma2_kernel.get_model(seed_obs=4)
    prog = compile_program(m, ("d", "t1", "t2"), device="cpu")
    native = et.NativeBackend(device="cpu")
    sharded = et.ShardedBackend(devices=["cpu", "cpu", "cpu"])
    assert [sharded.device_of(i) for i in range(4)] == \
        [torch.device("cpu")] * 4
    for i in range(4):
        want = native.get_result(native.submit(prog, 5, i, {}, 64))
        tid = sharded.submit(prog, 5, i, {}, 64)
        assert sharded.is_ready(tid)
        got = sharded.get_result(tid)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def _protocol(backend, prog):
    """One call sequence of the task protocol; returns what each call gave
    (values where they are plain, types where they are not)."""
    seen = []

    def record(label, fn):
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001  the outcome is recorded
            seen.append((label, "raises", type(e).__name__))
            return
        if isinstance(value, dict):
            value = {k: tuple(np.asarray(v).shape) for k, v in value.items()}
        seen.append((label, value))

    t0 = backend.submit(prog, 3, 0, {}, 10)
    record("result", lambda: backend.get_result(t0))
    t1 = backend.apply(divmod, 7, 3)
    record("thunk ready", lambda: backend.is_ready(t1))
    record("thunk result", lambda: backend.get_result(t1))
    record("apply_sync", lambda: backend.apply_sync(divmod, 9, 4))
    t2 = backend.submit(None, 0, 0, {}, 16)
    record("deferred error", lambda: backend.get_result(t2))
    t3 = backend.submit(prog, 3, 1, {}, 10)
    backend.remove_task(t3)
    record("removed", lambda: backend.get_result(t3))
    backend.remove_task(t3)
    t4 = backend.apply(divmod, 1, 1)
    backend.submit(prog, 3, 2, {}, 10)
    record("ids", lambda: t4 - t0)
    backend.reset()
    record("after reset", lambda: len(backend._tasks))
    return seen


@pytest.mark.parametrize("kind", ["native", "cluster"])
def test_task_protocol_matches_jax(kind):
    from elfi_tpu.parallel.cluster import ClusterBackend as JaxCluster
    from elfi_tpu_torch.parallel.cluster import ClusterBackend
    mj, mt = jax_ma2.get_model(seed_obs=4), ma2.get_model(seed_obs=4)
    pj = jax_compile(mj, ("d",))
    pt = compile_program(mt, ("d",), device="cpu")
    if kind == "native":
        bj, bt = elfi.NativeBackend(), et.NativeBackend(device="cpu")
    else:
        bj, bt = JaxCluster(), ClusterBackend(device="cpu")
    try:
        want = _protocol(bj, pj)
        got = _protocol(bt, pt)
    finally:
        for b in (bj, bt):
            if hasattr(b, "close"):
                b.close()
    assert got == want
    assert ("result", {"d": (10,)}) in got


@pytest.mark.parametrize("spec", [
    "127.0.0.1:5000/00ff10", "host.example:65535/" + "ab" * 16,
    "[::1]:7/0a", "localhost:1234"])
def test_parse_address_matches_jax(spec):
    from elfi_tpu.parallel.cluster import parse_address as jax_parse
    from elfi_tpu_torch.parallel.cluster import parse_address
    assert parse_address(spec) == jax_parse(spec)


def test_cluster_address_carries_a_random_key():
    from elfi_tpu_torch.parallel.cluster import ClusterBackend, parse_address
    b1, b2 = ClusterBackend(device="cpu"), ClusterBackend(device="cpu")
    try:
        assert b1._authkey != b2._authkey
        addr, key = parse_address(b1.address)
        assert key == b1._authkey and addr == b1._listener.address
    finally:
        b1.close()
        b2.close()


def test_worker_command_line_usage(capsys):
    from elfi_tpu_torch.worker import main
    assert main([]) == 2
    assert main(["no-port-here"]) == 2
    assert main(["a:1", "b:2"]) == 2
    assert "HOST:PORT/AUTHKEY" in capsys.readouterr().err
