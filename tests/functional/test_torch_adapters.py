"""The PyTorch port's dask and ipyparallel adapters against in-memory fakes
of each library's future and view (the ports of
``test_adapter_conformance.py``): submit, get_result, the ``apply`` thunks,
is_ready, remove_task and deferred launch errors, with every task run in
this process -- which also holds the pid guard: a task inside the master's
process leaves its global backend alone.  The tests of the real packages
skip where they are not installed."""

import os

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import ma2, ma2_kernel

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


class _FakeDaskFuture:
    def __init__(self, fn, args, kwargs):
        try:
            self._value, self._err = fn(*args, **kwargs), None
        except Exception as e:  # noqa: BLE001  raised at .result(), as dask
            self._value, self._err = None, e
        self.cancelled = False

    def result(self):
        if self._err is not None:
            raise self._err
        return self._value

    def done(self):
        return True

    def cancel(self):
        self.cancelled = True


class _FakeDaskClient:
    def __init__(self):
        self.futures = []

    def submit(self, fn, *args, pure=False, **kwargs):
        fut = _FakeDaskFuture(fn, args, kwargs)
        self.futures.append(fut)
        return fut

    def ncores(self):
        return {"worker-0": 2, "worker-1": 1}

    def close(self):
        self.closed = True


class _FakeAsyncResult(_FakeDaskFuture):
    def get(self):
        return self.result()

    def ready(self):
        return True


class _FakeView:
    def apply(self, fn, *args, **kwargs):
        return _FakeAsyncResult(fn, args, kwargs)

    def apply_sync(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)

    def abort(self, *a, **k):
        pass

    def __len__(self):
        return 3


class _FakeIppClient:
    def load_balanced_view(self):
        return _FakeView()

    def abort(self, *a, **k):
        pass

    def close(self):
        self.closed = True


def _adapter_clients():
    from elfi_tpu_torch.parallel.dask_client import Client as DaskAdapter
    from elfi_tpu_torch.parallel.ipyparallel_client import \
        Client as IppAdapter
    return [("dask", DaskAdapter(dask_client=_FakeDaskClient(),
                                 device="cpu")),
            ("ipyparallel", IppAdapter(ipp_client=_FakeIppClient(),
                                       device="cpu"))]


@pytest.mark.parametrize("mod", [ma2, ma2_kernel], ids=["plain", "kernel"])
def test_adapter_rejection_matches_native(mod):
    m = mod.get_model(seed_obs=4)
    ref = et.Rejection(m["d"], batch_size=100, seed=13).sample(
        20, n_sim=1000, fused=False, bar=False)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    for name, client in _adapter_clients():
        et.set_client(client)
        assert client.num_cores == 3
        res = et.Rejection(m["d"], batch_size=100, seed=13).sample(
            20, n_sim=1000, fused=False, bar=False)
        for k in ref.outputs:
            np.testing.assert_array_equal(res.outputs[k], ref.outputs[k],
                                          err_msg=name)
        # the tasks ran in this process: the master stays as it was
        assert et.get_client() is client
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == visible


def test_adapter_thunks_and_task_protocol():
    for name, client in _adapter_clients():
        # apply() records a thunk: "ready" at once, farmed at get_result
        tid = client.apply(divmod, 7, 3)
        assert client.is_ready(tid)
        assert client.get_result(tid) == (2, 1)
        assert client.apply_sync(divmod, 9, 4) == (2, 1)
        # remove_task cancels a live handle and is a no-op on thunks
        tid2 = client.apply(divmod, 1, 1)
        client.remove_task(tid2)
        client.remove_task(tid2)
        # a submit that fails at launch defers the error to get_result
        tid3 = client.submit(None, 0, 0, {}, 16)
        assert client.is_ready(tid3)
        with pytest.raises(Exception):
            client.get_result(tid3)
        client.reset()
        assert not client._tasks, name


def test_adapter_results_land_on_the_programs_device():
    from elfi_tpu_torch.compile.compiler import compile_program
    prog = compile_program(ma2.get_model(seed_obs=4), ("d", "t1"),
                           device="cpu")
    for name, client in _adapter_clients():
        out = client.get_result(client.submit(prog, 2, 0, {}, 16))
        assert all(isinstance(v, torch.Tensor) and v.device == prog.device
                   for v in out.values()), name
        ov = {"t1": torch.full((16,), 0.3)}
        prog_ov = compile_program(prog.model, ("d", "t1"),
                                  override_names=("t1",), device="cpu")
        out = client.get_result(client.submit(prog_ov, 2, 0, ov, 16))
        torch.testing.assert_close(out["t1"], ov["t1"])


def test_dask_backend_matches_native():
    pytest.importorskip("dask.distributed")
    m = ma2.get_model(seed_obs=4)
    ref = et.Rejection(m["d"], batch_size=100, seed=13).sample(
        20, n_sim=1000, bar=False, fused=False)
    backend = et.set_client("elfi_tpu_torch.parallel.dask_client",
                            n_workers=2, threads_per_worker=1,
                            processes=False, device="cpu")
    try:
        res = et.Rejection(m["d"], batch_size=100, seed=13).sample(
            20, n_sim=1000, bar=False)
        np.testing.assert_array_equal(res.samples_array, ref.samples_array)
    finally:
        backend.close()


def test_ipyparallel_backend_matches_native():
    ipp = pytest.importorskip("ipyparallel")
    try:
        client = ipp.Client(timeout=5)
    except Exception as e:  # noqa: BLE001  no running controller
        pytest.skip(f"no ipcluster is running: {e}")
    m = ma2.get_model(seed_obs=4)
    ref = et.Rejection(m["d"], batch_size=100, seed=13).sample(
        20, n_sim=1000, bar=False, fused=False)
    et.set_client("elfi_tpu_torch.parallel.ipyparallel_client",
                  ipp_client=client, device="cpu")
    res = et.Rejection(m["d"], batch_size=100, seed=13).sample(
        20, n_sim=1000, bar=False)
    np.testing.assert_array_equal(res.samples_array, ref.samples_array)
