"""Execution backends (counterpart of :mod:`elfi_tpu.parallel.backends`).

The port runs on the card: a caller that names no device gets the global
backend's, which is the current CUDA device unless a backend on another
device was set.  Without a CUDA device such a call raises; the CPU is used
only where it is asked for (``device="cpu"``, or
``set_client("native", device="cpu")``).

- :class:`NativeBackend` runs a batch's program on one device.  On CUDA
  the program's ops are asynchronous launches, so ``submit`` returns as
  soon as they are queued; the backend records a CUDA event after them,
  and ``get_result`` waits on that event.
- :class:`ShardedBackend` is a list of devices in one process.  It deals
  whole batches to the devices in turn (batch ``i`` on device
  ``i % n_devices``), so a batch is the same pure function of (seed,
  batch index) as on the native backend and equals the native batch on
  the same type of device.  The fused rejection and SMC loops, BSL's
  fused chain, NUTS's chains and ROMC's problems read the list from
  ``.mesh``.
- :class:`MultiprocessingBackend` is a pool of spawned processes for host
  graphs (external and numpy simulators).  Its workers compute on their
  CPU by design, as the JAX package's do: the program a worker is sent is
  compiled there for the CPU, and a kernel graph runs its kernels' plain
  versions.

Results are consumed in submission order by
:class:`~elfi_tpu_torch.parallel.batches.BatchHandler`.  Whatever leaves
the process travels as numpy: overrides are copied to the host before a
task is sent, and a worker's outputs are copied onto the submitting
program's device when they are read.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

__all__ = ["get_client", "set_client", "reset_client", "default_device",
           "resolve_device", "BackendBase", "NativeBackend",
           "ShardedBackend", "MultiprocessingBackend"]

_client = None


def get_client():
    """The global backend; a :class:`NativeBackend` on the current CUDA
    device until one is set."""
    global _client
    if _client is None:
        _client = NativeBackend()
    return _client


def set_client(client=None, **kwargs):
    """Set the global backend; accepts an instance, a name ('native' |
    'sharded' | 'multiprocessing' | 'cluster' | 'multihost') or the path of
    a module with a ``Client`` class (the dask and ipyparallel adapters)."""
    global _client
    if isinstance(client, str):
        from .cluster import ClusterBackend
        from .multihost import MultihostBackend
        mapping = {"native": NativeBackend, "sharded": ShardedBackend,
                   "multiprocessing": MultiprocessingBackend,
                   "multihost": MultihostBackend,
                   "cluster": ClusterBackend}
        if client in mapping:
            client = mapping[client](**kwargs)
        else:
            client = importlib.import_module(client).Client(**kwargs)
    _client = client
    return _client


def reset_client():
    global _client
    _client = None


def default_device():
    """The current CUDA device; raises if there is none, since the port
    falls back to the CPU nowhere."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "elfi_tpu_torch runs on a CUDA device unless asked for the CPU, "
            "and no CUDA device is available: pass device='cpu' or call "
            "elfi_tpu_torch.set_client('native', device='cpu')")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means the global backend's
    device."""
    return torch.device(device) if device is not None else get_client().device


class _Failed:
    """A launch that raised; the error surfaces at ``get_result``, where the
    batch handler's deterministic retry lives."""

    def __init__(self, error):
        self.error = error


class _Thunk:
    """A call recorded by :meth:`BackendBase.apply`; it runs at
    ``get_result`` (the JAX package's ``("thunk", fn, args, kwargs)``
    record: the native backend's handles are tuples here, so records are
    classes)."""

    def __init__(self, fn, args, kwargs):
        self.fn, self.args, self.kwargs = fn, args, kwargs


def _to_host(values):
    """A batch's outputs or overrides as numpy, for the trip to another
    process."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in (values or {}).items()}


def _to_device(out, device):
    """A batch's outputs onto ``device``: numeric arrays become tensors
    there with their dtype; anything else is passed on as it is."""
    res = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            res[k] = v.to(device)
        elif isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            res[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        else:
            res[k] = v
    return res


class BackendBase:
    """Task-queue protocol shared by all backends.  ``device`` is the device
    an inference object runs on when it is not given one itself; None
    means the current CUDA device, looked up when it is used."""

    #: how many batches an inference method may keep in flight
    num_cores = 1

    def __init__(self, device=None):
        self._tasks = {}
        self._next = 0
        self._device = None if device is None else torch.device(device)

    @property
    def device(self):
        return self._device if self._device is not None else default_device()

    def submit(self, program, seed, batch_index, overrides, batch_size):
        """Submit one batch: ``seed`` is the integer context seed from which
        every stream seed is derived."""
        tid = self._next
        self._next += 1
        try:
            self._tasks[tid] = self._launch(program, seed, batch_index,
                                            overrides, batch_size)
        except Exception as e:  # noqa: BLE001  re-raised by get_result
            self._tasks[tid] = _Failed(e)
        return tid

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        raise NotImplementedError

    def get_result(self, task_id):
        handle = self._tasks.pop(task_id)
        if isinstance(handle, _Failed):
            raise handle.error
        if isinstance(handle, _Thunk):
            return self._run_thunk(handle.fn, handle.args, handle.kwargs)
        return self._materialize(handle)

    def _materialize(self, handle):
        return handle

    def _run_thunk(self, fn, args, kwargs):
        """Where ``apply`` records run, at ``get_result``; backends that
        can farm a call override this."""
        return fn(*args, **kwargs)

    def is_ready(self, task_id):
        handle = self._tasks.get(task_id)
        if handle is None or isinstance(handle, (_Failed, _Thunk)):
            return True       # records resolve at get_result
        return self._handle_ready(handle)

    def _handle_ready(self, handle):
        return True

    def remove_task(self, task_id):
        self._tasks.pop(task_id, None)

    def reset(self):
        for tid in list(self._tasks):
            self.remove_task(tid)

    def apply(self, fn, *args, **kwargs):
        """Record the call ``fn(*args, **kwargs)`` as a task; it runs at
        ``get_result`` (the reference farms MCMC chains this way)."""
        tid = self._next
        self._next += 1
        self._tasks[tid] = _Thunk(fn, args, kwargs)
        return tid

    def apply_sync(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)


def _queued(program, seed, batch_index, overrides, batch_size):
    """Run ``program`` (its launches queued on a CUDA device) and record an
    event after them; returns ``(outputs, event or None)``."""
    out = program.run(seed, batch_index, overrides, batch_size)
    event = None
    if program.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(program.device))
    return out, event


class NativeBackend(BackendBase):
    """Single-device backend.  ``num_cores=2`` keeps one batch queued on the
    device while the host prepares the next."""

    num_cores = 2

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        return _queued(program, seed, batch_index, overrides, batch_size)

    def _materialize(self, handle):
        out, event = handle
        if event is not None:
            event.synchronize()
        return out

    def _handle_ready(self, handle):
        _, event = handle
        return event is None or event.query()


def _normalized(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return default_device()
    return device


class ShardedBackend(BackendBase):
    """A list of devices in one process (the JAX package's mesh with the
    batch axis sharded).  ``devices=None`` means every CUDA device, and
    raises without one; ``devices=["cpu", "cpu"]`` serves the CPU tests,
    and a list may name one card twice.

    A batch runs whole on device ``batch_index % n_devices``, from the
    program compiled there, and its outputs are copied onto the
    submitting program's device when they are read.  A host graph runs as
    on the native backend.  ``.mesh`` is the device list, passed on where
    the JAX package passes its mesh; BSL's chain, NUTS's chains and ROMC's
    problems run on the first device (the backend's ``device``), since
    their steps are bound by the one host thread's launches and a split
    over devices would only add launches."""

    def __init__(self, devices=None):
        if devices is None:
            if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
                raise RuntimeError(
                    "ShardedBackend() spans every CUDA device and none is "
                    "available: pass devices=[...] to name them")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [_normalized(d) for d in devices]
        if not devices:
            raise ValueError("ShardedBackend needs at least one device")
        super().__init__(devices[0])
        self.devices = devices

    @property
    def mesh(self):
        return self.devices

    @property
    def n_devices(self):
        return len(self.devices)

    @property
    def num_cores(self):
        return 2 * self.n_devices

    def device_of(self, batch_index):
        """The device that runs batch ``batch_index``."""
        return self.devices[int(batch_index) % self.n_devices]

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        if program.host:
            return _queued(program, seed, batch_index, overrides,
                           batch_size), program.device
        dev = self.device_of(batch_index)
        overrides = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                     for k, v in (overrides or {}).items()}
        return _queued(program.on(dev), seed, batch_index, overrides,
                       batch_size), program.device

    def _materialize(self, handle):
        (out, event), device = handle
        if event is not None:
            event.synchronize()
        return _to_device(out, device)

    def _handle_ready(self, handle):
        (_, event), _ = handle
        return event is None or event.query()


def _cpu_worker_init(threads=None):
    """Make this process a CPU worker, by the backends' design (a card is
    not shared between processes, as the JAX package's workers force its
    CPU backend): CUDA is hidden before anything could initialise it, the
    global backend is native on the CPU and, for a pool, torch keeps one
    thread (N workers that each take every core oversubscribe the host)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if threads is not None:
        torch.set_num_threads(threads)
    set_client("native", device="cpu")


def _run_host_task(program, seed, batch_index, overrides, batch_size):
    """A worker's task body: the program compiled for this process's CPU,
    run, and its outputs as numpy."""
    out = program.on("cpu").run(seed, batch_index, overrides, batch_size)
    return _to_host(out)


def _run_adapter_batch(program, seed, batch_index, overrides, batch_size,
                       client_pid=None):
    """The dask and ipyparallel adapters' task body.  In another process
    it makes that process a CPU worker and runs there; inside the master's
    process (dask ``processes=False``, an in-process ipyparallel view) it
    runs the master's program as it is, on the master's device, and
    leaves the master's global backend alone."""
    if client_pid is None or os.getpid() != client_pid:
        _cpu_worker_init()
        return _run_host_task(program, seed, batch_index, overrides,
                           batch_size)
    return _to_host(program.run(seed, batch_index, overrides, batch_size))


class _Remote:
    """A task running elsewhere: its future and the device its numpy
    outputs are copied onto when they are read."""

    def __init__(self, future, device):
        self.future, self.device = future, device


class MultiprocessingBackend(BackendBase):
    """A pool of spawned CPU workers for host graphs (external and numpy
    simulators); the analogue of ``elfi/clients/multiprocessing.py``.

    Each task pickles its program (without its device caches) and the
    overrides as numpy; the worker compiles the program for its CPU, so
    device nodes draw CPU streams there.  A graph whose stochastic nodes
    are all host nodes therefore gives the native backend's samples on
    any device, and any graph gives them against a native backend on the
    CPU.  A task that exceeds ``task_timeout`` seconds or dies with the
    pool raises at ``get_result``, where the batch handler replays the
    batch index; a broken pool is rebuilt before the retry."""

    def __init__(self, num_processes=None, task_timeout=600, device=None):
        super().__init__(device)
        import multiprocessing as mp
        self.num_cores = num_processes or mp.cpu_count()
        self.task_timeout = task_timeout
        self._make_pool()

    def _make_pool(self):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        # spawn, not fork: torch's threads do not survive a fork
        self._pool = ProcessPoolExecutor(
            max_workers=self.num_cores, mp_context=mp.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(1,))

    def _rebuild_pool(self):
        try:
            self._pool.shutdown(wait=False, cancel_futures=True)
        except Exception:  # noqa: BLE001  the pool is being replaced
            pass
        self._make_pool()

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        return _Remote(self._pool.submit(
            _run_host_task, program, seed, batch_index,
            _to_host(overrides), batch_size), program.device)

    def _result(self, future):
        import concurrent.futures as cf
        try:
            return future.result(timeout=self.task_timeout)
        except cf.TimeoutError:
            future.cancel()
            raise RuntimeError(
                f"multiprocessing task exceeded {self.task_timeout}s")
        except cf.process.BrokenProcessPool:
            self._rebuild_pool()
            raise

    def _materialize(self, handle):
        return _to_device(self._result(handle.future), handle.device)

    def _run_thunk(self, fn, args, kwargs):
        return self._result(self._pool.submit(fn, *args, **kwargs))

    def _handle_ready(self, handle):
        return handle.future.done()

    def remove_task(self, task_id):
        handle = self._tasks.pop(task_id, None)
        if isinstance(handle, _Remote):
            handle.future.cancel()

    def close(self):
        """Stop the workers."""
        self._pool.shutdown(wait=True, cancel_futures=True)
