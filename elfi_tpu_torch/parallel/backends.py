"""Execution backends (counterpart of :mod:`elfi_tpu.parallel.backends`).

The port runs on the card: a caller that names no device gets the global
backend's, which is the current CUDA device unless a backend on another
device was set.  Without a CUDA device such a call raises; the CPU is used
only where it is asked for (``device="cpu"``, or
``set_client("native", device="cpu")``).

:class:`NativeBackend` runs a batch's program on one device.  On CUDA the
program's ops are asynchronous launches, so ``submit`` returns as soon as
they are queued; the backend records a CUDA event after them, and
``get_result`` waits on that event.  Results are consumed in submission
order by :class:`~elfi_tpu_torch.parallel.batches.BatchHandler`.
"""

from __future__ import annotations

import torch

__all__ = ["get_client", "set_client", "reset_client", "default_device",
           "resolve_device", "BackendBase", "NativeBackend"]

_client = None


def get_client():
    """The global backend; a :class:`NativeBackend` on the current CUDA
    device until one is set."""
    global _client
    if _client is None:
        _client = NativeBackend()
    return _client


def set_client(client=None, **kwargs):
    """Set the global backend; accepts an instance or the name 'native'."""
    global _client
    if isinstance(client, str):
        if client != "native":
            raise ValueError(f"Unknown backend {client!r}: the PyTorch port "
                             "has only 'native'")
        client = NativeBackend(**kwargs)
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


class BackendBase:
    """Task-queue protocol shared by all backends."""

    #: how many batches an inference method may keep in flight
    num_cores = 1

    def __init__(self):
        self._tasks = {}
        self._next = 0

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
        return self._materialize(handle)

    def _materialize(self, handle):
        return handle

    def is_ready(self, task_id):
        handle = self._tasks.get(task_id)
        if handle is None or isinstance(handle, _Failed):
            return True
        return self._handle_ready(handle)

    def _handle_ready(self, handle):
        return True

    def remove_task(self, task_id):
        self._tasks.pop(task_id, None)

    def reset(self):
        self._tasks.clear()


class NativeBackend(BackendBase):
    """Single-device backend.  ``device`` is the device an inference object
    runs on when it is not given one itself; None means the current CUDA
    device, looked up when it is used.  ``num_cores=2`` keeps one batch
    queued on the device while the host prepares the next."""

    num_cores = 2

    def __init__(self, device=None):
        super().__init__()
        self._device = None if device is None else torch.device(device)

    @property
    def device(self):
        return self._device if self._device is not None else default_device()

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        out = program.run(seed, batch_index, overrides, batch_size)
        event = None
        if program.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(program.device))
        return out, event

    def _materialize(self, handle):
        out, event = handle
        if event is not None:
            event.synchronize()
        return out

    def _handle_ready(self, handle):
        _, event = handle
        return event is None or event.query()
