"""ipyparallel adapter backend (counterpart of
:mod:`elfi_tpu.parallel.ipyparallel_client`): attach to a running ipcluster
(reference ``elfi/clients/ipyparallel.py``).

Optional dependency: ``ipyparallel`` and a running controller
(``ipcluster start -n 4``).  Loaded by module path::

    et.set_client("elfi_tpu_torch.parallel.ipyparallel_client")

Batch tasks go through the controller's load-balanced view; a batch is a
pure function of (seed, batch index), so results equal the native
backend's.  Engines compute on their CPU by design; an in-process view
runs the master's program on its device (see
:func:`~elfi_tpu_torch.parallel.backends._run_adapter_batch`).
"""

from __future__ import annotations

import os

from .backends import (BackendBase, _Remote, _run_adapter_batch,
                       _to_device, _to_host)

__all__ = ["Client"]

_run_batch = _run_adapter_batch


class Client(BackendBase):
    """BackendBase-protocol adapter over
    ``ipyparallel.Client().load_balanced_view()``; ``device`` is the
    master's (None: the current CUDA device)."""

    def __init__(self, ipp_client=None, device=None, **kwargs):
        super().__init__(device)
        if ipp_client is None:
            import ipyparallel as ipp
            ipp_client = ipp.Client(**kwargs)
        self.ipp_client = ipp_client
        self.view = ipp_client.load_balanced_view()

    @property
    def num_cores(self):
        return max(1, len(self.view))

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        return _Remote(self.view.apply(
            _run_adapter_batch, program, seed, batch_index,
            _to_host(overrides), batch_size, os.getpid()),
            program.device)

    def _materialize(self, handle):
        return _to_device(handle.future.get(), handle.device)

    def _handle_ready(self, handle):
        return handle.future.ready()

    def _run_thunk(self, fn, args, kwargs):
        return self.view.apply(fn, *args, **kwargs).get()

    def remove_task(self, task_id):
        handle = self._tasks.pop(task_id, None)
        # ipyparallel can only abort tasks that have not started
        if isinstance(handle, _Remote) and not handle.future.ready():
            try:
                self.ipp_client.abort(handle.future, block=False)
            except Exception:  # noqa: BLE001  aborting is best effort
                pass

    def reset(self):
        try:
            self.view.abort(block=False)
        except Exception:  # noqa: BLE001  aborting is best effort
            pass
        self._tasks.clear()

    def apply_sync(self, fn, *args, **kwargs):
        return self.view.apply_sync(fn, *args, **kwargs)

    def close(self):
        try:
            self.ipp_client.close()
        except Exception:  # noqa: BLE001  closing is best effort
            pass
