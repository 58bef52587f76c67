"""Dask adapter backend (counterpart of
:mod:`elfi_tpu.parallel.dask_client`): attach to an externally managed
``dask.distributed`` scheduler (reference ``elfi/clients/dask.py``).

Optional dependency: ``dask[distributed]`` and a reachable scheduler.
Loaded by module path::

    et.set_client("elfi_tpu_torch.parallel.dask_client",
                  address="tcp://scheduler:8786")

With no ``address``, ``dask.distributed.Client()`` starts a local cluster,
as in the reference.  Tasks ship as pickled callables; a batch is a pure
function of (seed, batch index), so results equal the native backend's
and a lost task replays.  Worker processes compute on their CPU by
design; a task that runs inside the master's process (``processes=False``)
runs the master's program on its device (see
:func:`~elfi_tpu_torch.parallel.backends._run_adapter_batch`).
"""

from __future__ import annotations

import os

from .backends import (BackendBase, _Remote, _run_adapter_batch,
                       _to_device, _to_host)

__all__ = ["Client"]

# importable under the JAX package's name (tests ship it to raw workers)
_run_batch = _run_adapter_batch


class Client(BackendBase):
    """BackendBase-protocol adapter over ``dask.distributed.Client``;
    ``device`` is the master's (None: the current CUDA device)."""

    def __init__(self, address=None, dask_client=None, device=None,
                 **kwargs):
        super().__init__(device)
        if dask_client is None:
            from dask.distributed import Client as DaskClient
            dask_client = DaskClient(address, **kwargs) if address \
                else DaskClient(**kwargs)
        self.dask_client = dask_client

    @property
    def num_cores(self):
        try:
            return max(1, sum(self.dask_client.ncores().values()))
        except Exception:  # noqa: BLE001  a scheduler that is going away
            return 1

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        return _Remote(self.dask_client.submit(
            _run_adapter_batch, program, seed, batch_index,
            _to_host(overrides), batch_size, os.getpid(),
            pure=False), program.device)

    def _materialize(self, handle):
        return _to_device(handle.future.result(), handle.device)

    def _handle_ready(self, handle):
        return handle.future.done()

    def _run_thunk(self, fn, args, kwargs):
        return self.dask_client.submit(fn, *args, **kwargs,
                                       pure=False).result()

    def remove_task(self, task_id):
        handle = self._tasks.pop(task_id, None)
        if isinstance(handle, _Remote):
            try:
                handle.future.cancel()
            except Exception:  # noqa: BLE001  cancelling is best effort
                pass

    def apply_sync(self, fn, *args, **kwargs):
        return self.dask_client.submit(fn, *args, **kwargs,
                                       pure=False).result()

    def close(self):
        try:
            self.dask_client.close()
        except Exception:  # noqa: BLE001  closing is best effort
            pass
