"""Batch farming over processes with ``torch.distributed`` (counterpart of
:mod:`elfi_tpu.parallel.multihost`).

Every process of a ``torch.distributed`` job runs the same inference
loop.  Batch index ``i`` belongs to rank ``i % world_size``: the owner
computes it and broadcasts its outputs to the other ranks, so every rank
consumes the same batches in the same order.  A batch is a pure function
of (seed, batch index), so this is deterministic and needs no task RPC.

- The first batch of a device program broadcasts a small header (each
  output's name, shape and dtype) before its tensors; later batches of the
  same program, overrides and batch size reuse it.  Torch has no
  ``eval_shape`` for the JAX package's shape discovery.
- A host graph's first batch of a given key runs on every rank, and its
  outputs give the shapes; later batches are farmed
  (``farm_host_ops=False`` runs every host batch everywhere).
- The transport follows the process group: an NCCL group broadcasts on
  the current CUDA device, any other (gloo) through host copies.  NCCL
  refuses two ranks on one card, so two processes sharing a card use
  gloo.  ``broadcast`` keeps dtypes, so the JAX package's 32-bit transport
  encoding is not needed; booleans travel as uint8.

A single process (no process group, or a world of one) runs the native
path.  The caller initialises the group itself
(``torch.distributed.init_process_group`` with its address, world size
and rank) before constructing the backend.
"""

from __future__ import annotations

import torch

from .backends import BackendBase, _queued

__all__ = ["MultihostBackend"]


class MultihostBackend(BackendBase):
    """SPMD task farm: rank ``p`` computes the batch indices with
    ``index % world_size == p``; the owner broadcasts each result.
    ``device`` is this process's (None: the current CUDA device)."""

    num_cores = 2

    def __init__(self, farm_host_ops=True, device=None):
        super().__init__(device)
        import torch.distributed as dist
        self._dist = dist if dist.is_available() and dist.is_initialized() \
            else None
        self.process_index = self._dist.get_rank() if self._dist else 0
        self.num_processes = self._dist.get_world_size() if self._dist \
            else 1
        self.num_cores = max(2, self.num_processes)
        self.farm_host_ops = farm_host_ops
        #: (program key, override names, batch size) -> the outputs'
        #: [(name, shape, dtype)], the same on every rank
        self._headers = {}

    def _transport(self):
        if self._dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _launch(self, program, seed, batch_index, overrides, batch_size):
        if self.num_processes == 1:
            return "local", _queued(program, seed, batch_index, overrides,
                                    batch_size)
        key = (program.cache_key, tuple(sorted(overrides)), batch_size)
        if program.host and (not self.farm_host_ops
                             or key not in self._headers):
            # computed everywhere: the same outputs on every rank, and the
            # shapes the later farmed batches need
            out = program.run(seed, batch_index, overrides, batch_size)
            self._headers[key] = _header(out)
            return "local", (out, None)
        owner = batch_index % self.num_processes
        result = None
        if owner == self.process_index:
            result = program.run(seed, batch_index, overrides, batch_size)
        return "bcast", owner, result, key, program.device

    def _materialize(self, handle):
        if handle[0] == "local":
            out, event = handle[1]
            if event is not None:
                event.synchronize()
            return out
        _, owner, result, key, device = handle
        return self._broadcast(owner, result, key, device)

    def _broadcast(self, owner, result, key, device):
        """The owner's outputs on every rank.  Collective: every rank calls
        it for every farmed batch in submission order, which the batch
        handler's in-order consumption guarantees."""
        dist = self._dist
        mine = owner == self.process_index
        header = self._headers.get(key)
        if header is None:
            box = [_header(result) if mine else None]
            dist.broadcast_object_list(box, src=owner)
            header = self._headers[key] = box[0]
        tdev = self._transport()
        out = {}
        for name, shape, dtype in header:
            wire = torch.uint8 if dtype == torch.bool else dtype
            if mine:
                buf = result[name].to(tdev, wire).contiguous()
            else:
                buf = torch.empty(shape, dtype=wire, device=tdev)
            dist.broadcast(buf, src=owner)
            out[name] = result[name] if mine else buf.to(device, dtype)
        return out


def _header(out):
    for name, v in out.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"output {name!r} is not a tensor and cannot be "
                            "broadcast between processes")
    return [(name, tuple(v.shape), v.dtype) for name, v in sorted(out.items())]
