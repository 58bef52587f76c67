"""In-order batch submission and consumption (counterpart of
:mod:`elfi_tpu.parallel.batches`).

Inference methods submit batches (optionally with per-batch parameter
overrides) and consume results strictly in submission order, which makes
every method's output a pure function of its seed.

With an output pool in the context, the pooled nodes join the outputs; a
batch index the pool holds is replayed: each stored node's values are
copied onto the handler's device (one host-to-device copy per stored node
per batch) and passed as overrides, so a node whose whole ancestry is
stored does not run.  After each consumed batch the context's
``callback`` hands it to the pool, which copies the pooled names off the
device."""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..compile.compiler import compile_program
from ..utils.profiling import Timers
from .backends import get_client

__all__ = ["BatchHandler"]


class BatchHandler:
    def __init__(self, model, context, output_names, client=None, *,
                 device):
        self.model = model
        self.context = context
        output_names = list(output_names)
        # pooled nodes are computed (and so stored) with the outputs
        if context.pool is not None:
            for name in context.pool.output_names:
                if name not in output_names and name in model:
                    output_names.append(name)
        self.output_names = tuple(output_names)
        self.client = client or get_client()
        self.device = torch.device(device)
        self._pending = OrderedDict()   # batch_index -> task_id
        self._submitted_args = {}       # batch_index -> (program, overrides)
        self.next_index = 0
        self.timers = Timers()

    @property
    def num_pending(self):
        return len(self._pending)

    @property
    def has_pending(self):
        return bool(self._pending)

    @property
    def total(self):
        """Number of batches submitted so far."""
        return self.next_index

    @property
    def pending_indices(self):
        return list(self._pending)

    def has_ready(self, any_batch=False):
        if not self._pending:
            return False
        if any_batch:
            return any(self.client.is_ready(t)
                       for t in self._pending.values())
        return self.client.is_ready(next(iter(self._pending.values())))

    def _replayed(self, index, skip=()):
        """The pool's stored outputs of batch ``index`` whose names are not
        in ``skip``, each copied onto the device."""
        stored = self.context.pool.get_batch(index)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in stored.items() if k not in skip}

    def submit(self, batch=None):
        """Submit the next batch; ``batch`` is a dict of node-name ->
        override values used in place of those nodes' ops.  The pool's
        values of the batch index fill in the names ``batch`` leaves: the
        caller's overrides win."""
        batch = dict(batch or {})
        index = self.next_index
        if self.context.pool is not None:
            batch.update(self._replayed(index, skip=batch))
        program = compile_program(self.model, self.output_names,
                                  override_names=tuple(sorted(batch)),
                                  device=self.device)
        with self.timers.time("submit"):
            tid = self.client.submit(program, self.context.seed, index,
                                     batch, self.context.batch_size)
        self._pending[index] = tid
        self._submitted_args[index] = (program, batch)
        self.next_index += 1
        self.context.num_submissions = max(self.context.num_submissions,
                                           self.next_index)
        return index

    def wait_next(self, max_retries=2):
        """Block for the OLDEST pending batch.  The per-node RNG makes every
        batch index replayable, so a failed batch is resubmitted with the
        same seed and index up to ``max_retries`` times."""
        if not self._pending:
            raise ValueError("Cannot wait for a batch, no batches are pending")
        index, tid = self._pending.popitem(last=False)
        with self.timers.time("wait"):
            for attempt in range(max_retries + 1):
                try:
                    batch = self.client.get_result(tid)
                    break
                except Exception as e:  # noqa: BLE001  replay the index
                    if attempt == max_retries:
                        raise RuntimeError(
                            f"Batch {index} failed after {max_retries} "
                            f"retries: {e}") from e
                    program, overrides = self._submitted_args[index]
                    tid = self.client.submit(program, self.context.seed,
                                             index, overrides,
                                             self.context.batch_size)
        self._submitted_args.pop(index, None)
        with self.timers.time("callback"):   # the pool's copy to the host
            self.context.callback(batch, index)
        return batch, index

    def compute(self, batch_index=0, batch=None):
        """Compute one batch and wait for it (no pool replay, no
        callback)."""
        batch = batch or {}
        program = compile_program(self.model, self.output_names,
                                  override_names=tuple(sorted(batch)),
                                  device=self.device)
        out = program.run(self.context.seed, batch_index, batch,
                          self.context.batch_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def cancel_pending(self):
        """Drop all not-yet-consumed batches; ``next_index`` rewinds so the
        indices are resubmitted."""
        if not self._pending:
            return
        first = next(iter(self._pending))
        for idx, tid in self._pending.items():
            self.client.remove_task(tid)
            self._submitted_args.pop(idx, None)
        self._pending.clear()
        self.next_index = first

    def reset(self):
        self.cancel_pending()
        self.next_index = 0
