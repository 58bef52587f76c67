"""In-order batch submission and consumption (counterpart of
:mod:`elfi_tpu.parallel.batches`, without output pools).

Inference methods submit batches (optionally with per-batch parameter
overrides) and consume results strictly in submission order, which makes
every method's output a pure function of its seed."""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..compile.compiler import compile_program
from .backends import get_client

__all__ = ["BatchHandler"]


class BatchHandler:
    def __init__(self, model, context, output_names, client=None, *,
                 device):
        self.model = model
        self.context = context
        self.output_names = tuple(output_names)
        self.client = client or get_client()
        self.device = torch.device(device)
        self._pending = OrderedDict()   # batch_index -> task_id
        self._submitted_args = {}       # batch_index -> (program, overrides)
        self.next_index = 0

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

    def has_ready(self):
        if not self._pending:
            return False
        return self.client.is_ready(next(iter(self._pending.values())))

    def submit(self, batch=None):
        """Submit the next batch; ``batch`` is a dict of node-name ->
        override values used in place of those nodes' ops."""
        batch = dict(batch or {})
        index = self.next_index
        program = compile_program(self.model, self.output_names,
                                  override_names=tuple(sorted(batch)),
                                  device=self.device)
        tid = self.client.submit(program, self.context.seed, index, batch,
                                 self.context.batch_size)
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
        for attempt in range(max_retries + 1):
            try:
                batch = self.client.get_result(tid)
                break
            except Exception as e:  # noqa: BLE001  replay the same index
                if attempt == max_retries:
                    raise RuntimeError(
                        f"Batch {index} failed after {max_retries} "
                        f"retries: {e}") from e
                program, overrides = self._submitted_args[index]
                tid = self.client.submit(program, self.context.seed, index,
                                         overrides, self.context.batch_size)
        self._submitted_args.pop(index, None)
        return batch, index

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
