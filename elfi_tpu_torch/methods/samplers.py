"""ABC rejection sampling (counterpart of :mod:`elfi_tpu.methods.samplers`;
SMC and the adaptive SMC samplers come later).

The running top-N sample buffer lives on the device and is maintained by
:mod:`elfi_tpu_torch.ops.topk`.  ``Rejection.sample`` runs a FUSED path
when nothing host-side is needed (no adaptive distance): a host loop that
queues every batch's program and merge on the device without reading
anything back, except, in threshold mode, one acceptance count per chunk
of batches.  The fused and the batch-at-a-time paths call the same
per-batch function with the same stream seeds and the same merge, so they
give identical samples for a seed.
"""

from __future__ import annotations

import logging
from math import ceil, inf

import numpy as np
import torch

from ..compile.compiler import compile_program
from ..model.model import AdaptiveDistance
from ..ops import topk
from ..parallel.backends import NativeBackend
from .base import Sampler, _ProgressBar
from .results import Sample

__all__ = ["Rejection"]

logger = logging.getLogger(__name__)

#: batches queued between progress updates, and between the host reads of
#: the acceptance count in threshold mode.  Not tuned on this hardware.
_FUSED_CHUNK = 16
_MAX_BATCHES = 100_000


class Rejection(Sampler):
    """Parallel ABC rejection sampler."""

    def __init__(self, model, discrepancy_name=None, output_names=None,
                 **kwargs):
        model, discrepancy_name = self._resolve_model(model, discrepancy_name)
        output_names = [discrepancy_name] + model.parameter_names \
            + (output_names or [])
        self.adaptive = isinstance(model[discrepancy_name], AdaptiveDistance)
        if self.adaptive:
            model[discrepancy_name].init_adaptation_round()
            self.sums = [s.name for s in model[discrepancy_name].parents]
            for k in self.sums:
                if k not in output_names:
                    output_names.append(k)
        super().__init__(model, output_names, **kwargs)
        self.discrepancy_name = discrepancy_name
        self._merge = topk.make_merge_fn(discrepancy_name)

    # -- objective ---------------------------------------------------------
    def set_objective(self, n_samples, threshold=None, quantile=None,
                      n_sim=None):
        if quantile is None and threshold is None and n_sim is None:
            quantile = .01
        self.state = dict(samples=None, threshold=np.inf, n_sim=0,
                          accept_rate=1, n_batches=0, n_accepted=0)
        if quantile:
            n_sim = ceil(n_samples / quantile)
        if n_sim:
            n_batches = ceil(n_sim / self.batch_size)
        else:
            n_batches = self.max_parallel_batches
        self.objective = dict(n_samples=n_samples, threshold=threshold,
                              n_batches=n_batches)
        self.batches.reset()

    # -- batch-at-a-time path ------------------------------------------------
    def update(self, batch, batch_index):
        super().update(batch, batch_index)
        if self.state["samples"] is None:
            self.state["samples"] = topk.init_buffers(
                self.objective["n_samples"], batch, self.discrepancy_name)
        if self.adaptive:
            self.model[self.discrepancy_name].add_data(
                *(batch[s].cpu().numpy() for s in self.sums))
        self.state["samples"], acc = self._merge(self.state["samples"],
                                                 batch,
                                                 self._merge_threshold())
        if self.objective.get("threshold") is not None:
            self.state["n_accepted"] += int(acc)
            self._update_objective_n_batches()
        else:
            self.state["n_accepted"] += self.batch_size

    def _merge_threshold(self):
        """The threshold as a float32 value, as the JAX package compares."""
        t = self.objective.get("threshold")
        return inf if t is None else float(np.float32(t))

    def _update_objective_n_batches(self):
        """Re-estimate the batches needed under a fixed threshold."""
        s = self.state
        n_samples = self.objective["n_samples"]
        n_acceptable = s["n_accepted"]
        if n_acceptable == 0:
            n_batches = self.objective["n_batches"] + 1
        else:
            accept_rate_t = n_acceptable / s["n_sim"]
            margin = .2 * self.batch_size * int(n_acceptable < n_samples)
            n_batches = ceil((n_samples / accept_rate_t + margin)
                             / self.batch_size)
        self.objective["n_batches"] = max(n_batches, s["n_batches"])

    # -- result ------------------------------------------------------------------
    def extract_result(self):
        if self.state["samples"] is None:
            raise ValueError("Nothing to extract")
        if self.adaptive:
            self._update_distances()
        outputs = {k: v.cpu().numpy()
                   for k, v in self.state["samples"].items() if k != "__key"}
        self._update_state_meta(outputs)
        return Sample(outputs=outputs, **self._extract_result_kwargs())

    def _update_state_meta(self, outputs):
        n = self.objective["n_samples"]
        d = np.asarray(outputs[self.discrepancy_name])
        self.state["threshold"] = d[n - 1]
        self.state["accept_rate"] = min(1, n / max(self.state["n_sim"], 1))

    def _update_distances(self):
        """Adaptive distance: freeze the new scale, recompute the kept
        rows' distances under it and re-sort them (reference
        ``samplers.py:279-299``).  The order is numpy's ``argsort`` of the
        new distances, as in the JAX package."""
        node = self.model[self.discrepancy_name]
        node.update_distance()
        nums = self.objective["n_samples"]
        samples = self.state["samples"]
        data = {s: samples[s][:nums] for s in self.sums}
        prog = compile_program(self.model, (self.discrepancy_name,),
                               override_names=tuple(sorted(data)),
                               device=self.device)
        ds = prog.run(self.seed, 0, data,
                      batch_size=nums)[self.discrepancy_name]
        sort_distance = ds if ds.ndim == 1 else ds[:, -1]
        order = torch.as_tensor(np.argsort(sort_distance.cpu().numpy()),
                                device=sort_distance.device)
        new = {k: v.index_select(0, order) for k, v in samples.items()
               if k not in (self.discrepancy_name, "__key")}
        new[self.discrepancy_name] = new["__key"] = \
            sort_distance.index_select(0, order)
        self.state["samples"] = new

    # -- fused path -----------------------------------------------------------------
    def sample(self, n_samples, threshold=None, quantile=None, n_sim=None,
               fused=None, bar=True, **kwargs):
        """Sample from the approximate posterior.

        ``fused=True`` (default when eligible) queues the whole rejection
        loop on the device from one host loop.  An adaptive distance needs
        the host between batches, so it runs batch at a time.
        """
        self.bar = bar
        eligible = (not self.adaptive
                    and isinstance(self.client, NativeBackend)
                    and not kwargs)
        if fused is None:
            fused = eligible
        if fused and not eligible:
            raise ValueError("fused=True requires: no adaptive distance, "
                             "native backend")
        self.set_objective(n_samples, threshold=threshold, quantile=quantile,
                           n_sim=n_sim)
        prog = compile_program(self.model, tuple(self.output_names),
                               device=self.device)
        if fused and prog.host:
            fused = False
        if not fused:
            return self.infer(n_samples, threshold=threshold,
                              quantile=quantile, n_sim=n_sim, bar=bar,
                              **kwargs)
        self._run_fused(prog, threshold)
        self.batches.reset()
        return self.extract_result()

    def _run_fused(self, prog, threshold):
        """Queue batches ``0, 1, ...`` and their merges on the device.
        Without a threshold the host never waits for the device here; with
        one it reads the acceptance count once per ``_FUSED_CHUNK``
        batches."""
        seed = self.seed
        fn = prog.traceable(self.batch_size)
        disc = self.discrepancy_name
        n = self.objective["n_samples"]
        thr = self._merge_threshold()
        buffers = None

        def run(start, length):
            nonlocal buffers
            accs = []
            for i in range(start, start + length):
                out = fn(seed, i, {})
                if buffers is None:
                    buffers = topk.init_buffers(n, out, disc)
                buffers, acc = topk.merge_scan(buffers, out, thr, disc)
                accs.append(acc)
            return accs

        pb = _ProgressBar() if self.bar else None
        if threshold is None:
            n_batches = self.objective["n_batches"]
            done = 0
            while done < n_batches:
                length = min(_FUSED_CHUNK, n_batches - done)
                run(done, length)
                done += length
                if pb:
                    pb.update(done, n_batches)
            self.state["n_accepted"] = done * self.batch_size
        else:
            done, accepted = 0, 0
            while accepted < n and done < _MAX_BATCHES:
                accs = run(done, _FUSED_CHUNK)
                done += _FUSED_CHUNK
                accepted += int(torch.stack(accs).sum())
                if pb:
                    pb.update(min(accepted, n), n)
            self.state["n_accepted"] = accepted
            if accepted < n:
                logger.warning(
                    "Threshold %s unattainable within %d batches: only %d of "
                    "%d requested samples were accepted; the remaining rows "
                    "of the returned sample are +inf-discrepancy padding.",
                    threshold, _MAX_BATCHES, accepted, n)
        if pb:
            pb.finish()
        self.state["n_batches"] = done
        self.state["n_sim"] = done * self.batch_size
        self.state["samples"] = buffers
        self.objective["n_batches"] = done
