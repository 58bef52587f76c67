"""Base classes for inference methods (counterpart of
:mod:`elfi_tpu.methods.base`).

The iterate loop submits up to ``max_parallel_batches`` batches, consumes
them strictly in order and updates the state.  A "parallel batch" is a
program whose ops are queued on the device, so submission overlaps
host-side bookkeeping with device compute.
"""

from __future__ import annotations

from math import ceil

import numpy as np

from ..compile.compiler import compile_program
from ..model.model import ComputationContext, Model, NodeReference
from ..parallel.backends import get_client, resolve_device
from ..parallel.batches import BatchHandler
from ..utils.profiling import annotate
from .utils import arr2d_to_batch, batch_to_arr2d

__all__ = ["ParameterInference", "Sampler", "ModelBased"]


class ParameterInference:
    """Base inference loop.

    ``device`` is where every program of the inference runs; by default the
    global backend's device (the current CUDA device unless a backend on
    another device was set; without a CUDA device that raises).  A
    requested device is used as given, never replaced.

    ``pool`` (an :class:`~elfi_tpu_torch.store.OutputPool`) stores the
    pooled nodes' outputs of every consumed batch and replays the batches
    it holds; a method with a pool runs batch at a time.
    """

    def __init__(self, model, output_names, batch_size=1, seed=None,
                 pool=None, max_parallel_batches=None, device=None):
        with annotate("elfi.sampler.init"):
            model = model.model if isinstance(model, NodeReference) else model
            if not model.parameter_names:
                raise ValueError(f"Model {model.name} defines no parameters")

            self.model = model.copy()
            self.output_names = self._check_outputs(output_names)
            self.client = get_client()
            self.device = resolve_device(device)
            self.computation_context = ComputationContext(
                batch_size=batch_size, seed=seed, pool=pool)
            self.batches = BatchHandler(self.model,
                                        context=self.computation_context,
                                        output_names=self.output_names,
                                        client=self.client, device=self.device)
            self.max_parallel_batches = max_parallel_batches or \
                max(1, self.client.num_cores)
            self.state = dict(n_sim=0, n_batches=0)
            self.objective = dict()
            self.bar = True

    # -- properties ----------------------------------------------------------
    @property
    def pool(self):
        return self.computation_context.pool

    @property
    def seed(self):
        return self.computation_context.seed

    @property
    def parameter_names(self):
        return self.model.parameter_names

    @property
    def batch_size(self):
        return self.computation_context.batch_size

    # -- to override -----------------------------------------------------------
    def set_objective(self, *args, **kwargs):
        raise NotImplementedError

    def extract_result(self):
        raise NotImplementedError

    def update(self, batch, batch_index):
        self.state["n_batches"] += 1
        self.state["n_sim"] += self.batch_size

    def prepare_new_batch(self, batch_index):
        return None

    def plot_state(self, **kwargs):
        raise NotImplementedError

    # -- the loop ---------------------------------------------------------------
    def infer(self, *args, vis=None, bar=True, **kwargs):
        """Run the inference loop batch at a time.

        ``vis``: live plotting, ``True`` or a dict of plot options; after
        every consumed batch the method's ``plot_state`` redraws (in a
        notebook through ``IPython.display``), and once more with
        ``close=True`` at the end.
        """
        self.bar = bar
        vis_opt = dict(interactive=True, **(vis if isinstance(vis, dict)
                                            else {})) if vis else None
        self.set_objective(*args, **kwargs)
        pb = _ProgressBar() if bar else None
        while not self.finished:
            self.iterate()
            if vis_opt:
                self.plot_state(**vis_opt)
            if pb:
                pb.update(self.state["n_batches"], self._objective_n_batches)
        self.batches.cancel_pending()
        if vis_opt:
            self.plot_state(close=True, **{k: v for k, v in vis_opt.items()
                                           if k != "interactive"})
        if pb:
            pb.finish()
        return self.extract_result()

    def iterate(self):
        """One iteration: submit while allowed, then consume the next batch
        in submission order."""
        while self._allow_submit(self.batches.next_index):
            next_batch = self.prepare_new_batch(self.batches.next_index)
            self.batches.submit(next_batch)
        batch, batch_index = self.batches.wait_next()
        self.update(batch, batch_index)

    @property
    def finished(self):
        return self._objective_n_batches <= self.state["n_batches"]

    def _allow_submit(self, batch_index):
        return (self.max_parallel_batches > self.batches.num_pending
                and self._has_batches_to_submit
                and not self.batches.has_ready())

    @property
    def _has_batches_to_submit(self):
        return self._objective_n_batches > \
            self.state["n_batches"] + self.batches.num_pending

    @property
    def _objective_n_batches(self):
        if "n_batches" in self.objective:
            return self.objective["n_batches"]
        if "n_sim" in self.objective:
            return ceil(self.objective["n_sim"] / self.batch_size)
        raise ValueError("Objective must define n_batches or n_sim")

    def _extract_result_kwargs(self):
        return {
            "method_name": type(self).__name__,
            "parameter_names": self.parameter_names,
            "seed": self.seed,
            "n_sim": self.state["n_sim"],
            "n_batches": self.state["n_batches"],
        }

    # -- helpers ---------------------------------------------------------------
    @staticmethod
    def _resolve_model(model, target, default_reference_class=NodeReference):
        if isinstance(model, Model) and target is None:
            raise ValueError("Specify the target node of the inference")
        if isinstance(model, NodeReference):
            target = model
            model = target.model
        if isinstance(target, str):
            target = model[target]
        if not isinstance(target, default_reference_class):
            raise ValueError("Unknown target node class")
        return model, target.name

    def _check_outputs(self, output_names):
        checked, seen = [], set()
        for name in output_names or []:
            if isinstance(name, NodeReference):
                name = name.name
            if name in seen:
                continue
            if not isinstance(name, str):
                raise ValueError(f"Output name {name!r} is not a string")
            if name not in self.model:
                raise ValueError(f"Node {name!r} is not in the model")
            seen.add(name)
            checked.append(name)
        return checked


class Sampler(ParameterInference):
    """Adds ``sample()`` sugar."""

    def sample(self, n_samples, *args, **kwargs):
        bar = kwargs.pop("bar", True)
        self.bar = bar
        return self.infer(n_samples, *args, bar=bar, **kwargs)

    def _extract_result_kwargs(self):
        kwargs = super()._extract_result_kwargs()
        for k in ("threshold", "accept_rate"):
            if k in self.state:
                kwargs[k] = self.state[k]
        if hasattr(self, "discrepancy_name"):
            kwargs["discrepancy_name"] = self.discrepancy_name
        return kwargs


class ModelBased(ParameterInference):
    """Base for methods needing many simulations at the SAME parameter value
    per round -- BSL and friends.

    A round is ``n_sim_round`` simulations in batches of ``batch_size``
    (default: the whole round in one batch).  The observed feature matrix
    comes from the observed values of the program on the method's device;
    each batch's features are copied to numpy, as in the JAX package, and
    the round is processed on the host.
    """

    def __init__(self, model, n_sim_round, feature_names=None,
                 batch_size=None, **kwargs):
        self.n_sim_round = int(n_sim_round)
        batch_size = batch_size or self.n_sim_round
        if self.n_sim_round % batch_size:
            raise ValueError("n_sim_round must be a multiple of batch_size")
        model = model.model if isinstance(model, NodeReference) else model
        if isinstance(feature_names, str):
            feature_names = [feature_names]
        self.feature_names = feature_names or self._get_summary_names(model)
        if not self.feature_names:
            raise ValueError("feature_names must include at least one item")
        for node in self.feature_names:
            if node not in model:
                raise ValueError(f"Node {node!r} not found in the model")
        output_names = model.parameter_names + self.feature_names
        super().__init__(model, output_names, batch_size=batch_size, **kwargs)

        observed = [np.asarray(self._observed_feature(n))
                    for n in self.feature_names]
        self.observed = np.column_stack([o.reshape(1, -1) for o in observed])
        self.state["round"] = 0
        self.state["n_sim_round"] = 0
        self.simulated = np.zeros((self.n_sim_round, self.observed.size))

    def _observed_feature(self, name):
        prog = compile_program(self.model, (name,), device=self.device)
        return prog.observed_value(name).cpu().numpy()

    @staticmethod
    def _get_summary_names(model):
        from ..model.model import Summary
        return [n for n in model.nodes
                if isinstance(model[n], Summary) and not n.startswith("_")]

    def _init_state(self):
        self.state["n_batches"] = 0
        self.state["n_sim"] = 0
        self.state["round"] = 0
        self.state["n_sim_round"] = 0

    def set_objective(self, rounds):
        self.objective["round"] = rounds
        self.objective["n_batches"] = rounds * (self.n_sim_round
                                                // self.batch_size)

    def update(self, batch, batch_index):
        super().update(batch, batch_index)
        self._merge_batch(batch)
        if self.state["n_sim_round"] == self.n_sim_round:
            self._process_simulated()
            self.state["round"] += 1
            if self.state["round"] < self.objective["round"]:
                self._init_round()

    def _init_round(self):
        self.state["n_sim_round"] = 0

    def _process_simulated(self):
        raise NotImplementedError

    def prepare_new_batch(self, batch_index):
        params = np.atleast_2d(self.current_params)
        batch_params = np.repeat(params, self.batch_size, axis=0)
        return arr2d_to_batch(batch_params, self.parameter_names)

    @property
    def current_params(self):
        raise NotImplementedError

    def infer(self, *args, **kwargs):
        if self.state["round"] > 0:
            self._init_round()
        return super().infer(*args, **kwargs)

    def _merge_batch(self, batch):
        simulated = batch_to_arr2d(
            {k: batch[k].cpu().numpy() for k in self.feature_names},
            self.feature_names)
        n_sim = self.state["n_sim_round"]
        self.simulated[n_sim:n_sim + self.batch_size] = simulated
        self.state["n_sim_round"] += self.batch_size

    def _allow_submit(self, batch_index):
        # a batch that starts a new round waits until the last round is in
        starts_new_round = (batch_index * self.batch_size) \
            % self.n_sim_round == 0
        if starts_new_round and self.batches.has_pending:
            return False
        return super()._allow_submit(batch_index)


class _ProgressBar:
    """Minimal textual progress bar."""

    def __init__(self, length=50):
        self.length = length
        self.scaling = 0

    def update(self, n, total):
        total = max(total, 1)
        frac = min(n / total, 1.0)
        filled = int(self.length * frac)
        bar = "=" * filled + "-" * (self.length - filled)
        print(f"\rProgress [{bar}] {100 * frac:.1f}% Complete",
              end="", flush=True)

    def reinit(self, scaling=0, msg=""):
        """Start a new stage: store ``scaling`` and print ``msg`` on a new
        line."""
        self.scaling = scaling
        if msg:
            print(f"\n{msg}")

    def finish(self):
        print()
