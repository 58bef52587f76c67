"""Repeated-inference benchmarking harness (counterpart of
:mod:`elfi_tpu.testbench`).  Observations and reference parameters are
drawn with ``Model.generate`` on the global backend's device and kept as
numpy; each method runs wherever its own ``device`` resolves."""

from __future__ import annotations

import logging

import numpy as np

__all__ = ["Testbench", "TestbenchMethod"]

logger = logging.getLogger(__name__)


class Testbench:
    """Compare LFI methods over repeated inferences on generated or given
    observations."""

    def __init__(self, model=None, observations=None,
                 reference_parameter=None, reference_posterior=None,
                 repetitions=1, seed=None, progress_bar=True):
        self.model = model
        self.method_list = []
        self.method_seed_list = []
        self.repetitions = repetitions
        self.rng = np.random.RandomState(seed)
        self.observations = None if observations is None \
            else np.asarray(observations).copy()
        self.reference_parameter = None if reference_parameter is None \
            else dict(reference_parameter)
        self.reference_posterior = reference_posterior
        self.param_names = model.parameter_names
        self.simulator_name = list(model.observed)[0]
        self.description = {
            "observations_available": self.observations is not None,
            "reference_parameters_available":
                self.reference_parameter is not None,
            "reference_posterior_available":
                self.reference_posterior is not None,
        }
        self._resolve_reference_parameters()
        self._resolve_observations()

    def _get_seeds(self, n_rep=1):
        return self.rng.randint(0, 2**31 - 1, size=n_rep)

    def _resolve_reference_parameters(self):
        if self.description["reference_parameters_available"]:
            self.reference_parameter = {
                k: np.repeat(np.atleast_1d(v), self.repetitions)[
                    :self.repetitions]
                for k, v in self.reference_parameter.items()}
        elif not self.description["observations_available"]:
            seed = self._get_seeds(1)[0]
            self.reference_parameter = self.model.generate(
                batch_size=self.repetitions,
                outputs=self.model.parameter_names, seed=int(seed))

    def _resolve_observations(self):
        if self.description["observations_available"]:
            obs = np.atleast_2d(self.observations)
            self.observations = np.repeat(obs, self.repetitions,
                                          axis=0)[:self.repetitions]
        else:
            seed = self._get_seeds(1)[0]
            self.observations = self.model.generate(
                with_values=self.reference_parameter,
                outputs=[self.simulator_name],
                batch_size=self.repetitions,
                seed=int(seed))[self.simulator_name]

    def add_method(self, new_method):
        """Register a TestbenchMethod."""
        self.method_list.append(new_method)
        self.method_seed_list.append(self._get_seeds(self.repetitions))

    def run(self):
        self.testbench_results = []
        for method, seeds in zip(self.method_list, self.method_seed_list):
            logger.info("Running %s in testbench",
                        method.attributes["name"])
            self.testbench_results.append(
                self._repeat_inference(method, seeds))

    def _repeat_inference(self, method, seed_list):
        repeated = []
        model = self.model.copy()
        for i in range(self.repetitions):
            model.observed[self.simulator_name] = np.asarray(
                self.observations[i])
            model._invalidate_cache()
            repeated.append(self._draw_posterior_sample(method, model,
                                                        int(seed_list[i])))
        return {"method": method.attributes["name"], "results": repeated}

    @staticmethod
    def _draw_posterior_sample(method, model, seed):
        inst = method.attributes["callable"](
            model, **method.attributes["method_kwargs"], seed=seed)
        fit_kwargs = method.attributes["fit_kwargs"]
        if fit_kwargs:
            inst.fit(**fit_kwargs)
        return inst.sample(**method.attributes["sample_kwargs"])

    def get_testbench_results(self):
        return {"testcases": {
                    "model": self.model,
                    "observations": self.observations,
                    "reference_parameter": self.reference_parameter,
                    "reference_posterior": self.reference_posterior},
                "results": self.testbench_results}

    def parameterwise_sample_mean_differences(self):
        """Per-parameter sample-mean error vs the reference parameter."""
        out = {}
        for method_results in self.testbench_results:
            diffs = {}
            for name in self.param_names:
                diffs[name] = [
                    float(np.ravel(res.sample_means[name])[0])
                    - float(np.ravel(self.reference_parameter[name][i])[0])
                    for i, res in enumerate(method_results["results"])]
            out[method_results["method"]] = diffs
        return out


class TestbenchMethod:
    """Container describing one inference method configuration."""

    def __init__(self, method, method_kwargs=None, fit_kwargs=None,
                 sample_kwargs=None, name=None):
        self.attributes = {"callable": method,
                           "method_kwargs": method_kwargs or {},
                           "fit_kwargs": fit_kwargs or {},
                           "sample_kwargs": sample_kwargs or {},
                           "name": name or method.__name__}

    def set_method_kwargs(self, **kwargs):
        self.attributes["method_kwargs"] = kwargs

    def set_fit_kwargs(self, **kwargs):
        self.attributes["fit_kwargs"] = kwargs

    def set_sample_kwargs(self, **kwargs):
        self.attributes["sample_kwargs"] = kwargs

    def get_method(self):
        return self.attributes
