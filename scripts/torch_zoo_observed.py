#!/usr/bin/env python3
"""Redraw the JAX package's observed data for the port's zoo models into
``elfi_tpu_torch/models/data/<model>_observed.npz``, one array per setting
the tests and ``chip_smoke.py`` use, keyed by
``elfi_tpu_torch.models._observed.setting_key``.  Runs the JAX package on
the CPU:

    python3 scripts/torch_zoo_observed.py
"""

import importlib
import os
import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from elfi_tpu_torch.models._observed import setting_key  # noqa: E402

SMALL_DAYCARE = dict(n_dcc=2, n_ind=8, n_strains=4, n_obs=6, time_end=0.5)
# model: (simulator node, get_model defaults that key the data, the
# settings to store as (seed_obs, get_model keyword arguments))
SETTINGS = {
    "ar1": ("AR1", dict(n_obs=200, true_params=[.9]),
            [(None, {}), (3, {})]),
    "arch": ("Y", dict(n_obs=100, true_params=[0.3, 0.7]),
             [(None, {}), (3, {})]),
    "mg1": ("MG1", dict(n_obs=50, true_params=[1., 5., 0.2]),
            [(None, {}), (3, {})]),
    "stochastic_volatility": ("a_svm", dict(n_obs=50, true_params=[1.2, .5]),
                              [(None, {}), (3, {})]),
    "lorenz": ("Lorenz", dict(true_params=[2.0, 0.1], n_obs=40, f=10.,
                              phi=0.984, total_duration=4.0, n_timestep=160),
               [(None, {}), (3, {}), (3, dict(n_timestep=40))]),
    "toad": ("toad", dict(true_params=[1.7, 35.0, 0.6], n_toads=66,
                          n_days=63),
             [(None, {}), (3, {}), (3, dict(n_toads=10, n_days=20))]),
    "lotka_volterra": ("LV", dict(n_obs=50, time_end=30.,
                                  true_params=[1.0, 0.005, 0.6, 50, 100, 0.]),
                       [(None, {}), (3, {}),
                        (3, dict(n_obs=8, time_end=5.))]),
    "daycare": ("DCC", dict(true_params=[3.6, 0.6, 0.1], n_dcc=29, n_ind=53,
                            n_strains=33, n_obs=36, time_end=10.),
                [(None, {}), (3, SMALL_DAYCARE), (None, SMALL_DAYCARE)]),
}


def main():
    for model, (node, defaults, settings) in SETTINGS.items():
        mod = importlib.import_module(f"elfi_tpu.models.{model}")
        arrays = {}
        for seed_obs, kw in settings:
            obs = mod.get_model(seed_obs=seed_obs, **kw).observed[node]
            key = setting_key(seed_obs=seed_obs, **{**defaults, **kw})
            arrays[key] = np.asarray(obs)
        np.savez_compressed(os.path.join(
            ROOT, "elfi_tpu_torch", "models", "data",
            f"{model}_observed.npz"), **arrays)
        print(model, {k: v.shape for k, v in arrays.items()}, flush=True)


if __name__ == "__main__":
    main()
