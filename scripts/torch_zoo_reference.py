#!/usr/bin/env python3
"""Reference numbers for the zoo phase of ``chip_smoke.py``, on the CPU.

    python3 scripts/torch_zoo_reference.py summaries [--models ...]
    python3 scripts/torch_zoo_reference.py rejection [--seeds 5] [--port]

``summaries`` runs the JAX package's simulator of each device model at its
``get_model`` true parameters (``N_SUMMARY`` simulations, key 12345) and
prints, per model, the mean and the standard error of each gate statistic
(:func:`gate_stats`): the smoke's gate (a) holds the port's means on the
card within 4 combined standard errors of these.

``rejection`` runs ``Rejection(m["d"], batch_size=REF_BATCH,
seed=s).sample(N_SAMPLES, n_sim=...)`` on the cheap models at their
``get_model`` defaults for seeds 1..--seeds, with the JAX package (and
with the port on the CPU given ``--port``), and prints the posterior means
of each seed, their mean and their standard deviation over the seeds: the
smoke's gate (b) holds the port's means on the card within
``4 * sqrt(sd_jax^2 + sd_port^2)`` of the JAX package's mean.  The batch
here is smaller than the smoke's (memory on a CPU host); the call is the
same otherwise: the number of simulations, the number of samples, the
observed data.  One JSON line per model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: simulations per model for gate (a)
N_SUMMARY = {"ar1": 1024, "arch": 1024, "mg1": 1024,
             "stochastic_volatility": 1024, "lorenz": 1024, "toad": 1024,
             "lotka_volterra": 256, "daycare": 256}
#: gate (b): total simulations per cheap model, and the samples kept
N_SIM = {"ar1": 2**18, "arch": 2**18, "mg1": 2**18,
         "stochastic_volatility": 2**18, "lorenz": 2**17, "toad": 2**15}
N_SAMPLES = 256
REF_BATCH = 2**14

SIMULATOR = {"ar1": "AR1", "arch": "Y", "mg1": "MG1",
             "stochastic_volatility": "a_svm", "lorenz": "Lorenz",
             "toad": "toad", "lotka_volterra": "LV", "daycare": "DCC"}


def gate_stats(name, model, outputs, xp):
    """The statistics of gate (a), (n, k) as ``xp`` (numpy or torch) from
    one batch's ``outputs`` of the model's summary nodes and the
    simulator: the summaries the distance reads, each column; for AR(1),
    whose distance reads the series itself, the series' mean and variance
    over time; for daycare, each of its four summaries averaged over the
    29 centres."""
    sim = outputs[SIMULATOR[name]]
    if name == "ar1":
        return xp.stack([sim.mean(1), (sim * sim).mean(1)], 1)
    cols = []
    for s in summary_names(model):
        v = outputs[s]
        v = v.reshape(v.shape[0], -1)
        cols.append(v.mean(1, keepdims=True) if name == "daycare" else v)
    return xp.concatenate(cols, 1) if xp is np else xp.cat(cols, 1)


def summary_names(model):
    """The summary nodes the model's distance reads (through operations)."""
    names, stack = [], list(model.dag.parents("d"))
    while stack:
        n = stack.pop(0)
        if model.dag.get_state(n)["kind"] == "summary":
            names.append(n)
        elif model.dag.get_state(n)["kind"] == "operation":
            stack.extend(model.dag.parents(n))
    return names


def jax_summaries(name, n):
    import importlib
    import jax
    jax.config.update("jax_platforms", "cpu")
    import elfi_tpu as elfi  # noqa: F401
    mod = importlib.import_module(f"elfi_tpu.models.{name}")
    m = mod.get_model()
    pnames = m.parameter_names
    true = TRUE_PARAMS[name]
    outs = [SIMULATOR[name]] + summary_names(m)
    chunk = 64 if name == "daycare" else min(n, 1024)
    stats = []
    for i in range(n // chunk):
        with_values = {p: np.full(chunk, v, np.float32)
                       for p, v in zip(pnames, true)}
        out = m.generate(chunk, outputs=outs, with_values=with_values,
                         seed=12345 + i)
        stats.append(gate_stats(name, m, {k: np.asarray(v, np.float64)
                                          for k, v in out.items()}, np))
    return np.concatenate(stats)


#: each model's get_model true parameters, in parameter_names order
TRUE_PARAMS = {"ar1": [0.9], "arch": [0.3, 0.7], "mg1": [1., 5., 0.2],
               "stochastic_volatility": [1.2, 0.5], "lorenz": [2.0, 0.1],
               "toad": [1.7, 35.0, 0.6],
               "lotka_volterra": [100., 50., 1.0, 0.005, 0.6],
               "daycare": [3.6, 0.6, 0.1]}


def rejection_means(name, seed, port):
    import importlib
    n_batches = N_SIM[name] // REF_BATCH
    if port:
        import torch
        torch.set_num_threads(2)
        import elfi_tpu_torch as et
        et.set_client("native", device="cpu")
        m = importlib.import_module(f"elfi_tpu_torch.models.{name}") \
            .get_model()
        rej = et.Rejection(m["d"], batch_size=REF_BATCH, seed=seed)
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import elfi_tpu as elfi
        m = importlib.import_module(f"elfi_tpu.models.{name}").get_model()
        rej = elfi.Rejection(m["d"], batch_size=REF_BATCH, seed=seed)
    res = rej.sample(N_SAMPLES, n_sim=n_batches * REF_BATCH, bar=False)
    return [float(np.mean(res.samples[p])) for p in m.parameter_names]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("summaries", "rejection"))
    ap.add_argument("--models", nargs="*")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    if args.mode == "summaries":
        for name in args.models or list(N_SUMMARY):
            t0 = time.perf_counter()
            s = jax_summaries(name, N_SUMMARY[name])
            print(json.dumps({"model": name, "n": len(s),
                              "mean": s.mean(0).tolist(),
                              "se": (s.std(0, ddof=1)
                                     / np.sqrt(len(s))).tolist(),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    else:
        for name in args.models or list(N_SIM):
            t0 = time.perf_counter()
            means = np.array([rejection_means(name, s, args.port)
                              for s in range(1, args.seeds + 1)])
            print(json.dumps({"model": name, "package": "port" if args.port
                              else "jax", "means": means.tolist(),
                              "mean": means.mean(0).tolist(),
                              "sd": means.std(0, ddof=1).tolist(),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
