#!/usr/bin/env python3
"""Reference posterior means of the gamma/beta prior model that
``chip_smoke.py``'s distributions phase runs on the card.

    python3 scripts/torch_prior_reference.py [--port] [--seeds 1 2 3]

builds the same graph in the JAX package (default) or the port (``--port``)
on the CPU -- ``a ~ gamma(2, 0, 1)``, ``b ~ beta(2, 5)``, a simulator of
20 draws of ``N(a, 0.5^2)`` and 20 of ``N(b, 0.1^2)``, their two means as
the summary, the euclidean distance to the observed means (1.5, 0.3) --
and prints, per seed, the posterior means of

- ``Rejection(m["d"], batch_size=2**20, seed=s).sample(5000,
  n_sim=4 * 2**20)`` and
- ``SMC(m["d"], batch_size=2**16, seed=s).sample(2000, quantiles=[0.1,
  0.1, 0.1])`` (weighted).

``chip_smoke.py`` runs :func:`port_model` on the card with the same calls
and holds its means to the JAX package's from this script.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

OBS_MEANS = (1.5, 0.3)
N_OBS = 20
REJ = dict(batch_size=2**20, n_samples=5000, n_sim=4 * 2**20)
SMC = dict(batch_size=2**16, n_samples=2000, quantiles=[0.1, 0.1, 0.1])


def observed():
    return np.stack([np.full(N_OBS, OBS_MEANS[0], np.float32),
                     np.full(N_OBS, OBS_MEANS[1], np.float32)])


def jax_model():
    import jax
    import jax.numpy as jnp
    import elfi_tpu as elfi

    def sim(a, b, batch_size=1, key=None):
        e = jax.random.normal(key, (batch_size, 2, N_OBS))
        return jnp.stack([a[:, None] + 0.5 * e[:, 0],
                          b[:, None] + 0.1 * e[:, 1]], 1)

    m = elfi.Model(name="gamma_beta")
    elfi.Prior("gamma", 2.0, 0.0, 1.0, model=m, name="a")
    elfi.Prior("beta", 2.0, 5.0, model=m, name="b")
    elfi.Simulator(sim, m["a"], m["b"], observed=observed(), model=m,
                   name="sim")
    elfi.Summary(lambda y: jnp.mean(y, axis=2), m["sim"], model=m, name="S")
    elfi.Distance("euclidean", m["S"], model=m, name="d")
    return elfi, m


def port_model():
    import torch
    import elfi_tpu_torch as et

    def sim(a, b, batch_size=1, generator=None):
        e = torch.randn((batch_size, 2, N_OBS), generator=generator,
                        device=generator.device)
        return torch.stack([a[:, None] + 0.5 * e[:, 0],
                            b[:, None] + 0.1 * e[:, 1]], 1)

    m = et.Model(name="gamma_beta")
    et.Prior("gamma", 2.0, 0.0, 1.0, model=m, name="a")
    et.Prior("beta", 2.0, 5.0, model=m, name="b")
    et.Simulator(sim, m["a"], m["b"], observed=observed(), model=m,
                 name="sim")
    et.Summary(lambda y: y.mean(2), m["sim"], model=m, name="S")
    et.Distance("euclidean", m["S"], model=m, name="d")
    return et, m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    args = ap.parse_args()
    if not args.port:
        import jax
        jax.config.update("jax_platforms", "cpu")
    pkg, m = port_model() if args.port else jax_model()
    if args.port:
        pkg.set_client("native", device="cpu")
    out = {}
    for seed in args.seeds:
        r = pkg.Rejection(m["d"], batch_size=REJ["batch_size"],
                          seed=seed).sample(REJ["n_samples"],
                                            n_sim=REJ["n_sim"], bar=False)
        s = pkg.SMC(m["d"], batch_size=SMC["batch_size"], seed=seed).sample(
            SMC["n_samples"], quantiles=SMC["quantiles"], bar=False)
        w = np.asarray(s.weights, np.float64)
        w = w / w.sum()
        out[seed] = {
            "rejection": [float(np.mean(r.samples[k])) for k in "ab"],
            "smc": [float(np.sum(w * np.asarray(s.samples[k])))
                    for k in "ab"]}
        print(json.dumps({"seed": seed, **out[seed]}), flush=True)
    for kind in ("rejection", "smc"):
        v = np.array([out[s][kind] for s in args.seeds])
        print(kind, "mean", v.mean(0).tolist(), "sd",
              v.std(0, ddof=1).tolist() if len(v) > 1 else None)


if __name__ == "__main__":
    main()
