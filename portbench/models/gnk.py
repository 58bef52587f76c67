"""The g-and-k configuration declared through the port's DSL as
``elfi_tpu_torch.models.gnk_kernel.get_model`` (``kernel``: priors -> the
fused distance kernel K2, node ``d``) and ``elfi_tpu_torch.models.gnk.
get_model`` (``plain``: priors -> ``GNK`` -> ``ss_order`` ->
``euclidean_multiss``, node ``d``, ELFI's own declaration) declare it, on
the configuration's observed sample, the one the reference reads.

Not those functions themselves: they draw the observed sample with the
port's generator, which on the card differs from the configuration's (the
JAX package's) sample by rounding, so the two sides would read different
data.  The kernel graph names the zoo's distance operation,
``gnk_kernel._KernelGnkDistance``: a rename fails the run at its set-up.
The node names key the streams, and the reference uses the same names.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import elfi_tpu_torch as et
from elfi_tpu_torch.models import gnk, gnk_kernel


def build(config, graph):
    """(model, name of the distance node) for ``graph``."""
    y = np.asarray(config["observed"], np.float32).reshape(-1, 1)
    n_obs = config["n_obs"]
    m = et.Model(name=f"gnk_{graph}")
    priors = [et.Prior("uniform", 0, 10, model=m, name=n)
              for n in config["parameters"]]
    if graph == "kernel":
        et.Operation(gnk_kernel._KernelGnkDistance(y, n_obs), *priors,
                     stochastic=True, uses_batch_size=True, model=m,
                     name="d")
    elif graph == "plain":
        et.Simulator(partial(gnk.GNK, c=config["c"], n_obs=n_obs), *priors,
                     observed=y, model=m, name="GNK")
        ss = et.Summary(gnk.ss_order, m["GNK"], model=m, name="ss_order")
        et.Discrepancy(gnk.euclidean_multiss, ss, model=m, name="d")
    else:
        raise ValueError(f"no g-and-k graph {graph!r}")
    return m, "d"
