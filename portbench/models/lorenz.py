"""The Lorenz-96 configuration declared through the port's DSL as
``elfi_tpu_torch.models.lorenz.get_model`` declares it (``plain``: the
priors ``theta1``, ``theta2`` -> the simulator ``Lorenz`` -> the six
summaries ``Mean``, ``Var``, ``Autocov``, ``Cov``, ``CrosscovPrev``,
``CrosscovNext`` -> euclidean ``d``, ELFI's own declaration), on the
configuration's observed trajectory and initial state, the ones the
reference reads.

Not ``get_model`` itself: it draws the observed trajectory with the
port's generator, which on the card differs from the configuration's (the
JAX package's) trajectory by rounding that the chaotic system grows, so
the two sides would read different data.  The node names key the
streams, and the reference uses the same names.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import elfi_tpu_torch as et
from elfi_tpu_torch.models import lorenz


def build(config, graph):
    """(model, name of the distance node) for ``graph``."""
    if graph != "plain":
        raise ValueError(f"no Lorenz-96 graph {graph!r}")
    y = np.asarray(config["observed"], np.float32)
    m = et.Model(name="lorenz_plain")
    for name in config["parameters"]:
        et.Prior("uniform", *config["priors"][name], model=m, name=name)
    sim = partial(lorenz.forecast_lorenz,
                  initial_state=np.asarray(config["initial_state"],
                                           np.float32),
                  f=config["f"], n_obs=config["n_obs"], phi=config["phi"],
                  total_duration=config["total_duration"],
                  n_timestep=config["n_timestep"])
    et.Simulator(sim, *(m[p] for p in config["parameters"]), observed=y,
                 model=m, name="Lorenz")
    ss = [et.Summary(fn, m["Lorenz"], model=m, name=name)
          for fn, name in ((lorenz.mean, "Mean"), (lorenz.var, "Var"),
                           (lorenz.autocov, "Autocov"), (lorenz.cov, "Cov"),
                           (partial(lorenz.xcov, prev=True), "CrosscovPrev"),
                           (partial(lorenz.xcov, prev=False),
                            "CrosscovNext"))]
    et.Distance("euclidean", *ss, model=m, name="d")
    return m, "d"
