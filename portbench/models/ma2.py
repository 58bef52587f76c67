"""The MA(2) configuration as the port's public zoo declares it:
``elfi_tpu_torch.models.ma2_kernel.get_model`` (``kernel``: priors -> the
fused distance kernel K1, node ``d``) and ``elfi_tpu_torch.models.ma2.
get_model`` (``plain``: priors -> ``MA2`` -> the autocovariances ``S1``,
``S2`` -> euclidean ``d``), at the configuration's ``n_obs``,
``true_params`` and ``seed_obs``.

The model draws its observed series itself; :func:`build` refuses one
that is not the configuration's, which the reference reads.  The node
names key the streams, and the reference uses the same names.
"""

from __future__ import annotations

import numpy as np

from elfi_tpu_torch.models import ma2, ma2_kernel


def build(config, graph):
    """(model, name of the distance node) for ``graph``."""
    kw = dict(n_obs=config["n_obs"], true_params=tuple(config["true_params"]),
              seed_obs=config["seed_obs"])
    makers = {"kernel": ma2_kernel.get_model, "plain": ma2.get_model}
    if graph not in makers:
        raise ValueError(f"no MA(2) graph {graph!r}")
    y = np.asarray(ma2.observed_data(**kw), np.float32).reshape(-1)
    if not np.array_equal(y, np.asarray(config["observed"], np.float32)):
        raise ValueError("the port's observed MA(2) series at seed_obs "
                         f"{config['seed_obs']} is not the configuration's")
    return makers[graph](**kw), "d"
