"""An all-host graph for the port's backend checks (``chip_smoke.py``'s
backends phase): a scipy prior, a numpy simulator, a numpy summary and a
numpy distance, each a ``host=True`` node whose draws come from
``host_seed`` of its stream.  Every node runs in numpy, so a batch is the
same bits in any process and on any device: a pool or cluster run of this
graph equals the native run on the card.  Its functions live in an
importable module so that a cluster worker (``python -m
elfi_tpu_torch.worker``, started in the repository's root) unpickles
them."""

from __future__ import annotations

import numpy as np

N_OBS = 16
OBSERVED_MEAN = 0.7


def simulate(mu, batch_size=1, random_state=None):
    """``N_OBS`` normals around each ``mu``; (batch, N_OBS)."""
    return np.asarray(mu, np.float64)[:, None] \
        + random_state.standard_normal((batch_size, N_OBS))


def mean(x):
    return np.mean(np.asarray(x), axis=1)


def distance(s, observed=()):
    return np.abs(np.asarray(s) - np.asarray(observed[0]).ravel())


def get_model():
    import elfi_tpu_torch as et
    m = et.Model(name="all_host")
    et.Prior("gumbel_r", 0.5, 0.3, model=m, name="mu")
    et.Simulator(simulate, m["mu"], host=True,
                 observed=np.full(N_OBS, OBSERVED_MEAN), model=m, name="sim")
    et.Summary(mean, m["sim"], host=True, model=m, name="S")
    et.Discrepancy(distance, m["S"], host=True, model=m, name="d")
    return m
