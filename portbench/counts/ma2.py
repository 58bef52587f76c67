"""Operation and byte counts of the MA(2) configuration, from its shapes:
``n_obs`` values, 2 parameters, 2 summaries (``portbench/configs/ma2.json``).
"""

from .peaks import NORMAL, UNIFORM

N_PARAMS = 2


def prior_ops(config):
    """t1: a uniform, a square root, a product and a difference and the
    branch's select; t2 | t1: a uniform, two bounds and their maximum, a
    difference, a product and a sum."""
    return 2 * UNIFORM + 4 + 6


def distance_ops(config):
    """What the distance kernel K1 computes a simulation: n_obs + 2
    normals, the series (two products and two sums a value), the two
    autocovariances (a product and a sum a term, a division each) and the
    distance (two differences, two squares, a sum, a square root)."""
    n = config["n_obs"]
    return ((n + 2) * NORMAL + 4 * n + 2 * (n - 1) + 2 * (n - 2) + 2 + 6)


def sim_ops(config):
    """The model's float operations a simulation: priors to distance."""
    return prior_ops(config) + distance_ops(config)


def distance_bytes(config, batch):
    """Bytes the distance kernel must move for a batch: t1 and t2 read,
    the distance written, the observed summaries read once."""
    return batch * (4 * N_PARAMS + 4) + 4 * 2
