"""Operation and byte counts of the g-and-k configuration, from its
shapes: ``n_obs`` values, 4 parameters, ``n_obs`` order statistics
(``portbench/configs/gnk.json``)."""

from .peaks import COMPARE, NORMAL, UNIFORM, sort_compares

N_PARAMS = 4
#: the quantile function a value: g z, its exponential, 1 - e, 1 + e,
#: their quotient, the product with c and the sum with 1, z^2 + 1, its
#: power k (a logarithm, a product, an exponential), and the products
#: with z and B and the sum with A
TRANSFORM = 16


def prior_ops(config):
    """Four uniforms, each scaled to [0, 10]."""
    return N_PARAMS * (UNIFORM + 1)


def distance_ops(config):
    """What the distance kernel K2 computes a simulation: n_obs normals,
    the quantile function at each, a sort of the n_obs values, and the
    distance (a difference and a square a value, the sum, a square
    root)."""
    n = config["n_obs"]
    return n * NORMAL + n * TRANSFORM + sort_compares(n) * COMPARE + 3 * n


def sim_ops(config):
    return prior_ops(config) + distance_ops(config)


def distance_bytes(config, batch):
    """A, B, g and k read, the distance written, the sorted observed
    sample read once."""
    return batch * (4 * N_PARAMS + 4) + 4 * config["n_obs"]
