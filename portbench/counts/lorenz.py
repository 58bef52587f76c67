"""Operation and byte counts of the Lorenz-96 configuration, from its
shapes: ``n_obs`` sites, ``n_timestep`` states (``n_timestep - 1`` steps),
2 parameters, 6 summaries (``portbench/configs/lorenz.json``).

A step, at each site: the closure noise (a normal draw, then phi eta +
sqrt(1 - phi^2) e: two products and a sum, 3), and one RK4 step (52):
four evaluations of the tendency, each 9 operations (the advection
-y[k-2] y[k-1] + y[k-1] y[k+1]: two products and a sum; less y, plus F,
the closure theta1 + theta2 y: a product and a sum, less it, plus eta),
the four stages scaled by the step (4), the three stage states (two
halvings and three sums, 5), the weighted sum k1 + 2 k2 + 2 k3 + k4 (two
products and three sums, 5), the sixth and the sum with y (2).  So a step
costs 40 x (6 + 3 + 52) = 2,440 operations and a simulation 159 steps.
"""

from .peaks import NORMAL, UNIFORM

N_PARAMS = 2
#: one evaluation of the tendency at a site
TENDENCY = 9
#: one RK4 step at a site: four tendencies, the stages scaled by the
#: step, the stage states, the weighted sum, the sixth and the sum with y
RK4 = 4 * TENDENCY + 4 + 5 + 5 + 2
#: the closure noise's recursion at a site a step
NOISE = 3


def prior_ops(config):
    """Two uniforms, each scaled and shifted (loc + scale u)."""
    return N_PARAMS * (UNIFORM + 2)


def step_ops(config):
    """One time step over every site: its normals, the noise's recursion
    and the RK4 step."""
    return config["n_obs"] * (NORMAL + NOISE + RK4)


def summary_ops(config):
    """The six summaries of a (n_timestep, n_obs) trajectory, a site and a
    time of ``T`` values each: the mean (a sum a value); the variance (the
    site's mean, the centring, a square and a sum: 4 a value); the lag-one
    autocovariance and the two cross-covariances (over ``T - 1`` pairs:
    two means, two centrings, a product and a sum, 6 a pair each); the
    neighbour covariance (over ``T`` values: 6 a value)."""
    t, n = config["n_timestep"], config["n_obs"]
    return t * n * (1 + 4 + 6) + 3 * (t - 1) * n * 6


def distance_ops(config):
    """The distance from the six summaries: six differences, six squares,
    five sums and a square root."""
    return 6 + 6 + 5 + 1


def sim_ops(config):
    """The model's float operations a simulation: priors to distance."""
    return (prior_ops(config) + (config["n_timestep"] - 1) * step_ops(config)
            + summary_ops(config) + distance_ops(config))
