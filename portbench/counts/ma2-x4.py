"""Operation and byte counts of the four-card MA(2) deployment: a
simulation is ``ma2``'s, wherever it runs (``portbench/counts/ma2.py``).
"""

from portbench.counts.ma2 import (N_PARAMS, distance_bytes,  # noqa: F401
                                  distance_ops, prior_ops, sim_ops)
