"""call_ms_p95 (ms, host clock): the 95th percentile (linear
interpolation) of the walls of all the calls of the window."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile([r.wall_s for r in run.records], 95))
