"""cull_roofline (%, device trace): the least time of one top-N merge
of a batch into the buffer (``counts.peaks.selection``) over the card's
time of the cull's kernels per merge."""

from portbench.counts import peaks
from portbench.harness.readers import CULL, CULL_MERGE, roofline


def read(run):
    t = run.traffic
    ops, nbytes = peaks.selection(t["batch_size"], t["n_samples"],
                                  len(run.config["parameters"]))
    return roofline(run, CULL, ops, nbytes, per=CULL_MERGE)
