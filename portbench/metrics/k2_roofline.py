"""k2_roofline (%, device trace): the least time of a batch's
distances (the configuration's ``distance_ops`` and ``distance_bytes``)
over the card's time per launch of the distance kernel K2."""

from portbench.harness.readers import K2, roofline


def read(run):
    b = run.traffic["batch_size"]
    return roofline(run, K2, run.counts.distance_ops(run.config) * b,
                    run.counts.distance_bytes(run.config, b))
