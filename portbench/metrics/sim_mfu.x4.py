"""sim_mfu.x4 (%, host clock and counts): the model's float operations a
simulation (``counts.<config>.sim_ops``) times the traced window's
simulations a second, over the float32 peak of the cell's cards."""

from portbench.counts import peaks


def read(run):
    if run.trace is None:
        return None
    rate = run.sims / run.window_s
    return 100.0 * run.counts.sim_ops(run.config) * rate \
        / (run.cell.chips * peaks.FP32_FLOPS)
