"""smc_run_ms (ms, host clock): the window's milliseconds over the SMC
runs completed in it, the time to a posterior."""


def read(run):
    return 1e3 * run.window_s / len(run.records)
