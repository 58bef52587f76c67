"""sims_per_s (sims/s, host clock): every simulation of every call
completed in the window, over the window's seconds."""


def read(run):
    return run.sims / run.window_s
