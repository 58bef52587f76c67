"""launches_per_batch.smc (launches/batch, device trace): the host's
calls that queue work on the card (kernel launches and CUDA graph
launches) in the traced window, over the batches the window simulated."""


def read(run):
    if run.trace is None or run.batches == 0:
        return None
    return run.trace.launches / run.batches
