"""ops_ms_per_batch (ms/batch, device trace): the card's time of every
operation that is not one of the port's own CUDA kernels (the
``__global__`` functions of its ``csrc/``: K1, K2, the cull and any added
later), over the batches of the traced window: the graph's torch
operations, the flat merges and the copies."""

from portbench.harness.readers import port_kernels


def read(run):
    if run.trace is None or run.batches == 0:
        return None
    total, _ = run.trace.op_seconds(("",))
    kernels, _ = run.trace.op_seconds(port_kernels())
    return 1e3 * (total - kernels) / run.batches
