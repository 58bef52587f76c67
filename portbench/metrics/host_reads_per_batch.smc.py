"""host_reads_per_batch.smc (reads/batch, program spans): the window's
``elfi.host_read`` spans, each a wait of the host for a value from the
card (a chunk's acceptance count, a proposal's support flag, a
population's copy), over the batches the window simulated."""

from portbench.harness import spans


def read(run):
    if run.trace is None or run.batches == 0 \
            or not spans.has_spans(run.trace.host):
        return None
    return len(spans.named(run.trace.host, "elfi.host_read")) / run.batches
