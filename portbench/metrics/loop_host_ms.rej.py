"""loop_host_ms.rej (ms, program spans): the host's time in the inference
loop outside its chunks and its host reads, a call: the union of the
window's ``elfi.sampler.init`` and ``elfi.sample`` spans, less its overlap
with the ``elfi.chunk`` and ``elfi.host_read`` spans, over the window's
calls."""

from portbench.harness import spans


def read(run):
    if run.trace is None:
        return None
    host = run.trace.host
    loop = spans.named(host, "elfi.sampler.init", "elfi.sample")
    if not loop:
        return None
    inner = spans.named(host, "elfi.chunk", "elfi.host_read")
    return 1e-6 * spans.length(spans.subtract(loop, inner)) \
        / len(run.trace.calls)
