"""replay_host_us.rej (us, program spans): the host's part of a graph's
replay, the mean over the window's ``elfi.graph.replay`` spans of each
one's length less the ``elfi.host_read`` spans inside it (the wait for
the keys' copy two replays ago, which lasts as long as the card's work
queued before it): the streams' seeds derived, the generators re-seeded,
the keys copied, ``cudaGraphLaunch``."""

from portbench.harness import spans


def read(run):
    if run.trace is None:
        return None
    host = run.trace.host
    replays = spans.named(host, "elfi.graph.replay")
    if not replays:
        return None
    reads = spans.named(host, "elfi.host_read")
    return 1e-3 * spans.length(spans.subtract(replays, reads)) / len(replays)
