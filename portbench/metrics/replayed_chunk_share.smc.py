"""replayed_chunk_share.smc (%, program spans): the window's
``elfi.chunk`` spans that hold an ``elfi.graph.replay`` span and no
``elfi.graph.record``, ``elfi.graph.capture`` or ``elfi.chunk.redo``,
over all its ``elfi.chunk`` spans: the chunks a replayed graph ran
alone."""

from portbench.harness import spans

SPOILERS = ("elfi.graph.record", "elfi.graph.capture", "elfi.chunk.redo")


def read(run):
    if run.trace is None:
        return None
    host = run.trace.host
    chunks = spans.named(host, "elfi.chunk")
    if not chunks:
        return None
    replays = spans.named(host, "elfi.graph.replay")
    spoilers = spans.named(host, *SPOILERS)
    replayed = sum(1 for c in chunks if spans.within(c, replays)
                   and not spans.within(c, spoilers))
    return 100.0 * replayed / len(chunks)
