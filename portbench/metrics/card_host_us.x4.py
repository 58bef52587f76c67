"""card_host_us.x4 (us, program spans): the host's cost of feeding one
card one chunk, the mean over the window's ``elfi.card`` spans of each
one's length less the ``elfi.host_read`` spans inside it (a replay's
wait for its keys' copy two chunks back, which lasts as long as the
card's work queued before it)."""

from portbench.harness import spans


def read(run):
    if run.trace is None:
        return None
    host = run.trace.host
    cards = spans.named(host, "elfi.card")
    if not cards:
        return None
    reads = spans.named(host, "elfi.host_read")
    return 1e-3 * spans.length(spans.subtract(cards, reads)) / len(cards)
