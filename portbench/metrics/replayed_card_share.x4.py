"""replayed_card_share.x4 (%, program spans): the window's ``elfi.card``
spans that hold an ``elfi.graph.replay`` span and no
``elfi.graph.record`` or ``elfi.graph.capture``, over all its
``elfi.card`` spans: the cards' chunk shares that a replayed graph ran."""

from portbench.harness import spans

SPOILERS = ("elfi.graph.record", "elfi.graph.capture")


def read(run):
    if run.trace is None:
        return None
    host = run.trace.host
    cards = spans.named(host, "elfi.card")
    if not cards:
        return None
    replays = spans.named(host, "elfi.graph.replay")
    spoilers = spans.named(host, *SPOILERS)
    replayed = sum(1 for c in cards if spans.within(c, replays)
                   and not spans.within(c, spoilers))
    return 100.0 * replayed / len(cards)
