"""merge_parts_ms.x4 (ms, program spans): the mean over the window's
``elfi.merge_parts`` spans, one a call: the device list's last merge,
the copies of each card's buffer onto the first card included."""

from portbench.harness import spans


def read(run):
    if run.trace is None:
        return None
    merges = spans.named(run.trace.host, "elfi.merge_parts")
    if not merges:
        return None
    return 1e-6 * sum(e - s for s, e in merges) / len(merges)
