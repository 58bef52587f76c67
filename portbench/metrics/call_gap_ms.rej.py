"""call_gap_ms.rej (ms, device trace): the card's idle time between one
call's last operation and the next call's first, the mean over the pairs of
consecutive calls of the traced window."""


def read(run):
    if run.trace is None:
        return None
    gaps = run.trace.call_gaps_s()
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
