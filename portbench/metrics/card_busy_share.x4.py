"""card_busy_share.x4 (%, device trace): the summed durations of the
cards' operations in the traced window, over the window's length times
the cell's cards (each card runs one stream at a time)."""


def read(run):
    if run.trace is None:
        return None
    view = run.trace
    busy_ns = sum(min(e, view.t1) - s for _, s, e in view.ops)
    return 100.0 * busy_ns * 1e-9 / (run.cell.chips * view.window_s)
