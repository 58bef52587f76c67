"""Interval arithmetic over the program's own spans, which the metric
readers of ``program_span`` metrics share.

The port marks its fused loops with spans named ``elfi.*``
(``elfi_tpu_torch.utils.profiling.annotate``), host records of the
profiler on the clock of the card's records; a traced window's
``TraceView.host`` holds them as (name, start, end) in ns.  A program
without them (an older port) leaves every reader here with nothing to
read: the readers then return None.
"""

from __future__ import annotations

import bisect

from .trace import _union

#: the prefix of the program's span names
PREFIX = "elfi."
#: host records of the profiler's own work (CUPTI's buffers), as the
#: trace names them (the ledger writes them with ``_`` for the spaces)
PROFILER = ("Activity Buffer Request", "Buffer Flush")
OUTSIDE = "outside any elfi.* span"
IN_PROFILER = "inside profiler records"


def named(host, *names):
    """(start, end) of the records of ``host`` named any of ``names``,
    sorted."""
    return sorted((s, e) for n, s, e in host if n in names)


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


#: total length of the union of (start, end) intervals
length = _union


def within(outer, spans):
    """The (start, end) of ``spans`` (sorted) that lie inside ``outer``."""
    s0, e0 = outer
    i = bisect.bisect_left(spans, (s0, s0))
    out = []
    while i < len(spans) and spans[i][0] <= e0:
        if spans[i][1] <= e0:
            out.append(spans[i])
        i += 1
    return out


def has_spans(host):
    """Whether the window holds any of the program's spans."""
    return any(n.startswith(PREFIX) for n, _, _ in host)


def _profiler(name):
    return name.replace("_", " ") in PROFILER


def subtract(a, b):
    """The union of ``a`` less that of ``b``, as sorted disjoint
    intervals."""
    out, b, j = [], merged(b), 0
    for s, e in merged(a):
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, t = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > t:
                out.append((t, b[k][0]))
            t = max(t, b[k][1])
            k += 1
        if t < e:
            out.append((t, e))
    return out


def idle_intervals(view):
    """The intervals inside the benchmark's call spans in which no
    operation ran on the card.  ``view`` is a ``TraceView``."""
    return subtract(view.calls, ((s, e) for _, s, e in view.ops))


def idle_split(view):
    """The card's idle ns inside the benchmark's call spans, by (what the
    host was in at each idle instant, the innermost other host record
    open then or None).  What the host was in: ``inside profiler
    records`` where one of :data:`PROFILER` was open, else the innermost
    ``elfi.*`` span open (the one that started last), else ``outside any
    elfi.* span``.  ``view`` is a ``TraceView``."""
    marks = []
    for iv in idle_intervals(view):
        marks += [(iv[0], 1, "idle", None), (iv[1], -1, "idle", None)]
    for n, s, e in view.host:
        kind = "profiler" if _profiler(n) else \
            "span" if n.startswith(PREFIX) else "record"
        marks += [(s, 1, kind, (s, e, n)), (e, -1, kind, (s, e, n))]
    # at one instant, what opens comes first: a record of no length opens
    # before it closes
    marks.sort(key=lambda m: (m[0], -m[1]))
    out = {}
    depth = {"idle": 0, "profiler": 0}
    open_ = {"span": [], "record": []}

    def innermost(records):
        return max(records, key=lambda r: (r[0], -r[1]))[2] if records \
            else None

    last = None
    for t, step, kind, rec in marks:
        if last is not None and t > last and depth["idle"] > 0:
            if depth["profiler"] > 0:
                where = IN_PROFILER
            else:
                where = innermost(open_["span"]) or OUTSIDE
            key = (where, innermost(open_["record"]))
            out[key] = out.get(key, 0) + (t - last)
        last = t
        if kind in open_:
            if step > 0:
                open_[kind].append(rec)
            else:
                open_[kind].remove(rec)
        else:
            depth[kind] += step
    return out


def by_span(split):
    """An :func:`idle_split` summed over the other host records."""
    out = {}
    for (where, _), ns in split.items():
        out[where] = out.get(where, 0) + ns
    return out
