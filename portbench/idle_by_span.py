"""Run one cell traced, as ``portbench/run.py --trace 1`` does, then split
the card's idle time inside the calls by the program's span open at each
idle instant, and count the program's spans a call.

    python3 portbench/idle_by_span.py --workload <cell> --seed <n> \
        [--seconds 4] [--spans 100000] [--out <file>]

from the root of a checkout on a machine with the cell's cards.  Standard
output ends with the run's result line, then one JSON object: ``calls``
(the traced window's), ``idle_ms_per_call`` by innermost ``elfi.*`` span
(:func:`portbench.harness.spans.idle_split`; a call is an SMC run in an
SMC cell), ``in_spans`` (the share of the idle time outside the
profiler's own records that lies inside some ``elfi.*`` span),
``idle_top`` (the :data:`TOP` longest (span, innermost other host
record) pairs, ms a call), ``outside_ms_per_call`` (the idle time
outside every span: before a call's first span, between its spans, after
its last), ``spans_per_call`` and ``span_ms_per_call`` by name, and
``span_us``: what one of the program's spans costs the host (``annotate``
around an empty block, the median of five rounds of ``--spans`` spans)
with no profiler recording (``off``) and inside one (``on``).  ``--out``
writes that object to a file too.  A program without the spans reads as
all of its idle time outside them.
"""

import argparse
import bisect
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
#: the (span, innermost host record) pairs the report lists
TOP = 16


def report(view):
    from portbench.harness import spans
    n = len(view.calls)
    split = spans.idle_split(view)
    idle = spans.by_span(split)
    own = sum(ns for k, ns in idle.items() if k != spans.IN_PROFILER)
    inside = sum(ns for k, ns in idle.items()
                 if k not in (spans.IN_PROFILER, spans.OUTSIDE))
    counts, lengths = Counter(), Counter()
    for name, s, e in view.host:
        if name.startswith(spans.PREFIX):
            counts[name] += 1
            lengths[name] += e - s

    # where the idle time outside every span lies in its call
    places = Counter()
    marked = sorted((s, e) for name, s, e in view.host
                    if name.startswith(spans.PREFIX))
    outside = spans.subtract(spans.idle_intervals(view), marked)
    for c0, c1 in view.calls:
        inner = marked[bisect.bisect_left(marked, (c0, c0)):
                       bisect.bisect_left(marked, (c1, c1))]
        first = inner[0][0] if inner else c1
        last = max((e for _, e in inner), default=c1)
        i = max(bisect.bisect_left(outside, (c0, c0)) - 1, 0)
        for s, e in outside[i:bisect.bisect_left(outside, (c1, c1))]:
            s, e = max(s, c0), min(e, c1)
            if s < e:
                place = "before" if e <= first else \
                    "after" if s >= last else "between"
                places[place] += e - s

    def longest(d):
        return sorted(d.items(), key=lambda kv: -kv[1])

    return {"calls": n,
            "idle_ms_per_call": {k: 1e-6 * v / n for k, v in longest(idle)},
            "in_spans": inside / own if own else None,
            "idle_top": [[where, rec, 1e-6 * v / n]
                         for (where, rec), v in longest(split)[:TOP]],
            "outside_ms_per_call": {k: 1e-6 * v / n
                                    for k, v in sorted(places.items())},
            "spans_per_call": {k: c / n for k, c in sorted(counts.items())},
            "span_ms_per_call": {k: 1e-6 * v / n
                                 for k, v in sorted(lengths.items())}}


def span_us(n, rounds=5):
    """Median host us of one ``annotate`` span around an empty block, with
    no profiler recording and inside one."""
    from elfi_tpu_torch.utils import profiling
    from portbench.harness.trace import recorded

    def once():
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("elfi.cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    off = [once() for _ in range(rounds)]
    with recorded():
        on = [once() for _ in range(rounds)]
    return {"off": statistics.median(off), "on": statistics.median(on)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--spans", type=int, default=100_000)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run
    from portbench.harness import trace

    views = []

    class Kept(trace.TraceView):
        def __init__(self, prof):
            super().__init__(prof)
            views.append(self)

    with mock.patch.object(trace, "TraceView", Kept):
        rc = run.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    if rc or not views:
        return rc or 1
    out = dict(workload=args.workload, seed=args.seed, **report(views[0]),
               span_us=span_us(args.spans))
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
