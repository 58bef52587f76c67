"""The profiler around a traced window, and what the metrics read from its
records.

:func:`recorded` is a frozen copy of the logic of the port's
``utils.profiling.recorded``: the recording starts after a discarded
warm-up step, the card is synchronised at both ends and the window held
open a quarter of a second around them, and the recording opens with 2,000
empty kernels, since late in a process that has run many kernels and CUDA
graphs the profiler loses the device records of the first launches it
records.  Those primer kernels are not the window's and are left out here.

The benchmark's own spans (:data:`CALL_SPAN`, one around each call) mark
the calls on the same clock as the device's records.
"""

from __future__ import annotations

import bisect
import contextlib
import time

#: the span the benchmark opens around each call of the window
CALL_SPAN = "portbench.call"
#: the annotation of the primer's empty kernels
PRIMER = "portbench.primer"
PRIMER_LAUNCHES = 2000
EDGE_S = 0.25
#: host calls that queue work on the card
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


@contextlib.contextmanager
def recorded():
    """``torch.profiler.profile`` of the CPU and the card around the block;
    yields the profiler."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1).cpu()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        prof.step()                     # the warm-up ends, recording starts
        time.sleep(EDGE_S)
        with record_function(PRIMER):
            for _ in range(PRIMER_LAUNCHES):
                torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        prof.step()                     # the recording ends


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class TraceView:
    """The records of one traced window, on the profiler's clock (ns).

    ``calls``: the (start, end) of each call span; ``ops``: (name, start,
    end) of each kernel, copy and memset that ran on the card inside the
    window; ``launches``: host calls that queued work in the window;
    ``host``: (name, start, end) of the other host records."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
        cpu, dev = [], []
        for e in events:
            start = e.start_ns()
            rec = (e.name(), start, start + e.duration_ns())
            if e.device_type() == DeviceType.CPU:
                cpu.append(rec)
            elif e.device_type() == DeviceType.CUDA \
                    and not e.is_user_annotation():
                dev.append(rec)
        primer_end = max((r[2] for r in cpu if r[0] == PRIMER), default=0)
        self.calls = sorted((s, e) for n, s, e in cpu if n == CALL_SPAN)
        if not self.calls:
            raise RuntimeError("the trace holds no call span")
        self.t0, self.t1 = self.calls[0][0], self.calls[-1][1]
        self.ops = sorted((r for r in dev
                           if r[1] >= max(self.t0, primer_end)
                           and r[1] < self.t1), key=lambda r: r[1])
        self.launches = sum(1 for n, s, _ in cpu
                            if n in LAUNCHES and self.t0 <= s < self.t1)
        self.host = [r for r in cpu if self.t0 <= r[1] < self.t1
                     and r[0] not in (CALL_SPAN, PRIMER)]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self):
        """Seconds in which some operation ran on the card."""
        return _union((s, min(e, self.t1)) for _, s, e in self.ops) * 1e-9

    def op_seconds(self, match):
        """(seconds, count) of the card's operations whose name holds any
        of the strings ``match``."""
        sel = [(s, e) for n, s, e in self.ops if any(m in n for m in match)]
        return sum(e - s for s, e in sel) * 1e-9, len(sel)

    def call_gaps_s(self):
        """Per pair of consecutive calls: the card's idle time between the
        last operation of the one and the first of the next (calls are
        told apart by their spans: an operation belongs to the call in
        whose span it starts)."""
        starts = [s for s, _ in self.calls]
        first, last = {}, {}
        for _, s, e in self.ops:
            i = bisect.bisect_right(starts, s) - 1
            first.setdefault(i, s)
            last[i] = max(last.get(i, e), e)
        return [(first[i + 1] - last[i]) * 1e-9
                for i in range(len(self.calls) - 1)
                if i in last and i + 1 in first]

    def breakdown(self, top=10):
        """The operations that took most of the card's time, and the
        longest idle gaps named by the innermost host record at each."""
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0) + (e - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.t0
        for _, s, e in self.ops:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            around = [r for r in self.host if r[1] <= mid < r[2]]
            name = min(around, key=lambda r: r[2] - r[1])[0] if around \
                else "host outside any record"
            named.append([name[:120], (e - s) * 1e-9])
        return {"device_ops": [[n[:120], t * 1e-9] for n, t in ops],
                "idle_gaps": named}
