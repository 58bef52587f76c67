"""Profiling and tracing (counterpart of :mod:`elfi_tpu.utils.profiling`).

- :class:`Timers` -- named accumulating wall-clock timers; every
  ``BatchHandler`` keeps one (``submit``/``wait`` phases), inference
  methods can add their own phases.
- :func:`recorded` -- context manager around ``torch.profiler.profile``
  whose recording on a CUDA device starts after a warm-up step, so that it
  keeps every device record.
- :func:`trace` -- :func:`recorded`, then a Chrome trace of the host and
  (on a CUDA device) the device written into ``logdir``.
- :func:`annotate` -- the port's one span primitive: a
  ``torch.profiler.record_function`` while a profiler records, else a
  shared null context, so a span costs a check when nothing records.

The port's spans, all named ``elfi.*`` (one host thread; a span lies
inside the spans open when it starts): ``elfi.sampler.init`` (an
inference method's base built), ``elfi.sample`` (a sampler's call),
``elfi.chunk`` (a chunk of the fused loop) and ``elfi.chunk.redo`` (a
flagged chunk run again eagerly), ``elfi.card`` (one card's share of a
chunk over a list of several devices: its eager batches and merges, or
its graph; one device has no such span),
``elfi.merge_parts`` (the device list's last merge, the copies onto the
first device included), ``elfi.graph.record`` / ``.capture`` /
``.replay`` (a call into :class:`~elfi_tpu_torch.utils.capture.Replays`,
by the branch it takes), ``elfi.proposal`` (an eager SMC batch's
proposal draw), ``elfi.host_read`` (the fused loops waiting on the
device: for a value, or for the copy of a graph's keys two replays ago
where it has not ended), ``elfi.smc.round``, ``elfi.smc.population`` and
``elfi.smc.next_round`` (an SMC round's chunks, its population copied
and weighed, the next round set up), and ``elfi.sim`` (a simulator's call
where it opens one: Lorenz-96's; in eager and recorded runs only, since a
replayed graph runs no Python).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

__all__ = ["Timers", "recorded", "trace", "annotate", "PRIMER_NAME"]


class Timers:
    """Named accumulating wall-clock timers."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self):
        """Dict of {phase: {total_s, calls, mean_s}}."""
        return {k: {"total_s": round(self.total[k], 6),
                    "calls": self.count[k],
                    "mean_s": round(self.total[k] / max(self.count[k], 1),
                                    6)}
                for k in sorted(self.total)}

    def reset(self):
        self.total.clear()
        self.count.clear()

    def __repr__(self):
        lines = [f"{k:>20s}: {v['total_s']:.3f}s over {v['calls']} calls"
                 for k, v in self.report().items()]
        return "Timers(\n  " + "\n  ".join(lines) + "\n)" if lines \
            else "Timers()"


#: seconds :func:`recorded` waits on a CUDA device after its warm-up and at
#: each end of its window.  The profiler keeps a device record only where
#: the card's timestamp falls inside the host's window, and the two were
#: seen up to 28 ms apart after ten minutes of a process on an H100.
_EDGE_S = 0.25
#: empty kernels (``torch.cuda._sleep(1)``) that :func:`recorded` launches
#: first in its recording on a CUDA device, under this annotation
_PRIMER_LAUNCHES = 2000
PRIMER_NAME = "recorded_primer"


@contextlib.contextmanager
def recorded():
    """``torch.profiler.profile`` of the block (the CPU, and CUDA when a
    device is present); yields the profiler.  The recording starts after a
    discarded warm-up step, which on a CUDA device launches a kernel and a
    copy and waits ``_EDGE_S``.  On a CUDA device the card is also
    synchronised at both ends of the block, the window held open
    ``_EDGE_S`` around it, and the recording opens with
    ``_PRIMER_LAUNCHES`` empty kernels under the annotation
    :data:`PRIMER_NAME`: late in a process that has run many kernels and
    CUDA graphs, the profiler loses the device records of the first
    launches it records (up to about 40 on an H100), and the primer's
    absorb that loss.  They are not the block's."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1).cpu()
            torch.cuda.synchronize()
            time.sleep(_EDGE_S)
        prof.step()                     # the warm-up ends, recording starts
        if cuda:
            time.sleep(_EDGE_S)
            with record_function(PRIMER_NAME):
                for _ in range(_PRIMER_LAUNCHES):
                    torch.cuda._sleep(1)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(_EDGE_S)
        prof.step()                     # the recording ends


@contextlib.contextmanager
def trace(logdir="elfi_tpu_torch_trace"):
    """Profile the block through :func:`recorded` and write a Chrome
    trace, ``logdir/trace.json`` (open it in ``chrome://tracing`` or
    Perfetto).  Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    with recorded() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name):
    """A span ``name`` on the profiler's timeline, on the clock of the
    device's records: ``with annotate(name): ...``.  While no profiler
    records it is one shared null context, so a span then costs the
    check alone."""
    return record_function(name) if torch._C._autograd._profiler_enabled() \
        else _NO_SPAN
