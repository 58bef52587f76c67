"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced against the plain reference, and the result.

The window is a closed loop: one caller runs the cell's calls back to back,
each with a fresh seed made from the run's seed and the call's index, until
``seconds`` have passed; it ends with the last call.  The traced run
(``trace``) runs a shorter window under the profiler (:data:`TRACE_SECONDS`
at the most) and reports the per-layer metrics.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import trace as tracing

#: the longest traced window: the profiler's records of a longer one take
#: minutes to read
TRACE_SECONDS = 4.0
#: spawn keys of the warm-up calls' seeds, apart from the window's
_WARM_KEY = 1 << 30
#: the most warm-up calls a run makes.  The port records a chunk's work
#: the first time it meets the chunk's key, captures it the second time
#: and replays it from then on; a call's first chunk has a key of its own,
#: and the very first call runs it without recording.  So a cell's third
#: call captures the last graph, and its fourth, which records and
#: captures nothing, ends the warm-up
WARMUP_MAX = 8


def call_seed(seed, index):
    """The seed of call ``index`` of a run with ``seed``: 31 bits of
    numpy's SeedSequence over (seed, index)."""
    ss = np.random.SeedSequence(entropy=int(seed), spawn_key=(int(index),))
    return int(ss.generate_state(1, np.uint32)[0] & 0x7FFFFFFF)


@dataclass
class Record:
    """One call of the window: its seed, host clock at both ends, the
    simulations and batches it ran, and what the check reads."""
    seed: int
    start: float
    end: float
    sims: int
    batches: int
    out: dict = field(repr=False)

    @property
    def wall_s(self):
        return self.end - self.start


@dataclass
class Run:
    """What the metric readers read."""
    cell: object
    counts: object
    records: list
    window_s: float
    setup_s: float
    trace: object = None

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic

    @property
    def sims(self):
        return sum(r.sims for r in self.records)

    @property
    def batches(self):
        return sum(r.batches for r in self.records)


def judge(per_call, limits):
    """({number: (the worst reading over the checked calls, its limit)},
    the checked calls of which some number is past its limit or missing).
    A number is past its limit unless it is finite and at most the limit."""
    def ok(name, v):
        return math.isfinite(v) and v <= limits[name]

    def worst(v):
        v = float(v)
        return v if math.isfinite(v) else math.inf

    checks = {k: (max((worst(c[k]) for c in per_call if k in c),
                      default=math.inf), float(limits[k]))
              for k in limits}
    failed = sum(1 for c in per_call
                 if any(k not in c or not ok(k, float(c[k])) for k in limits))
    return checks, failed


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def graph_counts():
    """(graphs captured, chunks recorded eagerly) so far by every
    ``elfi_tpu_torch.utils.capture.Replays`` alive: the program's own
    counters."""
    from elfi_tpu_torch.utils.capture import Replays
    live = [o for o in gc.get_objects() if type(o) is Replays]
    return (sum(r.captures for r in live), sum(r.eager for r in live))


def _cpu_s():
    """This process's CPU seconds, user and system."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def warm_up(driver, seed, device, log, t0):
    """Calls at the cell's own shapes until one records and captures no
    graph (at most :data:`WARMUP_MAX`); returns the number of calls."""
    before = graph_counts()
    for j in range(WARMUP_MAX):
        driver.call(call_seed(seed, _WARM_KEY + j))
        _sync(device)
        after = graph_counts()
        log(f"set-up: warm-up call {j} {time.perf_counter() - t0!r} s "
            f"(cpu {_cpu_s()!r} s), {after[0] - before[0]} captured, "
            f"{after[1] - before[1]} recorded")
        if after == before:
            return j + 1
        before = after
    return WARMUP_MAX


def run_cell(cell, seed, seconds, trace, device, t0, log=None):
    """Run ``cell`` once; returns (the result line's object without its
    ``checks``, the checked numbers as {name: (value, limit)})."""
    import torch
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    log(f"set-up: imports and the card {time.perf_counter() - t0!r} s "
        f"(cpu {_cpu_s()!r} s)")
    driver = cell.driver().Driver(cell, device)
    _sync(device)
    log(f"set-up: the model {time.perf_counter() - t0!r} s "
        f"(cpu {_cpu_s()!r} s)")
    warm_up(driver, seed, device, log, t0)
    graphs = graph_counts()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s!r} s")

    length = min(seconds, TRACE_SECONDS) if trace else seconds
    records = []
    from torch.profiler import record_function
    with (tracing.recorded() if trace else contextlib.nullcontext()) as prof:
        cpu0 = _cpu_s()
        w0 = time.perf_counter()
        while True:
            s = call_seed(seed, len(records))
            span = record_function(tracing.CALL_SPAN) if trace \
                else contextlib.nullcontext()
            with span:
                c0 = time.perf_counter()
                out = driver.call(s)
                c1 = time.perf_counter()
            records.append(Record(s, c0, c1, out.pop("sims"),
                                  out.pop("batches"), out))
            if c1 - w0 >= length:
                break
    window_s = records[-1].end - w0
    window_cpu_s = _cpu_s() - cpu0
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    view = tracing.TraceView(prof) if trace else None
    after = graph_counts()
    walls = sorted(r.wall_s for r in records)
    log(f"window {window_s!r} s, {len(records)} calls, "
        f"{sum(r.sims for r in records)} simulations; "
        f"{after[0] - graphs[0]} graphs captured, {after[1] - graphs[1]} "
        f"chunks recorded; cpu {window_cpu_s!r} s; a call's wall: first "
        f"{records[0].wall_s!r}, median {walls[len(walls) // 2]!r}, "
        f"p95 {walls[int(0.95 * (len(walls) - 1))]!r}, most {walls[-1]!r} s")

    driver.release()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    per_call = cell.driver().check(cell, records, seed, device)
    log(f"check {time.perf_counter() - c0!r} s, {len(per_call)} calls")
    checks, failed = judge(per_call, cell.limits)
    correct = bool(per_call) and failed == 0

    run = Run(cell, cell.counts(), records, window_s, setup_s, view)
    metrics = {}
    for m in cell.bench.metrics(cell.name, trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(memory_peak)}
    line = {"correct": correct, "attempted": len(records),
            "failed": failed, "metrics": metrics, "device": dev}
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        line["breakdown"] = view.breakdown()
    return line, checks
