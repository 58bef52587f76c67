"""CUDA graphs of the port's programs and fused loops: the counterpart of
the JAX package's ``jax.jit`` of a per-batch program
(``CompiledProgram.jitted``) and of the fused ``lax.scan`` loops that embed
it.

A function that draws from per-batch streams (:mod:`.rng`) is captured in
three steps:

1. it runs once eagerly under a :class:`Recorder`, which hands out freshly
   seeded generators, as an eager run does, and notes every request:
   (family, batch index relative to the function's first batch, node);
   that run is also the warm-up capture asks for (libraries set up their
   handles and workspaces on the capture stream outside the graph);
2. :class:`Graph` gives every recorded stream one persistent CUDA generator
   registered with the graph and captures the function again, checking
   that it asks for the same streams in the same order;
3. before each replay the host seeds each stream's generator with that
   stream's seed for the replay's batches (host arithmetic only): torch's
   replay prologue writes each registered generator's seed and offset into
   device memory, so a replay draws what freshly seeded generators draw
   eagerly.  A kernel keyed by a stream reads the seed from a small device
   tensor that one copy from a pinned, double-buffered host buffer
   refills before the replay.

So a replay equals the eager run of the same batches bit for bit.  A
stream's seed depends only on (seed, batch, node), as in every other path.

Graphs are captured on one side stream per device (:func:`side_stream`),
and the eager runs that record and warm them up run there too: a kernel's
per-stream state (the cull's plan and scratch) is then made outside the
graph.  A capture that fails raises; nothing falls back to eager on CUDA.

Kernel wrappers count their launches through :func:`count`: ``launches``
(launched by the host), ``captured`` (recorded into a graph) and
``graph_launches`` (launched by replays: a graph's captured count each
replay).  A :class:`Graph` knows its nodes (:attr:`Graph.nodes`, read from
the captured ``cudaGraph_t``).

:func:`run_if` runs work only where a device flag holds: in a graph being
captured, inside a CUDA-graph IF node that the card evaluates at each
replay, with no host read (``csrc/graph_if.cu``, through the CUDA
runtime, since torch may have no API for conditional nodes).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import gc

import numpy as np
import torch

from . import rng
from .profiling import annotate

__all__ = ["Recorder", "Graph", "Replays", "side_stream", "on_side_stream",
           "on_device", "counted", "count", "hold", "enabled", "record",
           "pack_keys", "run_if", "graph_nodes", "CAP"]

#: capture the fused loops and ``CompiledProgram.jitted`` on a CUDA device;
#: False runs them eagerly (to compare the two)
_ENABLED = True

#: the keys a :class:`Replays` keeps by default
CAP = 8

_COUNTED = []
_streams = {}
#: CUDA-graph conditional nodes: torch built with the CUDA 12.4 runtime or
#: later (a body captured into an IF node, :func:`run_if`)
_IF_NODES = torch.version.cuda is not None and tuple(
    int(v) for v in torch.version.cuda.split(".")[:2]) >= (12, 4)
#: the IF nodes captured so far (:attr:`Graph.conditionals`)
_if_nodes = 0
#: the stream that captures IF nodes' bodies, per device index (made by
#: ``csrc/graph_if.cu``, kept for the process)
_body_streams = {}
#: (the memory pool of the graph being captured, its device) while
#: :class:`Graph` captures, and the pool that takes this thread's
#: allocations
_capturing = None
_routed = None
#: what the graph being captured must keep alive (see :func:`hold`)
_held = None


def enabled(device):
    """Whether work on ``device`` is captured."""
    return _ENABLED and torch.device(device).type == "cuda"


def counted(fn):
    """Give a kernel wrapper its launch counts (module docstring)."""
    fn.launches = fn.captured = fn.graph_launches = 0
    _COUNTED.append(fn)
    return fn


def count(fn):
    """One launch of ``fn``'s kernel: recorded into the graph being
    captured on the current stream, or launched by the host."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def hold(obj):
    """Keep ``obj`` alive as long as the graph being captured, if one is:
    device memory a captured kernel uses that its caller may drop (a
    kernel's cached scratch)."""
    if _held is not None:
        _held.append(obj)


@functools.cache
def _if_lib():
    """Build (at first use) and bind ``csrc/graph_if.cu``."""
    from ..ops.kernels import _build
    lib = _build.load("graph_if", ("graph_if.cu",))
    lib.elfi_if_begin.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_void_p)] * 2
    lib.elfi_if_begin.restype = ctypes.c_int
    lib.elfi_if_end.argtypes = [ctypes.c_void_p] * 3
    lib.elfi_if_end.restype = ctypes.c_int
    lib.elfi_if_stream.argtypes = [ctypes.c_int]
    lib.elfi_if_stream.restype = ctypes.c_void_p
    lib.elfi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.elfi_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _libcuda():
    """``libcuda``, for ``cuGraphGetNodes``."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def graph_nodes(graph):
    """The nodes of a ``torch.cuda.CUDAGraph`` made with ``keep_graph=True``
    and captured, counted in its ``cudaGraph_t`` (an IF node is one node:
    its body's are not counted)."""
    n = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                    None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return int(n.value)


def _if_call(entry, *args):
    """``entry`` of ``csrc/graph_if.cu`` called; raises on a CUDA error."""
    from ..ops.kernels import _build
    lib = _if_lib()
    _build.raise_on(getattr(lib, entry)(*args), lib, entry)


def _route_to_pool():
    """From now to the end of the capture, this thread's allocations on
    the capture's device go to the graph's private pool: torch routes a
    capture's allocations by its capture id, and a stream that captures an
    IF node's body has its own."""
    global _routed
    pool, device = _capturing
    if _routed == pool:
        return
    torch._C._cuda_endAllocateToPool(device, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(device, pool)
    # the second begin counted one more user of the pool, which the
    # graph's end would not release
    torch._C._cuda_releasePool(device, pool)
    _routed = pool


def _body_stream(device):
    """The stream that captures IF nodes' bodies on ``device``."""
    stream = _body_streams.get(device)
    if stream is None:
        made = _if_lib().elfi_if_stream(device)
        if not made:
            raise RuntimeError(f"no stream for IF nodes' bodies on "
                               f"cuda:{device}")
        stream = _body_streams[device] = torch.cuda.ExternalStream(
            made, device=device)
    return stream


def run_if(pred, body):
    """``body()`` where ``pred()``, a 0-d bool tensor, holds.

    While :class:`Graph` captures on a CUDA device, ``body`` is captured
    into an IF node of the graph: each replay evaluates the predicate on
    the card and runs or skips the body there.  Tensors that the graph
    reads after the body must be written in place (the graph reads fixed
    addresses), and a body may hold further :func:`run_if` calls (nested
    nodes).  Where the running CUDA has no conditional nodes the body is
    captured unconditionally (and ``pred`` not called), so it must change
    nothing where the predicate is false.  Outside a capture the predicate
    is read on the host."""
    global _if_nodes
    if _capturing is None:
        with annotate("elfi.host_read"):
            holds = bool(pred())
        if holds:
            body()
        return
    if not _IF_NODES:
        body()
        return
    flag = pred()
    if flag.dtype != torch.bool or flag.numel() != 1:
        raise ValueError(f"run_if takes a one-element bool predicate, got "
                         f"{flag.dtype} of shape {tuple(flag.shape)}")
    _route_to_pool()
    device = _capturing[1]
    inner = _body_stream(device)
    outer = torch.cuda.current_stream(device)
    # inside a body (the body stream's own node): the enclosing body's
    # capture, resumed after the node
    enclosing, node = ctypes.c_void_p(), ctypes.c_void_p()
    _if_call("elfi_if_begin", outer.cuda_stream, flag.data_ptr(),
             inner.cuda_stream, ctypes.byref(enclosing), ctypes.byref(node))
    try:
        with torch.cuda.stream(inner):
            body()
    finally:
        _if_call("elfi_if_end", inner.cuda_stream, enclosing, node)
    _if_nodes += 1


def side_stream(device):
    """The stream on which ``device``'s graphs are captured."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _streams.get(index)
    if s is None:
        s = _streams[index] = torch.cuda.Stream(index)
    return s


def on_device(device):
    """Context manager: ``device`` is the current CUDA device inside (where
    a graph is captured and replayed, and where its events are recorded);
    nothing for another device."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


class on_side_stream:
    """Context manager: the work inside runs on :func:`side_stream`, after
    the work queued before it on the current stream, and the current
    stream waits for it at the end."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.outer = torch.cuda.current_stream(self.device)
        self.side = side_stream(self.device)
        self.side.wait_stream(self.outer)
        self.ctx = torch.cuda.stream(self.side)
        self.ctx.__enter__()
        return self.side

    def __exit__(self, *exc):
        self.ctx.__exit__(*exc)
        self.outer.wait_stream(self.side)


class Recorder:
    """Stream source of an eager run that is to be captured: generators
    seeded as eagerly, each request noted relative to batch ``start``."""

    def __init__(self, start=0):
        self.start = int(start)
        self.slots = []

    def request(self, family, base, batch_index, uid, device):
        self.slots.append((family, int(batch_index) - self.start, uid))
        return rng.generator(rng.derive(family, base, batch_index, uid),
                             device)

    def key(self, generator):
        return None


def record(fn, start):
    """``fn()`` run eagerly under a :class:`Recorder`; returns (its
    result, the recorder)."""
    rec = Recorder(start)
    with rng.stream_source(rec):
        return fn(), rec


class _Replayer:
    """Stream source during capture: the graph's generators, in the order
    the recorded run asked for its streams."""

    def __init__(self, graph, start):
        self.graph, self.start, self.i, self.slot_of = graph, start, 0, {}

    def request(self, family, base, batch_index, uid, device):
        g = self.graph
        want = (family, int(batch_index) - self.start, uid)
        had = g.slots[self.i] if self.i < len(g.slots) else None
        if had != want:
            raise RuntimeError(
                f"capture asked for stream {want} where its recorded run "
                f"asked for {had}: the function's streams depend on more "
                "than its batches")
        if g.bases.setdefault(family, base) != base:
            raise RuntimeError(
                f"a captured function draws {family!r} streams under two "
                "bases; a replay re-keys each family by one")
        gen = g.gens[self.i]
        self.slot_of[id(gen)] = self.i
        self.i += 1
        return gen

    def key(self, generator):
        i = self.slot_of.get(id(generator))
        if i is None:
            raise RuntimeError(
                "a kernel in a graph being captured was keyed by a generator "
                "that is not one of the graph's streams: its seed would be "
                "fixed in the graph")
        self.graph.need_keys = True
        return self.graph.keys[i:i + 1]


def pack_keys(seeds):
    """64-bit unsigned seeds as the int64 words a kernel reads (the same
    bits)."""
    return np.array(seeds, dtype=np.uint64).view(np.int64)


class Graph:
    """``fn()`` captured on the current stream (a side stream) as a CUDA
    graph whose streams are those ``recorder`` noted, relative to batch
    ``start``.  ``persistent`` generators are registered too and never
    re-seeded: their offsets advance across replays as they do eagerly.
    :meth:`replay` returns ``fn``'s result, the graph's static outputs."""

    def __init__(self, fn, recorder, start, device, persistent=()):
        device = torch.device(device)
        if torch.cuda.current_stream(device) == \
                torch.cuda.default_stream(device):
            raise RuntimeError("capture on a side stream (on_side_stream)")
        self.slots = list(recorder.slots)
        self.bases = {}
        self.need_keys = False
        self.gens = [torch.Generator(device=device) for _ in self.slots]
        self.keys = torch.zeros(max(len(self.slots), 1), dtype=torch.int64,
                                device=device)
        # a capture cannot give the allocator's cached blocks back to the
        # card, so where they hold it the capture runs out of memory: give
        # them back first, as torch.cuda.graph does
        torch.cuda.empty_cache()
        # kept until its nodes are counted, then instantiated
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in (*self.gens, *persistent):
            graph.register_generator_state(g)
        before = [f.captured for f in _COUNTED]
        if_nodes = _if_nodes
        source = _Replayer(self, int(start))
        global _held, _capturing, _routed
        self.held = _held = []
        # the graph's own pool, named, so that a body of an IF node can
        # allocate from it too (:func:`run_if`)
        pool = torch.cuda.graph_pool_handle()
        _capturing = (pool, device.index if device.index is not None
                      else torch.cuda.current_device())
        # no garbage collection inside the capture: a collected graph's
        # pool would be released while the stream is captured
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            graph.capture_begin(pool=pool)
            try:
                with rng.stream_source(source):
                    self.out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:    # the capture is invalid already
                    pass
                raise
            graph.capture_end()
        finally:
            _held = _capturing = _routed = None
            if gc_was_on:
                gc.enable()
        if source.i != len(self.slots):
            raise RuntimeError(
                f"capture asked for {source.i} streams, its recorded run "
                f"for {len(self.slots)}")
        #: the graph's nodes (:func:`graph_nodes`)
        self.nodes = graph_nodes(graph)
        graph.instantiate()
        self.graph = graph
        # what the graph reads stays alive with it
        self.fn = fn
        self.kernels = [(f, f.captured - b)
                        for f, b in zip(_COUNTED, before) if f.captured != b]
        #: the IF nodes captured into the graph (:func:`run_if`)
        self.conditionals = _if_nodes - if_nodes
        self.replays = 0
        if self.need_keys:
            self._pinned = torch.empty((2, len(self.slots)),
                                       dtype=torch.int64, pin_memory=True)
            self._events = [None, None]

    def seeds(self, bases, start):
        """Every stream's seed for a replay at batch ``start``."""
        return [rng.derive(f, bases[f], start + rel, uid)
                for f, rel, uid in self.slots]

    def replay(self, bases, start):
        seeds = self.seeds(bases, int(start))
        for g, s in zip(self.gens, seeds):
            g.manual_seed(s)
        if self.need_keys:
            j = self.replays % 2
            copied = self._events[j]
            if copied is not None and not copied.query():
                # wait until the copy two replays ago has read this buffer
                with annotate("elfi.host_read"):
                    copied.synchronize()
            self._pinned[j].numpy()[:] = pack_keys(seeds)
            self.keys[:len(seeds)].copy_(self._pinned[j], non_blocking=True)
            self._events[j] = torch.cuda.Event()
            self._events[j].record()
        self.graph.replay()
        for f, k in self.kernels:
            f.graph_launches += k
        self.replays += 1
        return self.out


class Replays:
    """Graphs of one function of a carried state, by key: the first call
    with a key runs eagerly and is recorded, the second captures a graph
    and replays it, later calls replay it.  The caller runs all of them on
    :func:`on_side_stream`.  At most ``cap`` keys are kept, the least
    recently used dropped first.  A kept graph holds its private memory
    pool: scripts/torch_capture_ab.py --phases memory on an NVIDIA H100
    80GB HBM3 at 700.00 W measured 123 MiB a graph for MA2 rejection's
    kernel graph at 2**21, 232 MiB for the plain graph at 2**17, 44 MiB
    for gauss2d SMC and 2 MiB for a BSL block, with two graphs a program
    on those paths (the first chunk's and the steady one's; one a BSL
    chain), so a cap of 8 bounds a program at about 1.9 GiB.

    Over a device list each card's program (``prog.on(card)``) keeps its
    own graphs, captured on that card, in that card's memory; a key holds
    the card's position in the list.  One card named several times keeps
    the graphs of all its positions in one object, whose cap the chunk
    loop raises to :data:`CAP` times the positions that name it (a
    first-chunk and a steady key each).  MA2 rejection on the kernel
    graph at batch 2**24, four batches a card's share: 8.51 GB of graph
    pools for the eight graphs of one H100 named four times, so about
    2.1 GB a card for its two (NVIDIA H100 80GB HBM3, 700 W).

    ``fn(state, start) -> (new_state, extra)``: ``state`` is a dict of
    tensors, ``new_state`` a dict (what the function carries to the next
    call), ``extra`` anything of tensors.  A graph holds static copies of
    ``state`` and writes the keys of ``new_state`` that ``state`` has back
    into them; the others are its outputs.  :meth:`__call__` returns the
    new state (static tensors that the graph's next replay overwrites)
    and ``extra``.  With ``snapshot`` a graph also returns, second, a copy
    of the state it started from, taken inside it (the eager call's input
    is left as it is, and is returned there).  ``key`` must fix every
    shape the function sees, and every tensor it reads that the caller
    may replace (a graph reads the tensors it was captured with).

    Each call is one span (:func:`.profiling.annotate`) named by the
    branch it takes: ``elfi.graph.record``, ``elfi.graph.capture`` (the
    capture and its first replay) or ``elfi.graph.replay``."""

    def __init__(self, cap=CAP):
        self.entries = collections.OrderedDict()
        self.buffers = {}
        #: what callers learn from a first eager call (shapes)
        self.memo = {}
        self.cap = cap
        self.captures = 0
        self.replays = 0
        self.eager = 0

    def buffer(self, name, shape, dtype, device):
        """A tensor kept with these graphs under ``name``: an input that
        they read and that the caller rewrites between calls (a
        threshold, a proposal's mixture)."""
        b = self.buffers.get(name)
        if b is None:
            b = self.buffers[name] = torch.empty(shape, dtype=dtype,
                                                 device=device)
        return b

    def _put(self, key, entry):
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.cap:
            self.entries.popitem(last=False)

    def __call__(self, key, state, fn, bases, start, device, persistent=(),
                 snapshot=False):
        entry = self.entries.get(key)
        name = "elfi.graph.record" if entry is None else \
            "elfi.graph.capture" if isinstance(entry, Recorder) else \
            "elfi.graph.replay"
        with annotate(name):
            if entry is None:
                (new, extra), rec = record(lambda: fn(state, start), start)
                self._put(key, rec)
                self.eager += 1
                out = {**state, **new}
                return (out, (extra, state)) if snapshot else (out, extra)
            if isinstance(entry, Recorder):
                static = {k: v.clone() for k, v in state.items()}

                def body():
                    snap = {k: v.clone() for k, v in static.items()} \
                        if snapshot else None
                    new, extra = fn(static, start)
                    outs = {}
                    for k, v in new.items():
                        if k in static:
                            static[k].copy_(v)
                        else:
                            outs[k] = v
                    return outs, ((extra, snap) if snapshot else extra)

                entry = (static, Graph(body, entry, start, device, persistent))
                self.captures += 1
            self._put(key, entry)
            static, graph = entry
            for k, v in state.items():
                if v is not static[k]:
                    static[k].copy_(v)
            outs, extra = graph.replay(bases, start)
            self.replays += 1
            return {**static, **outs}, extra
