"""DAG -> per-batch program (counterpart of :mod:`elfi_tpu.compile.compiler`).

The declared model is topologically sorted once into a function

    ``fn(seed, batch_index, overrides) -> {output: (batch, ...) tensor}``

that calls every needed node's op in order on the program's device.  There
is no tracing: PyTorch runs eagerly, and on a CUDA device every op is an
asynchronous launch, so calling ``fn`` does not wait for the device.

- Only ancestors of the requested outputs run, and the walk stops at
  overridden nodes.
- Observed values are computed once per program and kept as tensors on the
  device.
- RNG: a stochastic node gets ``generator=``, a ``torch.Generator`` on the
  device seeded with ``stream_seed(seed, batch_index, node_uid(name))``
  (:func:`elfi_tpu_torch.utils.rng.node_generator`).  An op that keys its
  own stream (the MA2 and g-and-k kernels) takes
  :func:`~elfi_tpu_torch.utils.rng.stream_key` of it: that 64-bit integer,
  or inside a CUDA graph a device tensor holding it.
- :meth:`CompiledProgram.jitted` is the per-batch function compiled: on a
  CUDA device it replays a CUDA graph of it (:mod:`elfi_tpu_torch.utils.
  capture`), equal to the eager call bit for bit; :meth:`CompiledProgram.
  run` goes through it.  Capture is opt-in: a program is captured only if
  every node it computes is a constant, a prior whose distribution is
  marked ``capturable = True``, or an op so marked (or a partial of one)
  that does not take ``meta``.  The mark says that the op draws only
  through its ``generator`` (or :func:`~elfi_tpu_torch.utils.rng.
  stream_key` of it), never reads the device back and copies nothing from
  the host in a call.  Any other program (an op that seeds a generator of
  its own from ``generator.initial_seed()``, as ``vectorize_traced`` does,
  a host node, a user's op not yet checked) runs eagerly.

Graphs with ``host=True`` nodes (external simulators, numpy-only ops,
scipy priors) run through :meth:`CompiledProgram.run_host`: the same walk,
in which every other node still runs on the program's device and each host
node gets numpy copies of its parents and a ``numpy.random.RandomState``
seeded from its stream seed
(:func:`~elfi_tpu_torch.ops.distributions.host_seed`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..model.model import node_uid
from ..ops.distributions import host_seed
from ..utils import capture, to_numpy, to_tensor
from ..utils.rng import generator, node_generator, stream_seed

__all__ = ["compile_program", "CompiledProgram"]


def _adaptive_versions(model):
    """(name, version) of every adaptive-distance holder in the model: part
    of every program cache key, because the holders are SHARED across model
    copies and mutate without bumping this copy's revision."""
    return tuple(sorted(
        (n, st["_adaptive_state"].get("version", 0))
        for n, st in model.dag.nodes.items() if st.get("adaptive")))


def _marked(obj):
    """Whether ``obj`` (an op, a partial of one, or a distribution) is
    marked ``capturable = True``."""
    return bool(getattr(obj, "capturable", getattr(
        getattr(obj, "func", None), "capturable", False)))


def _node_capturable(state):
    """Whether a node's computation may be captured (module docstring)."""
    kind = state["kind"]
    if kind == "constant":
        return True
    if kind == "rv":
        return _marked(state["distribution"])
    return not state.get("uses_meta") and _marked(state.get("op"))


def compile_program(model, outputs, override_names=(), *, device):
    """Return a (cached) :class:`CompiledProgram` for ``outputs`` of
    ``model`` on ``device`` with the given set of overridable node names.
    The caller names the device: the entry points resolve a default once."""
    outputs = tuple(outputs)
    override_names = tuple(sorted(override_names))
    device = torch.device(device)
    cache = model.__dict__.setdefault("_program_cache", {})
    key = (model.revision, outputs, override_names, str(device),
           _adaptive_versions(model))
    if key in cache:
        cache[key] = cache.pop(key)      # LRU: hot entries move to the end
    else:
        cache[key] = CompiledProgram(model, outputs, override_names,
                                     device=device)
        # the cache is shared between a model and its copies: bound its
        # size, evicting the oldest-touched entry and never the new one
        while len(cache) > 64:
            cache.pop(next(k for k in cache if k != key))
    return cache[key]


class CompiledProgram:
    def __init__(self, model, outputs, override_names=(), *, device):
        self.model = model
        self.outputs = tuple(outputs)
        self.override_names = frozenset(override_names)
        self.device = torch.device(device)
        #: the program's identity for caches outside the model (a worker's
        #: programs, the device list's siblings): the adaptive-holder
        #: versions are in it because the model's revision misses them,
        #: and the device is not, so a worker keys its CPU copy by it
        self.cache_key = (model.revision, self.outputs,
                          tuple(sorted(override_names)),
                          _adaptive_versions(model))
        for o in self.outputs:
            if o not in model.dag:
                raise ValueError(f"Unknown output node {o!r}")
        # a typo'd override name would otherwise pass the runtime guards
        # (it IS declared) yet never be consumed
        for o in override_names:
            if o not in model.dag:
                raise ValueError(f"Unknown override node {o!r}")
        # ancestors of outputs, not descending past overridden nodes
        needed, stack = set(), list(self.outputs)
        while stack:
            n = stack.pop()
            if n in needed:
                continue
            needed.add(n)
            if n not in self.override_names:
                stack.extend(model.dag.parents(n))
        self.order = [n for n in model.dag.topological_order(self.outputs)
                      if n in needed]
        self.host = any(model.dag.get_state(n).get("host", False)
                        for n in self.order)
        #: whether :meth:`jitted` can capture the per-batch function
        self.capturable = not self.host and all(
            _node_capturable(model.dag.get_state(n)) for n in self.order
            if n not in self.override_names)
        self._observed = {}
        self._traceables = {}
        self._jitted = {}
        #: the CUDA graphs of the fused loops that run this program (their
        #: chunks), shared by every sampler that runs it
        self.replays = capture.Replays()

    # programs ship to pool and cluster workers: the observed tensors (on
    # the device) and the per-batch closures stay in this process; the
    # model pickles to the CPU without its program cache
    def __getstate__(self):
        d = self.__dict__.copy()
        d["_observed"] = {}
        d["_traceables"] = {}
        d["_jitted"] = {}
        d["replays"] = capture.Replays()
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)

    def on(self, device):
        """This program's outputs and overrides compiled for ``device``
        (this program itself when it is already there): how a worker runs
        a program it was sent on its own CPU, and how the device list
        runs a batch on another device."""
        device = torch.device(device)
        if device == self.device:
            return self
        return compile_program(self.model, self.outputs,
                               tuple(self.override_names), device=device)

    # -- observed subgraph (computed once, kept on the device) ---------------
    def observed_value(self, name):
        """Observed value of an observable node, batch axis of length 1."""
        if name in self._observed:
            return self._observed[name]
        dag = self.model.dag
        st = dag.get_state(name)
        if name in self.model.observed:
            val = to_tensor(self.model.observed[name], self.device)[None]
        elif st["kind"] == "constant":
            val = st["value"]
        elif st["kind"] in ("summary", "operation") and not st.get("stochastic"):
            parents = [self.observed_value(p) for p in dag.parents(name)]
            if st.get("host"):
                val = self._to_device(st["op"](*map(to_numpy, parents)))
            else:
                val = st["op"](*parents)
        else:
            raise ValueError(
                f"Cannot compute observed value for node {name!r}: no "
                f"observed data was given for its simulator ancestors.")
        self._observed[name] = val
        return val

    # -- the per-batch function ----------------------------------------------
    def traceable(self, batch_size):
        """Function ``(seed, batch_index, overrides_dict) -> {output:
        tensor}``, cached per batch size.  Named after the JAX package's
        method; it is what both the batch-at-a-time and the fused paths
        call."""
        cached = self._traceables.get(batch_size)
        if cached is not None:
            return cached
        dag = self.model.dag
        order = self.order
        states = {n: dag.get_state(n) for n in order}
        parent_lists = {n: dag.parents(n) for n in order}
        observed_args = {
            n: tuple(self.observed_value(p) for p in parent_lists[n])
            for n in order if states[n].get("uses_observed")}
        uids = {n: node_uid(n) for n in order}
        model_name = self.model.name
        override_names = self.override_names
        device = self.device

        def fn(seed, batch_index, overrides):
            unknown = set(overrides) - override_names
            if unknown:
                raise ValueError(
                    f"Overrides {sorted(unknown)} were not declared at "
                    f"compile time (declared: {sorted(override_names)}); "
                    "undeclared overrides would be silently ignored -- "
                    "compile with override_names including them")
            meta = {"batch_index": batch_index, "batch_size": batch_size,
                    "model_name": model_name, "submission_index": batch_index}

            def gen(name):
                return node_generator(seed, batch_index, uids[name], device)

            vals = {}
            for name in order:
                if name in override_names:
                    v = to_tensor(overrides[name], device)
                    # scalar overrides broadcast over the batch (e.g.
                    # fixed-theta simulation sweeps)
                    vals[name] = v.expand(batch_size) if v.ndim == 0 else v
                    continue
                st = states[name]
                parents = [vals[p] for p in parent_lists[name]]
                kind = st["kind"]
                if kind == "constant":
                    vals[name] = st["value"]
                elif kind == "rv":
                    size = st.get("size")
                    if size:
                        total = batch_size * int(np.prod(size))
                        draw = st["distribution"].rvs(
                            *parents, size=total, generator=gen(name))
                        vals[name] = draw.reshape((batch_size,) + tuple(size))
                    else:
                        vals[name] = st["distribution"].rvs(
                            *parents, size=batch_size, generator=gen(name))
                elif kind == "simulator":
                    vals[name] = st["op"](*parents, batch_size=batch_size,
                                          generator=gen(name))
                elif kind == "discrepancy":
                    vals[name] = st["op"](*parents,
                                          observed=observed_args[name])
                else:  # summary / operation
                    kwargs = {}
                    if st.get("stochastic"):
                        kwargs["generator"] = gen(name)
                    if st.get("uses_batch_size"):
                        kwargs["batch_size"] = batch_size
                    if st.get("uses_meta"):
                        kwargs["meta"] = meta
                    vals[name] = st["op"](*parents, **kwargs)
            return {o: vals[o] for o in self.outputs}

        self._traceables[batch_size] = fn
        return fn

    def jitted(self, batch_size):
        """:meth:`traceable` compiled, the counterpart of the JAX package's
        ``jitted``: a function of the same signature.  On a CUDA device it
        keeps one CUDA graph per override signature (names, shapes,
        dtypes): the first call with a signature runs eagerly and is
        recorded, the second captures the graph, and every call from then
        on copies the overrides into the graph's static inputs, seeds its
        streams for ``(seed, batch_index)`` and replays it.  It returns the
        graph's static outputs, which the next replay overwrites.  On the
        CPU it is :meth:`traceable` itself."""
        if not capture.enabled(self.device):
            return self.traceable(batch_size)
        if not self.capturable:
            raise ValueError(
                "this program cannot be captured: it has a host node, an op "
                "with uses_meta, or a node not marked capturable = True")
        fn = self._jitted.get(batch_size)
        if fn is None:
            fn = self._jitted[batch_size] = _Jitted(
                self.traceable(batch_size), self.device)
        return fn

    # -- host execution (external / numpy simulators) ------------------------
    def _to_device(self, x):
        """A host node's numeric output as a tensor on the program's device
        (float64 becomes float32, as everywhere in the port); anything
        else is passed on as it is."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if isinstance(x, (np.ndarray, np.generic)) and x.dtype.kind in "biuf":
            return to_tensor(np.ascontiguousarray(x), self.device)
        return x

    def run_host(self, seed, batch_index, overrides, batch_size):
        """Run the program eagerly, node by node.  A host node gets numpy
        copies of its parents, moved off the card explicitly, and
        ``random_state=RandomState(host_seed(stream))`` where a device node
        gets ``generator=``; its numpy output goes back to the program's
        device for the nodes after it.  Every output is a tensor on the
        device when it is numeric."""
        dag = self.model.dag
        batch_index = int(batch_index)
        meta = {"batch_index": batch_index, "batch_size": batch_size,
                "model_name": self.model.name,
                "submission_index": batch_index}
        vals = {}
        for name in self.order:
            if name in self.override_names:
                v = to_tensor(overrides[name], self.device)
                # scalar overrides broadcast over the batch, as in the
                # per-batch function: host ops index per batch member
                vals[name] = v.expand(batch_size) if v.ndim == 0 else v
                continue
            st = dag.get_state(name)
            kind = st["kind"]
            host = st.get("host", False)
            convert = to_numpy if host else self._to_device
            parents = [convert(vals[p]) for p in dag.parents(name)]
            stream = stream_seed(seed, batch_index, node_uid(name))
            if host:
                rkw = {"random_state": np.random.RandomState(
                    host_seed(stream))}
            else:
                rkw = {"generator": generator(stream, self.device)}
            if kind == "constant":
                vals[name] = st["value"]
            elif kind == "rv":
                dist = st["distribution"]
                size = st.get("size")
                if size:
                    total = batch_size * int(np.prod(size))
                    draw = dist.rvs(*parents, size=total, **rkw)
                    vals[name] = draw.reshape((batch_size,) + tuple(size))
                else:
                    vals[name] = dist.rvs(*parents, size=batch_size, **rkw)
            elif kind in ("simulator", "summary", "operation",
                          "discrepancy"):
                kwargs = {}
                if kind == "simulator" or st.get("stochastic"):
                    kwargs.update(rkw)
                if kind == "simulator" or st.get("uses_batch_size"):
                    kwargs["batch_size"] = batch_size
                if st.get("uses_meta"):
                    kwargs["meta"] = meta
                if kind == "discrepancy":
                    kwargs["observed"] = tuple(
                        convert(self.observed_value(p))
                        for p in dag.parents(name))
                try:
                    vals[name] = st["op"](*parents, **kwargs)
                except Exception as e:
                    raise RuntimeError(
                        f"Executing node {name!r} failed: {e}") from e
            else:
                raise ValueError(f"Unknown node kind {kind!r} at {name!r}")
        return {o: self._to_device(vals[o]) for o in self.outputs}

    # -- entry point -----------------------------------------------------------
    def run(self, seed, batch_index, overrides=None, batch_size=1):
        overrides = dict(overrides or {})
        unknown = set(overrides) - self.override_names
        if unknown:
            raise ValueError(
                f"Overrides {sorted(unknown)} were not declared at compile "
                f"time (declared: {sorted(self.override_names)}); compile "
                "with override_names including them")
        if self.host:
            return self.run_host(seed, batch_index, overrides, batch_size)
        if (capture.enabled(self.device) and self.capturable
                and not any(isinstance(v, torch.Tensor) and v.requires_grad
                            for v in overrides.values())):
            out = self.jitted(batch_size)(seed, int(batch_index), overrides)
            # the graph's outputs are overwritten by its next replay
            return {k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in out.items()}
        return self.traceable(batch_size)(seed, int(batch_index), overrides)


class _Jitted:
    """:meth:`CompiledProgram.jitted` on a CUDA device."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = device
        self.replays = capture.Replays()

    def __call__(self, seed, batch_index, overrides):
        ov = {k: to_tensor(v, self.device) for k, v in overrides.items()}
        key = tuple(sorted((k, tuple(v.shape), v.dtype, v.stride())
                           for k, v in ov.items()))
        fn = self.fn

        def body(state, start):
            return {}, fn(seed, start, state)

        # a replay runs on the current stream; a recorded run and a capture
        # on the capture stream
        entry = self.replays.entries.get(key)
        replay = entry is not None and not isinstance(entry,
                                                      capture.Recorder)
        with contextlib.nullcontext() if replay \
                else capture.on_side_stream(self.device):
            _, out = self.replays(key, ov, body, {"node": seed},
                                  int(batch_index), self.device)
        return out
