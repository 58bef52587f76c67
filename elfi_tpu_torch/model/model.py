"""Generative model container and node DSL (counterpart of
:mod:`elfi_tpu.model.model`).

Node reference objects write state dicts into a
:class:`~elfi_tpu_torch.dag.DAG`; the compiler then walks the declared graph
in topological order, calling each node's op on batch-first tensors.

RNG: every stochastic node receives a ``torch.Generator`` seeded with its
own 64-bit stream seed, derived from (master seed, batch index, node uid)
by :func:`elfi_tpu_torch.utils.rng.stream_seed` -- the same structure as the
JAX package's ``fold_in(fold_in(key, batch_index), node_uid)``.
"""

from __future__ import annotations

import pickle
import re
import traceback
import zlib

import numpy as np
import torch

from ..dag import DAG
from ..ops import distributions as dists

__all__ = [
    "Model", "ComputationContext", "new_model", "get_default_model",
    "set_default_model", "Constant", "Operation", "RandomVariable", "Prior",
    "Simulator", "Summary", "Discrepancy", "Distance", "AdaptiveDistance",
    "NodeReference", "node_uid", "load_model",
]

_default_model = None


def get_default_model():
    """Return the current default model."""
    global _default_model
    if _default_model is None:
        _default_model = Model()
    return _default_model


def set_default_model(model=None):
    global _default_model
    if model is not None and not isinstance(model, Model):
        raise TypeError("set_default_model expects a Model or None")
    _default_model = model


def new_model(name=None, set_default=True):
    m = Model(name=name)
    if set_default:
        set_default_model(m)
    return m


def node_uid(name):
    """Stable 31-bit id for per-node RNG stream derivation (the JAX
    package's, unchanged)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


class ComputationContext:
    """Per-inference execution bundle: batch size, the integer master seed
    from which every stream seed is derived, an optional output pool
    (:mod:`elfi_tpu_torch.store`) and the submission counter."""

    def __init__(self, batch_size=None, seed=None, pool=None):
        if seed is None or seed == "global":
            # draw from the global numpy state so unseeded runs differ
            seed = int(np.random.randint(0, 2**31 - 1))
        self.batch_size = int(batch_size or 1)
        self.seed = int(seed)
        self.pool = pool
        self.num_submissions = 0
        if pool is not None and hasattr(pool, "set_context"):
            pool.set_context(self)

    def callback(self, batch, batch_index):
        """Store a computed batch into the pool (its pooled names only,
        copied to the host by the pool)."""
        if self.pool is not None:
            self.pool.add_batch(batch, batch_index)

    def copy(self):
        c = ComputationContext(self.batch_size, self.seed, self.pool)
        c.num_submissions = self.num_submissions
        return c


def _to_cpu(x):
    """``x`` with every tensor in it (through dicts, lists and tuples)
    moved to the CPU, so that a pickle made on the card loads without
    one."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    return x


class Model:
    """Container for a generative model."""

    def __init__(self, name=None, observed=None):
        self.name = name or f"model_{np.random.randint(10**6)}"
        self.dag = DAG()
        self.observed = dict(observed or {})

    # -- structure ---------------------------------------------------------
    def __getitem__(self, name):
        if name not in self.dag:
            raise KeyError(f"No node named {name!r} in model {self.name!r}")
        return NodeReference.reference(name, self)

    def __contains__(self, name):
        return name in self.dag

    @property
    def nodes(self):
        return list(self.dag.nodes)

    @property
    def parameter_names(self):
        """Alphabetically sorted parameter node names (deterministic order
        used for flat-array packing)."""
        return sorted(n for n, s in self.dag.nodes.items()
                      if s.get("parameter", False))

    @property
    def observed_node_names(self):
        return sorted(self.observed)

    def update_node(self, name, **state):
        self.dag.update_state(name, **state)
        self._invalidate_cache()

    def remove_node(self, name):
        self.dag.remove_node(name)
        self.observed.pop(name, None)
        self._invalidate_cache()

    # revisions are globally unique so structurally identical model copies
    # can share one compiled-program cache (inference objects copy the model)
    _REVISION_COUNTER = 0

    def copy(self, name=None):
        m = Model.__new__(Model)
        m.name = name or f"{self.name}_copy"
        m.dag = self.dag.copy()
        m.observed = dict(self.observed)
        m._revision = self.revision
        m._program_cache = self.__dict__.setdefault("_program_cache", {})
        return m

    def _invalidate_cache(self):
        Model._REVISION_COUNTER += 1
        self._revision = Model._REVISION_COUNTER

    @property
    def revision(self):
        return getattr(self, "_revision", 0)

    # -- execution ---------------------------------------------------------
    def generate(self, batch_size=1, outputs=None, with_values=None,
                 seed=None, device=None):
        """Compute one batch on ``device`` (None: the global backend's);
        returns a dict of numpy arrays."""
        # imported here: the compiler and the parallel package import this
        # module
        from ..compile.compiler import compile_program
        from ..parallel.backends import resolve_device

        if outputs is None:
            outputs = sorted(self.dag.nodes)
        elif isinstance(outputs, str):
            outputs = [outputs]
        context = ComputationContext(batch_size=batch_size, seed=seed)
        prog = compile_program(self, tuple(outputs),
                               override_names=tuple(sorted(with_values or ())),
                               device=resolve_device(device))
        out = prog.run(context.seed, batch_index=0,
                       overrides=with_values or {},
                       batch_size=context.batch_size)
        return {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in out.items()}

    # -- persistence -------------------------------------------------------
    def save(self, prefix=None):
        """Pickle the model to ``<prefix>/<name>.pkl``; returns the path.
        Its ops must pickle (module-level functions and classes do; a
        lambda or a closure does not)."""
        path = f"{prefix or '.'}/{self.name}.pkl"
        with open(path, "wb") as f:
            pickle.dump(self, f)
        return path

    @classmethod
    def load(cls, name, prefix=None):
        path = name if name.endswith(".pkl") else f"{prefix or '.'}/{name}.pkl"
        with open(path, "rb") as f:
            return pickle.load(f)

    def __getstate__(self):
        """The model without its compiled programs, every tensor in a
        node's state or the observed data moved to the CPU: a model saved
        on the card loads on a machine without one, and its entry points
        resolve the device as usual.  Ops that keep per-device copies drop
        them in their own ``__getstate__``."""
        d = self.__dict__.copy()
        d.pop("_program_cache", None)
        dag = d["dag"].copy()
        for name, state in dag.nodes.items():
            dag.nodes[name] = _to_cpu(state)
        d["dag"] = dag
        d["observed"] = _to_cpu(d["observed"])
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)


def load_model(name, prefix=None, set_default=True):
    """Load a model saved by :meth:`Model.save`."""
    m = Model.load(name, prefix)
    if set_default:
        set_default_model(m)
    return m


# ---------------------------------------------------------------------------
# Node DSL
# ---------------------------------------------------------------------------

_ASSIGN_RE = re.compile(r"^\s*(\w+)\s*=")


def _inspect_name():
    """Best-effort auto-naming from the assignment statement: walk outward
    past all frames of this module to the user's call site."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename == __file__:
            continue
        m = _ASSIGN_RE.match(frame.line or "")
        return m.group(1) if m else None
    return None


class NodeReference:
    """Handle to a node in a :class:`Model`; constructing one writes the
    node's state dict and parent edges into the model DAG."""

    kind = "node"

    def __init__(self, *parents, name=None, model=None, state=None):
        model = model if model is not None else get_default_model()
        if name is None:
            name = _inspect_name()
        if name is None or name in model.dag:
            base = name or f"_{type(self).__name__.lower()}"
            name = f"{base}_{len(model.dag.nodes)}_{np.random.randint(10**6)}"
        state = dict(state or {})
        state.setdefault("kind", self.kind)
        state["_class"] = type(self)
        model.dag.add_node(name, state)
        self.name = name
        self.model = model
        for p in parents:
            pref = p if isinstance(p, NodeReference) else \
                Constant(p, model=model, name=f"_{name}_{len(model.dag.parents(name))}")
            model.dag.add_edge(pref.name, name)
        model._invalidate_cache()

    @classmethod
    def reference(cls, name, model):
        state = model.dag.get_state(name)
        klass = state.get("_class", NodeReference)
        obj = klass.__new__(klass)
        obj.name = name
        obj.model = model
        return obj

    @property
    def state(self):
        return self.model.dag.get_state(self.name)

    @property
    def parents(self):
        return [self.model[p] for p in self.model.dag.parents(self.name)]

    @property
    def uses_meta(self):
        """Whether the node's op receives ``meta=`` (batch index, batch
        size, model name, submission index)."""
        return self.state.get("uses_meta", False)

    @uses_meta.setter
    def uses_meta(self, value):
        self.model.update_node(self.name, uses_meta=bool(value))

    def generate(self, batch_size=1, with_values=None, seed=None,
                 device=None):
        out = self.model.generate(batch_size, outputs=[self.name],
                                  with_values=with_values, seed=seed,
                                  device=device)
        return out[self.name]

    def become(self, other):
        """Replace this node with ``other``'s state and parents in place;
        ``other`` is removed and its observed entry, if any, carried over
        (reference ``elfi_model.py:658-700``)."""
        dag = self.model.dag
        new_parents = dag.parents(other.name)
        dag.nodes[self.name] = dict(dag.nodes[other.name])
        dag.set_parents(self.name, new_parents)
        dag.remove_node(other.name)
        if other.name in self.model.observed:
            self.model.observed[self.name] = \
                self.model.observed.pop(other.name)
        self.model._invalidate_cache()

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"

    def __str__(self):
        return self.name


class Constant(NodeReference):
    """A constant value node."""
    kind = "constant"

    def __init__(self, value, **kwargs):
        super().__init__(state={"value": value}, **kwargs)


class Operation(NodeReference):
    """Deterministic (or explicitly stochastic) operation on parent outputs.

    ``fn(*parents)`` by default; with ``stochastic=True`` it also receives
    ``generator=``, with ``uses_batch_size=True`` also ``batch_size=``, and
    with ``uses_meta=True`` also ``meta=`` (dict with ``batch_index`` etc.).
    ``host=True`` marks a numpy-only function (as does
    :func:`~elfi_tpu_torch.model.tools.mark_host`): its graph then runs
    through the host executor, which hands it numpy copies of its parents
    and ``random_state=`` in place of ``generator=``.
    """
    kind = "operation"

    def __init__(self, fn, *parents, stochastic=False, uses_batch_size=False,
                 uses_meta=False, host=False, **kwargs):
        host = host or getattr(fn, "_elfi_host", False)
        state = {"op": fn, "stochastic": stochastic,
                 "uses_batch_size": uses_batch_size, "uses_meta": uses_meta,
                 "host": host}
        super().__init__(*parents, state=state, **kwargs)


class RandomVariable(NodeReference):
    """Draws from a distribution; parents are distribution parameters."""
    kind = "rv"

    def __init__(self, distribution, *params, size=None, **kwargs):
        if isinstance(distribution, str):
            distribution = dists.from_name(distribution)
        else:
            # scipy (frozen or not) and other random_state-style objects
            # get the host adapter; the port's own pass through
            distribution = dists.wrap_if_foreign(distribution)
        state = {"distribution": distribution, "size": size,
                 "stochastic": True,
                 "host": bool(getattr(distribution, "host", False))}
        super().__init__(*params, state=state, **kwargs)

    @property
    def distribution(self):
        return self.state["distribution"]


class Prior(RandomVariable):
    """A RandomVariable marked as a model parameter."""

    def __init__(self, distribution, *params, size=None, **kwargs):
        super().__init__(distribution, *params, size=size, **kwargs)
        self.model.dag.update_state(self.name, parameter=True)


class Simulator(NodeReference):
    """The stochastic simulator: ``fn(*params, batch_size=B, generator=g)``
    returns a batch-first tensor on ``g``'s device; with ``host=True``,
    ``fn(*numpy_params, batch_size=B, random_state=rs)`` returns numpy."""
    kind = "simulator"

    def __init__(self, fn, *params, observed=None, host=False, **kwargs):
        host = host or getattr(fn, "_elfi_host", False)
        state = {"op": fn, "stochastic": True, "observable": True,
                 "uses_batch_size": True, "host": host}
        super().__init__(*params, state=state, **kwargs)
        if observed is not None:
            self.model.observed[self.name] = np.asarray(observed)

    @property
    def observed(self):
        return self.model.observed.get(self.name)


class Summary(NodeReference):
    """Pure summary statistic ``fn(*parents) -> (batch, ...)``."""
    kind = "summary"

    def __init__(self, fn, *parents, host=False, **kwargs):
        host = host or getattr(fn, "_elfi_host", False)
        state = {"op": fn, "observable": True, "host": host}
        super().__init__(*parents, state=state, **kwargs)


class Discrepancy(NodeReference):
    """Custom discrepancy ``fn(*summaries, observed=tuple) -> (batch,)``."""
    kind = "discrepancy"

    def __init__(self, fn, *parents, host=False, **kwargs):
        host = host or getattr(fn, "_elfi_host", False)
        state = {"op": fn, "uses_observed": True, "host": host}
        super().__init__(*parents, state=state, **kwargs)


class Distance(Discrepancy):
    """Built-in vectorised distance between summary vectors and observed
    (metrics from :mod:`elfi_tpu_torch.ops.distances`).  ``metric`` is a
    name, with ``p``/``w``/``V``/``VI`` as ``scipy.spatial.distance.cdist``
    takes them, or a callable ``metric(u, v) -> (batch,)`` on the
    column-stacked summaries."""

    def __init__(self, metric, *summaries, p=None, w=None, V=None, VI=None,
                 **kwargs):
        from ..ops.distances import CallableDistanceOp, distance_op
        if not summaries:
            raise ValueError("Distance requires at least one summary parent")
        fn = distance_op(metric, p=p, w=w, V=V, VI=VI) \
            if isinstance(metric, str) else CallableDistanceOp(metric)
        super().__init__(fn, *summaries, **kwargs)
        self.model.dag.update_state(self.name, metric=metric)


class AdaptiveDistance(Discrepancy):
    """Euclidean distance with adaptively re-scaled summaries (Prangle
    2017; counterpart of :class:`elfi_tpu.model.model.AdaptiveDistance`).

    The node outputs ``(batch, n_distance_functions)``: one column per
    accumulated weight vector, column 0 unweighted, and inference sorts on
    the LAST column.  Summary standard deviations are estimated per
    adaptation round with Welford's online algorithm, on the host in
    float64 numpy; ``update_distance`` freezes ``w = 1/std`` as a new
    distance function.

    The mutable adaptation state lives in a holder dict SHARED across model
    copies, so an inference method mutating its model copy updates the
    user's node too.  Its ``version`` joins the compiled-program cache key.
    """

    def __init__(self, *summaries, **kwargs):
        from ..ops.distances import adaptive_distance_op
        holder = {}
        super().__init__(adaptive_distance_op(holder), *summaries, **kwargs)
        self.model.dag.update_state(self.name, adaptive=True,
                                    _adaptive_state=holder)
        self.init_state()

    @property
    def adaptive_state(self):
        return self.state["_adaptive_state"]

    def init_state(self):
        st = self.adaptive_state
        st["w"] = [None]
        st.pop("scale", None)
        self._bump_version()
        self.init_adaptation_round()

    def _bump_version(self):
        """The holder is shared across model copies: its version makes
        EVERY copy's programs stale (the revision bump only this one's)."""
        st = self.adaptive_state
        st["version"] = st.get("version", 0) + 1
        self.model._invalidate_cache()

    def init_adaptation_round(self):
        """Reset the Welford accumulators (count, mean, M2) for a new round
        (reference ``elfi_model.py:1095-1102``)."""
        st = self.adaptive_state
        if "w" not in st:
            self.init_state()
            return
        st["count"] = 0
        st["mean"] = 0.0
        st["m2"] = 0.0

    def add_data(self, *data):
        """Welford-update the online std estimate with a batch of summary
        outputs, numpy arrays (reference ``elfi_model.py:1104-1126``)."""
        st = self.adaptive_state
        cols = [np.asarray(d, np.float64) for d in data]
        data2d = np.column_stack(
            [c.reshape(c.shape[0], -1) if c.ndim > 1 else c[:, None]
             for c in cols])
        st["count"] += len(data2d)
        delta1 = data2d - st["mean"]
        st["mean"] = st["mean"] + np.sum(delta1, axis=0) / st["count"]
        delta2 = data2d - st["mean"]
        st["m2"] = st["m2"] + np.sum(delta1 * delta2, axis=0)
        st["scale"] = np.sqrt(st["m2"] / st["count"])

    def update_distance(self):
        """Append a new distance function weighted by 1/std and reset the
        accumulators (reference ``elfi_model.py:1128-1133``)."""
        st = self.adaptive_state
        st["w"].append(1.0 / st["scale"])
        self._bump_version()
        self.init_adaptation_round()
