"""Minimal DAG substrate for generative models.

Counterpart of :mod:`elfi_tpu.dag`, which is framework-free, so the code
is the same.  The graph is only a *declaration* that the compiler
(:mod:`elfi_tpu_torch.compile.compiler`) walks in a fixed topological
order: named nodes holding state dicts, ordered positional parent edges,
and a deterministic topological sort.
"""

from __future__ import annotations


class DAG:
    """Directed acyclic graph of named nodes with state dicts.

    Edges are stored per-child as an ordered list of parent names, so the
    positional argument order of an operation is the edge order (the
    reference encodes this with integer ``param`` edge attributes,
    ``graphical_model.py:65-90``).
    """

    def __init__(self):
        self.nodes = {}      # name -> state dict
        self._parents = {}   # name -> list of parent names (positional order)
        self._children = {}  # name -> set of child names

    # -- construction ------------------------------------------------------
    def add_node(self, name, state=None):
        if name in self.nodes:
            raise ValueError(f"Node {name!r} already exists")
        self.nodes[name] = dict(state or {})
        self._parents[name] = []
        self._children[name] = set()

    def add_edge(self, parent, child):
        if parent not in self.nodes:
            raise ValueError(f"Unknown parent node {parent!r}")
        if child not in self.nodes:
            raise ValueError(f"Unknown child node {child!r}")
        self._parents[child].append(parent)
        self._children[parent].add(child)
        if self._has_cycle_from(child):
            self._parents[child].pop()
            self._children[parent].discard(child)
            raise ValueError(f"Edge {parent!r}->{child!r} creates a cycle")

    def remove_node(self, name):
        for p in self._parents.pop(name, []):
            self._children.get(p, set()).discard(name)
        for c in list(self._children.pop(name, set())):
            self._parents[c] = [p for p in self._parents[c] if p != name]
        del self.nodes[name]

    def set_parents(self, name, parents):
        """Replace the ordered parent list of ``name``."""
        for p in self._parents[name]:
            self._children[p].discard(name)
        self._parents[name] = []
        for p in parents:
            self.add_edge(p, name)

    # -- queries -----------------------------------------------------------
    def __contains__(self, name):
        return name in self.nodes

    def get_state(self, name):
        return self.nodes[name]

    def update_state(self, name, **kwargs):
        self.nodes[name].update(kwargs)

    def parents(self, name):
        return list(self._parents[name])

    def children(self, name):
        return sorted(self._children[name])

    def ancestors(self, names):
        """All ancestors of ``names`` (inclusive)."""
        seen = set()
        stack = list(names)
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._parents[n])
        return seen

    def topological_order(self, outputs=None):
        """Deterministic topological order (alphabetical tie-break).

        Mirrors the determinism guarantee of the reference executor
        (``elfi/executor.py:162-246``): the order depends only on graph
        structure, never on insertion order.
        """
        include = self.ancestors(outputs) if outputs is not None else set(self.nodes)
        indeg = {n: sum(1 for p in self._parents[n] if p in include)
                 for n in include}
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            changed = False
            for c in self._children[n]:
                if c in include:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        ready.append(c)
                        changed = True
            if changed:
                ready.sort()
        if len(order) != len(include):
            raise ValueError("Graph contains a cycle")
        return order

    def copy(self):
        g = DAG.__new__(DAG)
        g.nodes = {n: dict(s) for n, s in self.nodes.items()}
        g._parents = {n: list(p) for n, p in self._parents.items()}
        g._children = {n: set(c) for n, c in self._children.items()}
        return g

    # -- internal ----------------------------------------------------------
    def _has_cycle_from(self, start):
        seen = set()
        stack = [start]
        while stack:
            n = stack.pop()
            for p in self._parents[n]:
                if p == start:
                    return True
                if p not in seen:
                    seen.add(p)
                    stack.append(p)
        return False
