"""Cell discovery: everything that belongs to one configuration, traffic
mix, cell or metric sits in files of its own, found by the name that
``BENCHMARK.json`` gives it.  A cell, a configuration, a traffic mix or a
metric is added by adding files; no file here names one.

For a cell ``<w>`` of configuration ``<c>`` and traffic ``<t>``:

- ``BENCHMARK.json``'s configuration entry names ``<c>``'s file (sizes,
  observed data), ``portbench/configs/<c>.json``;
- ``portbench/models/<c>.py``: the system under test, declared through
  the port's DSL (``build(config, graph) -> (model, distance node)``);
- ``portbench/reference/<c>.py``: its plain reference;
- ``portbench/counts/<c>.py``: its operation and byte counts;
- ``portbench/traffic/<t>.json``: the traffic's parameters, whose
  ``kind`` names the driver ``portbench/calls/<kind>.py``;
- ``portbench/limits/<w>.json``: the limit of each number that decides
  the cell's ``correct``;
- ``portbench/metrics/<m>.py``: the reader of metric ``<m>`` (a function
  ``read(run)`` that returns a number, or None where it finds nothing).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def _module(folder, name):
    """The module ``portbench/<folder>/<name>.py``, loaded by its path."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file {path.relative_to(ROOT)}")
    mod_name = f"portbench.{folder}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if name.isidentifier():
        return importlib.import_module(f"portbench.{folder}.{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = _json(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.workloads = {w["name"]: w for w in self.spec["workloads"]}

    def cell(self, name):
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(it has {sorted(self.workloads)})")
        return Cell(self, self.workloads[name])

    def metrics(self, cell_name, trace):
        """The metric entries this cell reports: its end-to-end metrics
        without the trace, its per-layer metrics with it."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell_name in m.get("workloads", [cell_name])]


class Cell:
    """One workload with its configuration, traffic, limits and modules."""

    def __init__(self, bench, entry):
        self.bench = bench
        self.name = entry["name"]
        self.chips = entry["chips"]
        self.config_name = entry["config"]
        self.traffic_name = entry["traffic"]
        cfg = bench.configs[self.config_name]
        self.config = _json(bench.root / cfg["file"])
        here = bench.root / "portbench"
        self.traffic = _json(here / "traffic" / f"{self.traffic_name}.json")
        self.limits = _json(here / "limits" / f"{self.name}.json")

    def system(self):
        return _module("models", self.config_name)

    def reference(self):
        return _module("reference", self.config_name)

    def counts(self):
        return _module("counts", self.config_name)

    def driver(self):
        return _module("calls", self.traffic["kind"])

    @staticmethod
    def reader(metric_name):
        return _module("metrics", metric_name)
