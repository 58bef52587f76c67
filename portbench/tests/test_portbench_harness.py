"""The harness on the CPU: cells found from files alone, the result line's
keys, the names and units of ``BENCHMARK.json``, the trace's arithmetic,
and a run that finds no card."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import trace as tracing
from portbench.harness.cells import BENCH, Benchmark
from portbench.harness.runner import call_seed, judge, run_cell

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[0-9A-Za-z_][0-9A-Za-z_.-]{0,63}$")
UNIT = re.compile(r"^[0-9A-Za-z_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_benchmark_has_the_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units_keep_to_their_characters():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w[k] for w in SPEC["workloads"]
              for k in ("name", "config", "traffic")]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert LINE.match(text), text
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    bench = Benchmark(ROOT)
    for w in SPEC["workloads"]:
        reported = {m["name"] for m in bench.metrics(w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = bench.metrics(w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_every_name_finds_its_files():
    bench = Benchmark(ROOT)
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.system().build and cell.reference().simulate
        assert cell.counts().sim_ops(cell.config) > 0
        assert cell.driver().check
        assert cell.limits
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.cell(SPEC["workloads"][0]["name"])
                        .reader(m["name"]).read)


def test_a_cell_is_added_by_data_files_alone(tmp_path):
    """A checkout to which a cell was added by its traffic, its limits
    and its entry in ``BENCHMARK.json`` alone: the harness finds it."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "ma2-rej-k1-small", "config": "ma2",
                              "traffic": "rej.kernel.small", "chips": 1,
                              "why": "a smaller call"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads(
        (BENCH / "traffic" / "rej.kernel.2p28.json").read_text())
    traffic.update(n_sim=1 << 20)
    (root / "portbench" / "traffic" / "rej.kernel.small.json").write_text(
        json.dumps(traffic))
    shutil.copy(BENCH / "limits" / "ma2-rej-k1.json",
                root / "portbench" / "limits" / "ma2-rej-k1-small.json")
    cell = Benchmark(root).cell("ma2-rej-k1-small")
    assert cell.traffic["n_sim"] == 1 << 20
    assert cell.config["name"] == "ma2"
    assert cell.driver().__name__ == "portbench.calls.rejection"
    with pytest.raises(KeyError):
        Benchmark(root).cell("no-such-cell")


def test_the_result_line_has_the_contract_keys():
    import elfi_tpu_torch as et
    et.set_client("native", device="cpu")
    try:
        cell = Benchmark(ROOT).cell("ma2-rej-k1")
        cell.traffic.update(batch_size=512, n_sim=4096, n_samples=50,
                            check_calls=1)
        line, checks = run_cell(cell, 2**31 + 99, 0.2, False, "cpu",
                                time.perf_counter(), log=lambda *a: None)
    finally:
        et.reset_client()
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"sims_per_s", "call_ms_p95", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # a CPU run never names itself a card
    assert line["device"]["platform"] == "cpu"
    assert set(checks) == set(cell.limits)


def test_a_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ma2-rej-k1",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_checkout_with_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ma2-rej-k1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""


def test_call_seeds_depend_on_the_seed_and_the_index():
    seeds = {call_seed(2**33 + 1, i) for i in range(100)}
    assert len(seeds) == 100
    assert call_seed(5, 3) == call_seed(5, 3) != call_seed(6, 3)
    assert all(0 <= s < 2**31 for s in seeds)


def test_judge_takes_the_worst_and_counts_the_failed_calls():
    limits = {"a": 1.0, "b": 0.0}
    checks, failed = judge([{"a": 0.5, "b": 0.0}, {"a": 2.0, "b": 0.0},
                            {"a": float("nan"), "b": 0.0}], limits)
    assert checks == {"a": (float("inf"), 1.0), "b": (0.0, 0.0)}
    assert failed == 2
    _, failed = judge([{"a": 0.5}], limits)
    assert failed == 1


class _Event:
    def __init__(self, name, device, start, end, annotation=False):
        self._n, self._d, self._s, self._e = name, device, start, end
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def test_trace_view_arithmetic():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [_Event(tracing.PRIMER, cpu, 0, 50),
          _Event("spin_kernel", cuda, 10, 40),
          _Event(tracing.CALL_SPAN, cpu, 100, 200),
          _Event(tracing.CALL_SPAN, cpu, 200, 400),
          _Event("cudaGraphLaunch", cpu, 105, 106),
          _Event("cudaLaunchKernel", cpu, 210, 211),
          _Event("cudaLaunchKernel", cpu, 230, 231),
          _Event("aten::copy_", cpu, 150, 240),
          _Event("ma2_distance_kernel<false, true>", cuda, 110, 150),
          _Event("cull_merge_kernel", cuda, 140, 160),
          _Event("elementwise", cuda, 250, 300),
          _Event(tracing.CALL_SPAN, cuda, 100, 200, annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    view = tracing.TraceView(prof)
    assert view.window_s == pytest.approx(300e-9)
    assert view.busy_s == pytest.approx(100e-9)
    assert view.launches == 3
    assert view.op_seconds(("ma2_distance_kernel",)) == \
        (pytest.approx(40e-9), 1)
    assert view.call_gaps_s() == [pytest.approx(90e-9)]
    b = view.breakdown()
    assert b["device_ops"][0][0] == "elementwise"
    assert b["idle_gaps"][0] == ["host outside any record",
                                 pytest.approx(100e-9)]
    assert b["idle_gaps"][1][0] == "aten::copy_"


def test_the_port_kernels_are_read_from_its_sources(tmp_path):
    (tmp_path / "a.cu").write_text(
        "template <int N>\n__global__ void __launch_bounds__(kT, f(kR))\n"
        "first_kernel(const float* x) {}\n"
        "__global__ void __cluster_dims__(8, 1, 1)\n"
        "    __launch_bounds__(256, 1) second_kernel(int n) { }\n")
    (tmp_path / "b.cuh").write_text("__global__ void third(float* y) {}\n")
    (tmp_path / "c.txt").write_text("__global__ void not_a_source() {}\n")
    from portbench.harness.readers import kernels_in, port_kernels
    assert kernels_in(tmp_path) == ("first_kernel", "second_kernel",
                                    "third")
    from portbench.harness.readers import CULL, K1, K2
    for name in K1 + K2 + CULL:
        assert any(name in k for k in port_kernels()), name


def test_the_warm_up_ends_with_a_call_that_captures_nothing(monkeypatch):
    from portbench.harness import runner
    counts = iter([(0, 0), (0, 1), (0, 2), (1, 2), (1, 2), (9, 9)])
    monkeypatch.setattr(runner, "graph_counts", lambda: next(counts))
    calls = []

    class Fake:
        def call(self, seed):
            calls.append(seed)

    n = runner.warm_up(Fake(), 5, "cpu", lambda *a: None, 0.0)
    assert n == 4 and len(calls) == 4
    assert len(set(calls)) == 4
