"""The plain reference: its streams, its agreement with the port on the
CPU at a small size, the control that has to fail, and what it and the
benchmark import."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness.cells import Benchmark
from portbench.harness.runner import judge
from portbench.reference import select, streams

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "elfi_tpu"}
CELLS = ("ma2-rej-k1", "gnk-rej-k2", "gnk-rej-plain", "ma2-smc")
#: sizes a test run holds, the cell's traffic otherwise
SMALL = {"rejection": dict(batch_size=1024, n_sim=1 << 14, n_samples=100,
                           check_calls=2),
         "smc": dict(batch_size=500, n_samples=100, check_calls=2)}


def small_cell(name):
    cell = Benchmark(ROOT).cell(name)
    cell.traffic.update(SMALL[cell.traffic["kind"]])
    return cell


@pytest.fixture
def cpu_client():
    import elfi_tpu_torch as et
    et.set_client("native", device="cpu")
    yield et
    et.reset_client()


def test_philox_known_answers():
    # Random123's known-answer vectors of Philox4x32-10
    zero = torch.zeros(1, dtype=torch.int64)
    words = streams.philox_words(0, zero, zero)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]


def test_philox_counter_layout():
    # counter (sim low, sim high, block, 0): a simulation index past 2^32
    # reaches the second word
    sims = torch.tensor([5, 5 + (1 << 32)], dtype=torch.int64)
    blocks = torch.tensor([0, 1], dtype=torch.int64)
    w = streams.philox_words(77, sims, blocks)
    assert w[0].shape == (2, 2)
    assert int(w[0][0, 0]) != int(w[0][1, 0])
    assert int(w[0][0, 0]) != int(w[0][0, 1])


def test_philox_normals_are_normal():
    z = streams.philox_normals(123456789, 4096, 102, "cpu")
    assert z.shape == (4096, 102)
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 1.0) < 0.01
    assert float(z.abs().max()) <= np.sqrt(-2 * np.log(2.0**-24)) + 1e-5


def test_stream_seeds_match_the_documented_scheme():
    # splitmix64 of 0 is the published first output of a zero-seeded
    # splitmix64 generator
    assert streams.mix(0) == 0xE220A8397B1DCDAF
    # CRC-32's published check value, its top bit cleared
    assert streams.node_uid("123456789") == 0xCBF43926 & 0x7FFFFFFF
    assert streams.stream_seed(3, 1, "t1") != streams.stream_seed(3, 2, "t1")


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name, cpu_client):
    cell = small_cell(name)
    driver = cell.driver()
    d = driver.Driver(cell, "cpu")
    from portbench.harness.runner import Record
    records = [Record(s, 0.0, 0.0, 0, 0, out)
               for s in (11, 2**33 + 7)
               for out in [d.call(s)]]
    for r in records:
        r.sims = r.out.pop("sims")
        r.batches = r.out.pop("batches")
    checks, failed = judge(driver.check(cell, records, 5, "cpu"),
                           cell.limits)
    assert failed == 0, checks
    assert checks["theta_gap"][0] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = small_cell(name)
    for seed in (1, 2, 2**31 + 11):
        readings = cell.driver().control(cell, seed, "cpu")
        _, failed = judge([readings], cell.limits)
        assert failed == 1, readings


def test_compare_finds_a_dropped_and_an_altered_row():
    g = torch.Generator().manual_seed(0)
    theta = torch.rand((4000, 2), generator=g)
    d = torch.rand(4000, generator=g)
    ref = select.TopRows(200 + select.MARGIN)
    ref.add(theta, d)
    good = select.compare(ref.theta[:200], ref.d[:200], ref, 200, (1, 1))
    assert good == {"theta_gap": 0.0, "dist_gap": 0.0, "rows_missed": 0.0}
    dropped = torch.cat([ref.theta[1:201]]), torch.cat([ref.d[1:201]])
    assert select.compare(*dropped, ref, 200, (1, 1))["rows_missed"] == 1
    theta2 = ref.theta[:200].clone()
    theta2[3, 0] += 0.01
    assert select.compare(theta2, ref.d[:200], ref, 200,
                          (1, 1))["theta_gap"] > 1e-4


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _top_level_imports(path) & BANNED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "elfi_tpu_torch" not in _top_level_imports(path), path
    code = ("import sys\n"
            "import portbench.reference.ma2, portbench.reference.gnk, "
            "portbench.reference.smc, portbench.reference.select\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert not set(out.stdout.split()) & (BANNED | {"elfi_tpu_torch"})


def test_a_run_loads_no_jax_module():
    """A whole run of a cell on the CPU, in a process of its own: what it
    leaves in ``sys.modules``, compared by whole top-level names
    (``elfi_tpu_torch`` is not ``elfi_tpu``)."""
    code = (
        "import sys, time\n"
        "t0 = time.perf_counter()\n"
        "import elfi_tpu_torch as et\n"
        "et.set_client('native', device='cpu')\n"
        "from portbench.harness.cells import Benchmark\n"
        "from portbench.harness.runner import run_cell\n"
        "cell = Benchmark().cell('ma2-rej-k1')\n"
        "cell.traffic.update(batch_size=256, n_sim=1024, n_samples=20,\n"
        "                    check_calls=1)\n"
        "run_cell(cell, 3, 0.01, False, 'cpu', t0, log=lambda *a: None)\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert "elfi_tpu_torch" in loaded
    assert not loaded & BANNED


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("ma2-rej-k1", "gnk-rej-k2"))
def test_the_reference_streams_match_the_kernels_on_the_card(name):
    """On the card a distance kernel draws from its own Philox stream: the
    reference's normals give the kernel's distances to rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import elfi_tpu_torch as et
    cell = small_cell(name)
    cell.traffic.update(batch_size=1 << 16, n_sim=1 << 18, n_samples=500)
    d = cell.driver().Driver(cell, "cuda")
    out = d.call(12345)
    et.reset_client()
    from portbench.calls.rejection import compare_call
    nums = compare_call(cell, 12345, out["theta"], out["d"], "cuda")
    _, failed = judge([nums], cell.limits)
    assert failed == 0, nums
