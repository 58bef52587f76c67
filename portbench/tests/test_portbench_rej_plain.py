"""The cells ``lorenz-rej-plain`` and ``ma2-rej-plain``: the Lorenz-96
configuration's data, its reference's equations and counts, and both
cells' agreement with the port on the CPU at a small size and their
bfloat16 control, which has to fail."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.counts import lorenz as counts
from portbench.harness.cells import Benchmark
from portbench.harness.runner import Record, judge
from portbench.reference import lorenz as ref

# one intra-op thread: a Lorenz-96 batch is thousands of small operations,
# and pools of threads in each of several test processes fight over them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("lorenz-rej-plain", "ma2-rej-plain")
#: the calls a test run makes: MA(2) as the other rejection cells' tests
#: make them; Lorenz-96 at its 40 sites and 160 steps with the batch cut,
#: one chunk a call
SMALL = {"ma2": dict(batch_size=1024, n_sim=1 << 14, n_samples=100,
                     check_calls=2),
         "lorenz": dict(batch_size=256, n_sim=1 << 12, n_samples=100,
                        check_calls=2)}


def small_cell(name):
    cell = Benchmark(ROOT).cell(name)
    cell.traffic.update(SMALL[cell.config_name])
    return cell


@pytest.fixture
def cpu_client():
    import elfi_tpu_torch as et
    et.set_client("native", device="cpu")
    yield et
    et.reset_client()


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name, cpu_client):
    cell = small_cell(name)
    calls = cell.driver()
    d = calls.Driver(cell, "cpu")
    records = []
    for s in (11, 2**33 + 7):
        out = d.call(s)
        records.append(Record(s, 0.0, 0.0, out.pop("sims"),
                              out.pop("batches"), out))
    checks, failed = judge(calls.check(cell, records, 5, "cpu"),
                           cell.limits)
    assert failed == 0, checks
    assert checks["theta_gap"][0] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = small_cell(name)
    for seed in (1, 2**31 + 11):
        readings = cell.driver().control(cell, seed, "cpu")
        _, failed = judge([readings], cell.limits)
        assert failed == 1, readings


def test_the_configuration_holds_the_jax_packages_trajectory():
    """The observed trajectory is the JAX package's draw at ``seed_obs`` 0
    with the published settings, element for element, its first row the
    initial state; nothing is cut."""
    c = Benchmark(ROOT).cell("lorenz-rej-plain").config
    key = (f"f={float(c['f'])};n_obs={c['n_obs']};"
           f"n_timestep={c['n_timestep']};phi={c['phi']};"
           f"seed_obs={c['seed_obs']};"
           f"total_duration={float(c['total_duration'])};"
           f"true_params={c['true_params']}")
    data = np.load(ROOT / "elfi_tpu_torch" / "models" / "data"
                   / "lorenz_observed.npz")
    observed = np.asarray(c["observed"], np.float32)
    assert observed.shape == (160, 40)
    assert np.array_equal(observed, data[key])
    assert np.array_equal(np.asarray(c["initial_state"], np.float32),
                          observed[0])
    assert (c["n_obs"], c["n_timestep"], c["total_duration"], c["f"],
            c["phi"], c["true_params"]) == (40, 160, 4, 10.0, 0.984,
                                            [2.0, 0.1])
    assert c["priors"] == {"theta1": [0.5, 3.0], "theta2": [0.0, 0.3]}
    assert c["reduced"] == [] and c["assumed"] == {}


def test_the_reference_steps_by_its_equations():
    """One RK4 step of the reference against the step written out site by
    site on a ring of 5, and its summaries against numpy's, in float64."""
    g = torch.Generator().manual_seed(3)
    y = torch.randn((2, 5), generator=g, dtype=torch.float64)
    eta = torch.randn((2, 5), generator=g, dtype=torch.float64)
    t1 = torch.tensor([[1.5], [2.0]], dtype=torch.float64)
    t2 = torch.tensor([[0.1], [0.2]], dtype=torch.float64)

    def f(v):
        out = torch.empty_like(v)
        for k in range(5):
            out[:, k] = (-v[:, (k - 2) % 5] * v[:, (k - 1) % 5]
                         + v[:, (k - 1) % 5] * v[:, (k + 1) % 5] - v[:, k]
                         + 10.0 - (t1[:, 0] + t2[:, 0] * v[:, k])
                         + eta[:, k])
        return out

    dt = 0.025
    a = f(y)
    b = f(y + dt / 2 * a)
    c = f(y + dt / 2 * b)
    d = f(y + dt * c)
    want = y + dt / 6 * (a + 2 * b + 2 * c + d)
    got = ref.rk4_step(y, dt, eta, t1, t2, 10.0, ref.neighbours(5, "cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)

    x = np.random.default_rng(0).standard_normal((3, 7, 5))
    c = x - x.mean(axis=1, keepdims=True)
    a, b = x[:, :-1], x[:, 1:]
    ca, cb = a - a.mean(1, keepdims=True), b - b.mean(1, keepdims=True)
    want = np.stack([
        x.mean(axis=(1, 2)), x.var(axis=1).mean(axis=1),
        (ca * cb).mean(axis=(1, 2)),
        (c * np.roll(c, -1, axis=2)).mean(axis=(1, 2)),
        (ca * np.roll(cb, 1, axis=2)).mean(axis=(1, 2)),
        (ca * np.roll(cb, -1, axis=2)).mean(axis=(1, 2))], axis=1)
    np.testing.assert_allclose(ref.summaries(torch.as_tensor(x)).numpy(),
                               want, rtol=1e-12)


def test_the_counts_of_a_step_by_hand():
    c = Benchmark(ROOT).cell("lorenz-rej-plain").config
    shapes = {k: c[k] for k in ("n_obs", "n_timestep")}
    assert counts.sim_ops(c) == counts.sim_ops(shapes)
    # a site a step: a normal (6); the noise, phi eta + sqrt(1 - phi^2) e
    # (3); four tendencies, each -a b + b c (3), less y, plus F, less
    # theta1 + theta2 y (2 + 1), plus eta: 9; the stages scaled by the
    # step (4); y + k1 / 2, y + k2 / 2, y + k3 (5); k1 + 2 k2 + 2 k3 + k4
    # (5); the sixth and the sum with y (2)
    site = 6 + 3 + 4 * 9 + 4 + 5 + 5 + 2
    assert counts.step_ops(shapes) == 40 * site == 2440
    summaries = 160 * 40 * 11 + 3 * 159 * 40 * 6
    assert counts.sim_ops(shapes) == 2 * 4 + 159 * 2440 + summaries + 18


@pytest.mark.parametrize("module", ["portbench.reference.lorenz",
                                    "portbench.counts.lorenz"])
def test_the_new_files_import_nothing_of_the_program(module):
    code = (f"import sys; import {module}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert not loaded & {"jax", "jaxlib", "flax", "elfi_tpu",
                         "elfi_tpu_torch"}
