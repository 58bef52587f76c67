"""ROMC on the card: the deterministic model's solve and regions on CUDA
equal the CPU's, the frozen-noise objective rows repeat on the card, and
the local fit's minimum-norm least squares runs on CUDA where the
features outnumber the samples.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_romc_cuda.py

runs it alone.
"""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods import romc as tromc
from elfi_tpu_torch.models import gnk

torch.set_num_threads(1)

CPU = torch.device("cpu")
DET_OBS = np.array([0.4, 0.1, 0.0], np.float32)
DET_BOUNDS = [(-2.0, 2.0), (-2.0, 2.0)]


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend, and put their own work on the
    card."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check is of the card's run")
    return torch.device("cuda", 0)


def det_model():
    """A simulator that ignores its noise: the objective is the exact
    quadratic ``(a + b/2 - 0.4)^2 + (b - 0.3 a - 0.1)^2``."""
    m = et.Model(name="romc_det")
    et.Prior("uniform", -2, 4, model=m, name="a")
    et.Prior("uniform", -2, 4, model=m, name="b")

    def sim(a, b, batch_size, generator):
        return torch.stack([a + 0.5 * b, b - 0.3 * a, torch.zeros_like(a)],
                           dim=1)

    et.Simulator(sim, m["a"], m["b"], observed=DET_OBS[None], model=m,
                 name="sim")
    et.Distance("euclidean", m["sim"], model=m, name="d")
    return m


def _det_romc(device):
    x0 = np.random.RandomState(0).uniform(-1.5, 1.5, (6, 2)).astype(
        np.float32)
    romc = et.ROMC(det_model()["d"], bounds=DET_BOUNDS, seed=1,
                   device=device)
    romc.solve_problems(n1=6, seed=2,
                        optimizer_args={"x0": x0, "restarts": 1})
    romc.estimate_regions(eps_filter=0.2)
    return romc


@pytest.mark.cuda
def test_det_solve_and_regions_on_the_card_equal_the_cpu(cuda):
    got, want = _det_romc(cuda), _det_romc(CPU)
    assert got._objective.device == cuda
    for pg, pw in zip(got.optim_problems, want.optim_problems):
        np.testing.assert_allclose(pg.result.x_min, pw.result.x_min,
                                   rtol=1e-4)
        np.testing.assert_allclose(pg.result.f_min, pw.result.f_min,
                                   rtol=1e-4, atol=1e-12)
        np.testing.assert_allclose(pg.result.hess_appr, pw.result.hess_appr,
                                   rtol=1e-4)
    assert got.inference_state["accepted"] == \
        want.inference_state["accepted"]
    for rg, rw in zip(got.posterior.regions, want.posterior.regions):
        np.testing.assert_allclose(rg.center, rw.center, rtol=1e-4)
        np.testing.assert_allclose(rg.limits, rw.limits, rtol=1e-4)
    g = np.linspace(-0.4, 0.9, 9)
    pts = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    np.testing.assert_allclose(got.eval_unnorm_posterior(pts),
                               want.eval_unnorm_posterior(pts), rtol=1e-4)
    res = got.sample(n2=20, seed=3)
    assert res.n_samples == 6 * 20 and np.sum(res.weights) > 0


@pytest.mark.cuda
def test_objective_rows_repeat_on_the_card(cuda):
    """The g-and-k objective rows at one seed: the same on every call, one
    row unchanged when another moves, and a gradient on the card."""
    m = gnk.get_model(n_obs=50, seed_obs=1)
    romc = et.ROMC(m["d"], bounds=[(0, 10)] * 4, seed=5, device=cuda)
    romc._define_objectives(n1=16, seed=6)
    obj = romc._objective
    theta = torch.as_tensor(np.random.RandomState(1).uniform(
        0.5, 9.5, (16, 4)).astype(np.float32), device=cuda)
    first = obj(theta)
    assert first.device == cuda and torch.equal(first, obj(theta))
    moved = theta.clone()
    moved[7] = 5.0
    keep = torch.arange(16, device=cuda) != 7
    assert torch.equal(obj(moved)[keep], first[keep])
    with torch.enable_grad():
        t = theta.clone().requires_grad_(True)
        g, = torch.autograd.grad(obj(t).sum(), t)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


@pytest.mark.cuda
def test_min_norm_lstsq_on_the_card(cuda):
    """D = 5: 21 features from 20 samples; the card gives the CPU's
    minimum-norm coefficients."""
    x = np.random.RandomState(2).uniform(-1, 1, (3, 20, 5)).astype(
        np.float32)
    y = (x ** 2).sum(-1) + x[..., 0] * x[..., 3]
    got = tromc._lstsq_min_norm(tromc._quad_features(torch.as_tensor(
        x, device=cuda)), torch.as_tensor(y, device=cuda)).cpu().numpy()
    for i in range(3):
        feats = tromc._quad_features(torch.as_tensor(x[i])).double().numpy()
        want = np.linalg.lstsq(feats, y[i].astype(np.float64), rcond=None)[0]
        np.testing.assert_allclose(got[i], want, rtol=1e-3, atol=1e-4)
