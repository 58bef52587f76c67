"""BOLFI's device paths on the card: the captured Adam descents (an
acquisition's and the GP restarts') and NUTS step replay the eager runs bit
for bit, the GP ignores a process-wide TF32
setting, and a segment of the fused BO loop never waits for the card.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_bolfi_cuda.py

runs it alone.
"""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.interop import gp_from_numpy
from elfi_tpu_torch.methods import bolfi as bolfi_mod
from elfi_tpu_torch.methods import mcmc
from elfi_tpu_torch.methods.bo.utils import descend
from elfi_tpu_torch.methods.posteriors import BolfiPosterior
from elfi_tpu_torch.models import ma2

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend, and put their own tensors on the
    card."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check is of the card's queue")
    return torch.device("cuda", 0)


def _clustered_gp(device, d=2, n=60):
    """A GP on BO-like evidence (tight clusters of near-duplicate rows)."""
    rng = np.random.RandomState(0)
    centers = rng.rand(3, d)
    X = np.vstack([c + 1e-4 * rng.randn(n // 3, d) for c in centers])
    y = np.sin(5 * X[:, 0]) + np.cos(3 * X[:, -1]) + 0.1 * rng.randn(len(X))
    params = dict(sigma2=0.8, ell=0.3, bias=0.2, noise=0.01,
                  scales=np.ones(d, np.float32))
    return gp_from_numpy(X, y, params, [(0.0, 1.0)] * d, device=device)


@pytest.mark.cuda
def test_captured_descent_equals_eager(cuda):
    gp = _clustered_gp(cuda)
    Xp, mask, L, alpha, params = gp._factor
    Kinv = gp.fns.posterior_inverse(L, mask)
    beta = torch.tensor(3.0, device=cuda)
    lo = torch.zeros(2, device=cuda)
    hi = torch.ones(2, device=cuda)
    starts = torch.rand((10, 2), generator=torch.Generator(cuda).manual_seed(
        1), device=cuda)
    args = (Xp, mask, Kinv, alpha, params, beta)
    eager = descend(gp.fns.neg_lcb_obj_inv, starts, 150, 0.1, lo, hi, args,
                    capture=False)
    for _ in range(2):   # the capture, then a replay
        replay = descend(gp.fns.neg_lcb_obj_inv, starts, 150, 0.1, lo, hi,
                         args, capture=True)
        for a, b in zip(eager, replay):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_captured_gp_restarts_equal_eager(cuda):
    gp = _clustered_gp(cuda)
    Xp, yp, mask = gp._padded()
    u0 = gp._log_param_vector().astype(np.float32)
    starts = torch.as_tensor(np.vstack([u0, u0 + 0.5, u0 - 0.3]).astype(
        np.float32), device=cuda)
    shapes = torch.tensor([0.5, 0.3, 0.1, 0.0], device=cuda)
    lr = torch.tensor(0.1, device=cuda)
    runs = [gp.fns.optimize_restarts_core(starts, Xp, yp, mask, shapes, lr,
                                          steps=60,
                                          const_params=gp._const_params(),
                                          capture=c)
            for c in (False, True, True)]
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)
    assert torch.isfinite(runs[0][1])


@pytest.mark.cuda
def test_captured_nuts_equals_eager(cuda):
    gp = _clustered_gp(cuda)
    post = BolfiPosterior(gp, threshold=-0.5)
    target, args = post.traceable_logpdf_args()
    x0s = np.array([[0.2, 0.3], [0.5, 0.7], [0.8, 0.4]], np.float32)
    runs = [mcmc.nuts_chains(40, x0s, target, seed=3, target_args=args,
                             capture=c) for c in (False, True)]
    assert mcmc.stats["captured"]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.all(np.isfinite(runs[1]))


@pytest.mark.cuda
def test_gp_is_unchanged_with_tf32_on(cuda):
    gp = _clustered_gp(cuda, d=3, n=90)
    grid = np.random.RandomState(1).rand(64, 3)
    mu0, var0 = gp.predict(grid)
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_tf32, torch.get_float32_matmul_precision())
    matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        mu1, var1 = gp.predict(grid)
        gp._refactor()
        mu2, var2 = gp.predict(grid)
        # the guard puts the process's setting back after each call
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    np.testing.assert_array_equal(mu0, mu1)
    np.testing.assert_array_equal(var0, var1)
    np.testing.assert_array_equal(mu0, mu2)
    np.testing.assert_array_equal(var0, var2)
    assert np.all(var0 > 0.5 * gp.params["noise"])


def _sync_guarded(fn):
    """``fn`` run with every synchronisation of the host with the card
    raising an error."""
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


@pytest.mark.cuda
def test_fused_segment_never_waits_for_the_card(cuda, monkeypatch):
    m = ma2.get_model(seed_obs=4)
    et.Operation(torch.log, m["d"], model=m, name="log_d")

    def fit(seed):
        bolfi = et.BOLFI(m["log_d"], batch_size=1, initial_evidence=16,
                         update_interval=8, bounds={"t1": (-2, 2),
                                                    "t2": (-1, 1)},
                         acq_noise_var=0.1, seed=seed, device=cuda)
        bolfi.fit(n_evidence=40, bar=False)
        return bolfi.target_model

    fit(1)      # captures the acquisition descent
    monkeypatch.setattr(bolfi_mod.BOLFI, "_fused_segment",
                        _sync_guarded(bolfi_mod.BOLFI._fused_segment))
    gp = fit(2)
    assert gp.n_evidence == 40
    assert np.all(np.isfinite(gp.X)) and np.all(np.isfinite(gp.Y))
    assert gp._factor[0].device == cuda
