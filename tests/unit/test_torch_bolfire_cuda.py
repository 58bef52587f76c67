"""BOLFIRE and the variance acquisitions on the card: a segment of the fused
BOLFIRE fit never waits for the card, the host loop's captured descent
with the prior's cost runs, ``logreg_fit_core`` on the card gives the
CPU's log-ratios, and each variance acquisition, with the MA2 triangle
prior and with a uniform box, runs its captured descent (or its chain) on
the card and acquires a point in the bounds.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_bolfire_cuda.py

runs it alone.
"""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.interop import gp_from_numpy
from elfi_tpu_torch.methods import bolfire as bolfire_mod
from elfi_tpu_torch.methods.bo import acquisition as acq_mod
from elfi_tpu_torch.methods.classifier import logreg_fit_core
from elfi_tpu_torch.models import gnk, ma2

torch.set_num_threads(1)


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
        pytest.skip("needs a CUDA device: the check is of the card's queue")
    return torch.device("cuda", 0)


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
def test_fused_bolfire_segment_never_waits_for_the_card(cuda, monkeypatch):
    m = gnk.get_model(n_obs=50, seed_obs=2)

    def fit(seed):
        bolfire = et.BOLFIRE(m, n_training_data=200,
                             feature_names=["ss_order"],
                             bounds={p: (0.0, 10.0)
                                     for p in m.parameter_names},
                             n_initial_evidence=8, update_interval=3,
                             acq_noise_var=0.25, seed=seed, device=cuda)
        bolfire.fit(n_evidence=16, bar=False)
        return bolfire

    fit(1)      # captures the acquisition descent and the refits
    monkeypatch.setattr(bolfire_mod.BOLFIRE, "_fused_segment",
                        _sync_guarded(bolfire_mod.BOLFIRE._fused_segment))
    bolfire = fit(2)
    gp = bolfire.target_model
    assert gp.n_evidence == 16 and len(bolfire.classifier_attributes) == 16
    assert np.all(np.isfinite(gp.X)) and np.all(np.isfinite(gp.Y))
    assert np.all((gp.X >= 0.0) & (gp.X <= 10.0))
    assert gp._factor[0].device == cuda


@pytest.mark.cuda
def test_bolfire_host_loop_on_the_card(cuda):
    """The host loop's default acquisition adds the uniform prior's
    ``-log`` density to the LCB objective inside its captured descent."""
    m = gnk.get_model(n_obs=50, seed_obs=2)
    bolfire = et.BOLFIRE(m, n_training_data=100, feature_names=["ss_order"],
                         bounds={p: (0.0, 10.0) for p in m.parameter_names},
                         n_initial_evidence=8, seed=5, device=cuda)
    bolfire.fit(n_evidence=11, bar=False, fused=False)
    gp = bolfire.target_model
    assert gp.n_evidence == 11 and np.all(np.isfinite(gp.Y))
    assert np.all((gp.X >= 0.0) & (gp.X <= 10.0))


@pytest.mark.cuda
def test_logreg_core_on_the_card_equals_cpu(cuda):
    """A batch of BOLFIRE-sized problems (2 x 4000 rows of 14 features) on
    the card and on the CPU: full-precision float32 on both, so the
    log-ratios agree to 1e-4."""
    rng = np.random.RandomState(0)
    X = np.concatenate([rng.normal(0.2, 1.0, (2, 2000, 14)),
                        rng.normal(-0.1, 1.3, (2, 2000, 14))], axis=1)
    X = X * np.logspace(0, 6, 14)
    y = np.concatenate([np.ones(2000), -np.ones(2000)])
    Xq = rng.normal(0.0, 1.0, (2, 5, 14)) * np.logspace(0, 6, 14)

    def log_ratios(device):
        w, b, mu, sd = logreg_fit_core(
            torch.as_tensor(X, dtype=torch.float32, device=device),
            torch.as_tensor(np.broadcast_to(y, (2, 4000)).copy(),
                            device=device))
        Xs = (torch.as_tensor(Xq, dtype=torch.float32, device=device)
              - mu[:, None, :]) / sd[:, None, :]
        return (torch.sum(Xs * w[:, None, :], dim=-1)
                + b[:, None]).cpu().numpy()

    np.testing.assert_allclose(log_ratios(cuda), log_ratios("cpu"),
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("prior", ["triangle", "box"])
@pytest.mark.parametrize("cls_name,kw", [
    ("MaxVar", {}), ("RandMaxVar", {"n_samples": 20}), ("ExpIntVar", {})])
def test_variance_acquisition_on_the_card(cuda, cls_name, kw, prior):
    rng = np.random.RandomState(0)
    X = np.column_stack([rng.uniform(-1.5, 1.5, 30),
                         rng.uniform(-0.4, 0.4, 30)])
    y = np.log(0.05 + (X[:, 0] - 0.6) ** 2 + 2 * (X[:, 1] - 0.2) ** 2)
    bounds = [(-2.0, 2.0), (-1.0, 1.0)]
    params = dict(sigma2=1.0, ell=0.3, bias=0.2, noise=0.01,
                  scales=np.array([0.25, 0.5], np.float32))
    gp = gp_from_numpy(X, y, params, bounds, device=cuda)
    gp.parameter_names = ["t1", "t2"]
    if prior == "triangle":
        model = ma2.get_model(seed_obs=4)
    else:
        model = et.Model(name="box")
        et.Prior("uniform", -2, 4, model=model, name="t1")
        et.Prior("uniform", -1, 2, model=model, name="t2")
    prior = et.ModelPrior(model, device=cuda)
    acq = getattr(acq_mod, cls_name)(gp, prior=prior, seed=0, **kw)
    for t in range(2):      # the capture, then a replay
        pts = acq.acquire(1, t=t)
        assert pts.shape == (1, 2) and np.all(np.isfinite(pts))
        for i, (lo, hi) in enumerate(bounds):
            assert lo <= pts[0, i] <= hi
