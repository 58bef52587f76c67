"""The host executor and the zoo's event loops on the card: a CUDA
program's host nodes get numpy copies of their parents (moved off the card)
and their outputs come back to the card; daycare and Lotka-Volterra on the
card equal the CPU on the same injected draws; XLA's order of summation
(``utils/xla_math.py``) holds on the card, and daycare's observed states
generated there are the JAX package's committed array.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_zoo_cuda.py

runs it alone.
"""

import numpy as np
import pytest
import scipy.stats as ss
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.models import daycare, lotka_volterra
from elfi_tpu_torch.utils import xla_math

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
        pytest.skip("needs a CUDA device: the check is of the card's run")
    return torch.device("cuda", 0)


def _mixed_model():
    """A scipy prior (host), a torch simulator (device), a host summary and
    a device distance."""
    m = et.Model(name="mixed_cuda")
    et.Prior(ss.norm(1.0, 0.5), model=m, name="mu")
    seen = {}

    def sim(mu, batch_size=1, generator=None):
        seen["sim"] = (type(mu), mu.device.type, generator.device.type)
        return mu[:, None] + torch.randn((batch_size, 8), generator=generator,
                                         device=generator.device)

    def host_mean(x):
        seen["S"] = type(x)
        return x.mean(1)

    et.Simulator(sim, m["mu"], observed=np.full(8, 1.2, np.float32),
                 model=m, name="sim")
    et.Summary(host_mean, m["sim"], host=True, model=m, name="S")
    et.Distance("euclidean", m["S"], model=m, name="d")
    return m, seen


@pytest.mark.cuda
def test_host_executor_on_a_cuda_program(cuda):
    m, seen = _mixed_model()
    prog = compile_program(m, ("mu", "sim", "S", "d"), device=cuda)
    assert prog.host
    out = prog.run(3, 0, {}, batch_size=64)
    assert seen["sim"] == (torch.Tensor, "cuda", "cuda")
    assert seen["S"] is np.ndarray
    for k in ("mu", "sim", "S", "d"):
        assert out[k].device.type == "cuda", k
    cpu = compile_program(m, ("mu", "sim", "S", "d"), device="cpu").run(
        3, 0, {}, batch_size=64)
    # the host draws are the same numpy draws on either device
    np.testing.assert_array_equal(out["mu"].cpu().numpy(),
                                  cpu["mu"].numpy())
    np.testing.assert_allclose(out["S"].cpu().numpy(),
                               out["sim"].mean(1).cpu().numpy(), rtol=1e-5)
    res = et.Rejection(m["d"], batch_size=256, seed=1, device=cuda).sample(
        64, n_sim=4096, bar=False)
    assert abs(float(np.mean(res.samples["mu"])) - 1.2) < 0.2
    gen = m.generate(16, outputs=["S"], seed=2, device=cuda)
    assert gen["S"].shape == (16,)


def _replay(E, U, device):
    def step_noise(s, k):
        return E[s:s + k].to(device), U[s:s + k].to(device)
    return step_noise


@pytest.mark.cuda
def test_daycare_on_the_card_equals_the_cpu(cuda):
    b, n_dcc = 16, 4
    g = torch.Generator().manual_seed(0)
    E = torch.empty((4096, b, n_dcc)).exponential_(generator=g)
    U = torch.rand((4096, b, n_dcc), generator=g)
    params = [torch.linspace(lo, hi, b) for lo, hi in
              ((1.0, 9.0), (0.2, 1.5), (0.05, 0.9))]
    kw = dict(n_dcc=n_dcc, n_ind=12, n_strains=6, n_obs=8, time_end=1.0,
              check_every=32)
    want = daycare.daycare_from_noise(*params, _replay(E, U, "cpu"), **kw)
    got = daycare.daycare_from_noise(*[p.to(cuda) for p in params],
                                     _replay(E, U, cuda), **kw)
    assert got.device.type == "cuda"
    assert daycare.last_run["steps"] < 4096
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert want.sum() > 0


@pytest.mark.cuda
def test_lotka_volterra_on_the_card_equals_the_cpu(cuda):
    b, n_obs = 32, 12
    g = torch.Generator().manual_seed(1)
    E = torch.empty((8192, b)).exponential_(generator=g)
    U = torch.rand((8192, b), generator=g)
    r1 = torch.linspace(0.5, 1.5, b)
    r2 = torch.linspace(0.003, 0.02, b)
    r3 = torch.linspace(0.3, 1.0, b)
    prey, pred = torch.full((b,), 50.0), torch.full((b,), 100.0)
    noise = torch.randn((b, n_obs, 2), generator=g)
    kw = dict(n_obs=n_obs, time_end=2.0, check_every=16)
    want = lotka_volterra.lotka_volterra_from_noise(
        r1, r2, r3, prey, pred, 0.5, _replay(E, U, "cpu"), noise, **kw)
    got = lotka_volterra.lotka_volterra_from_noise(
        *[x.to(cuda) for x in (r1, r2, r3, prey, pred)], 0.5,
        _replay(E, U, cuda), noise.to(cuda), **kw)
    assert lotka_volterra.last_run["steps"] < 8192
    # the same float32 ops on either device; division and the where-chain
    # round alike, so the trajectories agree to the last bits
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_zoo_simulators_run_on_the_card(cuda):
    from elfi_tpu_torch.models import ar1, toad
    for mod, kw in ((ar1, {}), (toad, dict(n_toads=10, n_days=20))):
        m = mod.get_model(seed_obs=3, **kw)
        res = et.Rejection(m["d"], batch_size=512, seed=3, device=cuda) \
            .sample(16, n_sim=1024, bar=False)
        assert np.all(np.isfinite(res.samples_array))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [
    ((459, 116), 0), ((29, 4, 459), 2), ((2, 29, 33, 27), 3), ((1749,), 0),
    ((1, 1749), 1)])
def test_running_sums_on_the_card_are_in_order(cuda, shape, dim):
    """Each running sum is taken in index order, one rounding an add, as
    numpy's float32 accumulate takes it (torch's own CUDA scan of an
    innermost dimension is a tree)."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(5)) * 0.37
    want = np.add.accumulate(x.numpy(), axis=dim)
    got = xla_math.running_sum(x.to(cuda), dim)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_daycare_observed_states_on_the_card_are_the_jax_array(cuda):
    from elfi_tpu_torch.models._observed import load_observed_setting
    want = load_observed_setting(
        daycare._DATA, true_params=[3.6, 0.6, 0.1], n_dcc=29, n_ind=53,
        n_strains=33, n_obs=36, time_end=10., seed_obs=None)
    got = daycare.observed_data(device=cuda)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, daycare.observed_data(device="cpu"))
