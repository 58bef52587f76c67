"""The port's model zoo against the JAX package's: every simulator's pure
transform on the JAX package's own noise (redrawn here from the JAX
simulator's keys), ``levy_stable`` on injected (U, W), daycare and
Lotka-Volterra on injected per-step draws that replay the JAX package's
``split(k, 3)`` sequence, every summary and distance on the same arrays,
the committed observed data against the JAX package's draws,
``cell_sim`` for the same ``RandomState``, and BDM for the same seed."""

import os
import shutil
import warnings
from functools import partial

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import ar1 as tar1
from elfi_tpu_torch.models import arch as tarch
from elfi_tpu_torch.models import daycare as tdaycare
from elfi_tpu_torch.models import lorenz as tlorenz
from elfi_tpu_torch.models import lotka_volterra as tlv
from elfi_tpu_torch.models import mg1 as tmg1
from elfi_tpu_torch.models import scratch_assay as tscratch
from elfi_tpu_torch.models import stochastic_volatility as tsv
from elfi_tpu_torch.models import toad as ttoad
from elfi_tpu_torch.ops.distributions import levy_stable

torch.set_num_threads(1)

#: float32 recursions in both packages, a few roundings apart per step
RTOL = 1e-5
#: Lorenz-96 is chaotic: a one-ulp gap of an RK4 step doubles about every
#: 15 steps, from 1e-6 at step 8 to 7e-3 (absolute, on states of about 10)
#: at step 159 on this test's noise; the whole trajectory is held at 3e-2
LORENZ_ATOL = 3e-2


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _t(x):
    return torch.as_tensor(np.array(x))


def _params(rng, lo, hi, n):
    return rng.uniform(lo, hi, n).astype(np.float32)


def test_ar1_on_the_jax_noise_equals_jax():
    import jax
    from elfi_tpu.models import ar1 as jar1
    key = jax.random.key(11)
    phi = _params(np.random.default_rng(0), -1, 1, 32)
    want = np.asarray(jar1.AR1(phi, n_obs=200, batch_size=32, key=key))
    w = jax.random.normal(key, (200, 32))
    got = tar1.AR1_from_noise(_t(phi), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_arch_on_the_jax_noise_equals_jax():
    import jax
    from elfi_tpu.models import arch as jarch
    key = jax.random.key(12)
    rng = np.random.default_rng(1)
    t1, t2 = _params(rng, -1, 1, 32), _params(rng, 0, 1, 32)
    want = np.asarray(jarch.arch(t1, t2, n_obs=100, batch_size=32, key=key))
    k0, k1 = jax.random.split(key)
    e0, xi = jax.random.normal(k0, (32,)), jax.random.normal(k1, (100, 32))
    got = tarch.arch_from_noise(_t(t1), _t(t2), _t(e0), _t(xi)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_mg1_on_the_jax_noise_equals_jax():
    import jax
    from elfi_tpu.models import mg1 as jmg1
    key = jax.random.key(13)
    rng = np.random.default_rng(2)
    t1 = _params(rng, 0, 5, 32)
    t2 = t1 + _params(rng, 0, 5, 32)
    t3 = _params(rng, 0.05, 0.5, 32)
    want = np.asarray(jmg1.MG1(t1, t2, t3, n_obs=50, batch_size=32, key=key))
    k1, k2 = jax.random.split(key)
    E = jax.random.exponential(k1, (50, 32))
    V = jax.random.uniform(k2, (50, 32))
    got = tmg1.MG1_from_noise(_t(t1), _t(t2), _t(t3), _t(E), _t(V)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _jax_levy_noise(key, shape):
    import jax
    import jax.numpy as jnp
    k1, k2 = jax.random.split(key)
    U = jax.random.uniform(k1, shape, minval=-jnp.pi / 2 + 1e-6,
                           maxval=jnp.pi / 2 - 1e-6)
    return U, jax.random.exponential(k2, shape)


@pytest.mark.parametrize("alpha,beta,loc,scale", [
    (1.7, 0.0, 0.0, 1.0), (0.6, 0.5, 1.0, 2.0), (1.3, -0.8, -2.0, 0.5)])
def test_levy_stable_transform_on_injected_noise_equals_jax(alpha, beta, loc,
                                                            scale):
    import jax
    from elfi_tpu.ops.distributions import levy_stable as jlevy
    key = jax.random.key(14)
    want = np.asarray(jlevy.rvs(alpha, beta, loc, scale, size=4096,
                                key=key))
    U, W = _jax_levy_noise(key, (4096,))
    got = levy_stable.transform(_t(U), _t(W), alpha, beta, loc,
                                scale).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_levy_stable_rvs_draws_the_s0_distribution():
    import scipy.stats as ss
    g = torch.Generator().manual_seed(3)
    x = levy_stable.rvs(1.5, 0.0, 0.0, 1.0, size=200_000, generator=g)
    assert x.dtype == torch.float32 and x.shape == (200_000,)
    q = np.quantile(x.numpy(), [0.1, 0.25, 0.5, 0.75, 0.9])
    want = ss.levy_stable.ppf([0.1, 0.25, 0.5, 0.75, 0.9], 1.5, 0.0)
    np.testing.assert_allclose(q, want, atol=0.02)
    U, W = levy_stable.draw((1000,), torch.Generator().manual_seed(4))
    assert float(U.abs().max()) < np.pi / 2 - 1e-6 + 1e-7
    assert float(W.min()) >= 0


def test_svm_on_the_jax_noise_equals_jax():
    import jax
    from elfi_tpu.models import stochastic_volatility as jsv
    key = jax.random.key(15)
    rng = np.random.default_rng(3)
    alpha, beta = _params(rng, 0.6, 1.9, 32), _params(rng, -1, 1, 32)
    fixed = dict(kappa=1, eta=0, mu=0, phi=0.95, sigma=0.2)
    want = np.asarray(jsv.alpha_stochastic_volatility_model(
        alpha, beta, **fixed, n_obs=50, batch_size=32, key=key))
    k1, k2 = jax.random.split(key)
    k0, k1b = jax.random.split(k1)
    z0 = jax.random.normal(k0, (32,))
    ws = jax.random.normal(k1b, (49, 32))
    U, W = _jax_levy_noise(k2, (32, 50))
    got = tsv.svm_from_noise(_t(alpha), _t(beta), _t(z0), _t(ws), _t(U),
                             _t(W), **fixed).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_lorenz_on_the_jax_noise_equals_jax():
    import jax
    from elfi_tpu.models import lorenz as jlorenz
    key = jax.random.key(16)
    rng = np.random.default_rng(4)
    th1, th2 = _params(rng, 0.5, 3.5, 8), _params(rng, 0, 0.3, 8)
    want = np.asarray(jlorenz.forecast_lorenz(th1, th2, batch_size=8,
                                              key=key))
    es = jax.random.normal(key, (159, 8, 40))
    got = tlorenz.forecast_lorenz_from_noise(_t(th1), _t(th2),
                                             _t(es)).numpy()
    assert got.shape == (8, 160, 40)
    # the first steps agree to float32 rounding, the whole trajectory to
    # the stated looser tolerance
    np.testing.assert_allclose(got[:, :20], want[:, :20], rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=LORENZ_ATOL)


def _jax_toad_noise(key, batch_size, n_toads, n_days):
    import jax
    keys = jax.random.split(key, n_days)
    days = {}
    for i in range(1, n_days):
        k1, k2, k3 = jax.random.split(keys[i], 3)
        r = jax.random.uniform(k1, (batch_size, n_toads))
        U, W = _jax_levy_noise(k2, (batch_size, n_toads))
        ref = jax.random.randint(k3, (batch_size, n_toads), 0, max(i, 1))
        days[i] = tuple(_t(a) for a in (r, U, W, ref))
    return days


def test_toad_on_the_jax_noise_equals_jax():
    import jax
    from elfi_tpu.models import toad as jtoad
    key = jax.random.key(17)
    rng = np.random.default_rng(5)
    alpha, gamma = _params(rng, 1.1, 1.9, 6), _params(rng, 5, 60, 6)
    p0 = _params(rng, 0, 0.9, 6)
    want = np.asarray(jtoad.toad(alpha, gamma, p0, n_toads=12, n_days=25,
                                 batch_size=6, key=key))
    days = _jax_toad_noise(key, 6, 12, 25)
    got = ttoad.toad_from_noise(_t(alpha), _t(gamma), _t(p0), 25,
                                days.__getitem__).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


def _jax_lv_draws(key, batch_size, n_steps):
    """Per member, the JAX package's per-step (exponential, uniform): its
    loop splits ``k, k1, k2 = split(k, 3)`` each step from its own key."""
    import jax
    E = np.zeros((n_steps, batch_size), np.float32)
    U = np.zeros((n_steps, batch_size), np.float32)

    @jax.jit
    def run(k):
        def body(k, _):
            k, k1, k2 = jax.random.split(k, 3)
            return k, (jax.random.exponential(k1), jax.random.uniform(k2))
        return jax.lax.scan(body, k, None, length=n_steps)[1]

    for b, k in enumerate(jax.random.split(key, batch_size)):
        e, u = run(k)
        E[:, b], U[:, b] = np.asarray(e), np.asarray(u)
    return E, U


def _replay(E, U):
    def step_noise(s, k):
        assert s + k <= E.shape[0], "more steps than injected draws"
        return _t(E[s:s + k]), _t(U[s:s + k])
    return step_noise


def test_lotka_volterra_on_injected_draws_equals_jax():
    import jax
    from elfi_tpu.models import lotka_volterra as jlv
    key = jax.random.key(18)
    b, n_obs, time_end = 6, 12, 2.0
    r1 = np.array([1.0, 0.8, 1.2, 0.5, 2.0, 1.0], np.float32)
    r2 = np.array([0.005, 0.01, 0.004, 0.02, 0.003, 0.005], np.float32)
    r3 = np.array([0.6, 0.5, 0.8, 0.4, 1.0, 3.0], np.float32)
    prey = np.array([50, 40, 60, 30, 80, 10], np.float32)
    pred = np.array([100, 90, 80, 50, 120, 2], np.float32)
    want = np.asarray(jlv.lotka_volterra(r1, r2, r3, prey, pred, 0.0,
                                         n_obs=n_obs, time_end=time_end,
                                         batch_size=b, key=key))
    E, U = _jax_lv_draws(key, b, 8192)
    got = tlv.lotka_volterra_from_noise(
        _t(r1), _t(r2), _t(r3), _t(prey), _t(pred), 0.0, _replay(E, U),
        torch.zeros((b, n_obs, 2)), n_obs=n_obs, time_end=time_end,
        check_every=16).numpy()
    assert tlv.last_run["steps"] < 8192
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)
    # the last member's predators die out: the rest of its grid is flat
    assert got[-1, -1, 1] == 0


def _jax_daycare_draws(key, batch_size, n_dcc, n_steps):
    """The JAX package's per-step draws: ``k, k1, k2 = split(k, 3)``,
    exponentials from k1 and uniforms from k2, each (batch, n_dcc)."""
    import jax

    @jax.jit
    def run(k):
        def body(k, _):
            k, k1, k2 = jax.random.split(k, 3)
            return k, (jax.random.exponential(k1, (batch_size, n_dcc)),
                       jax.random.uniform(k2, (batch_size, n_dcc, 1))[..., 0])
        return jax.lax.scan(body, k, None, length=n_steps)[1]

    E, U = run(key)
    return np.asarray(E), np.asarray(U)


SMALL_DAYCARE = dict(n_dcc=2, n_ind=8, n_strains=4, n_obs=6, time_end=0.5)


@pytest.mark.parametrize("params", [(3.6, 0.6, 0.1), (8.0, 1.5, 0.7)])
def test_daycare_on_injected_draws_equals_jax(params):
    import jax
    from elfi_tpu.models import daycare as jdc
    key = jax.random.key(19)
    b = 5
    cols = [np.full(b, p, np.float32) for p in params]
    want = np.asarray(jdc.daycare(*cols, batch_size=b, key=key,
                                  **SMALL_DAYCARE))
    E, U = _jax_daycare_draws(key, b, SMALL_DAYCARE["n_dcc"], 1024)
    got = tdaycare.daycare_from_noise(*map(_t, cols), _replay(E, U),
                                      check_every=32,
                                      **SMALL_DAYCARE).numpy()
    assert tdaycare.last_run["steps"] < 1024
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def _arrays(seed, shape, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "positive":
        return rng.gamma(2.0, 3.0, shape).astype(np.float32)
    return rng.normal(0, 2, shape).astype(np.float32)


def _summary_cases():
    from elfi_tpu.models import arch as jarch
    from elfi_tpu.models import lorenz as jlorenz
    from elfi_tpu.models import lotka_volterra as jlv
    from elfi_tpu.models import mg1 as jmg1
    from elfi_tpu.models import stochastic_volatility as jsv
    q = np.linspace(0, 1, 12)[1:-1]
    series = _arrays(0, (64, 100))
    traj = _arrays(1, (8, 30, 40))
    stock = _arrays(2, (16, 20, 2), "positive")
    cases = [
        (tarch.sample_mean, jarch.sample_mean, series),
        (tarch.sample_variance, jarch.sample_variance, series),
        (partial(tarch.autocorr, lag=3), partial(jarch.autocorr, lag=3),
         series),
        (partial(tarch.pairwise_autocorr, lag_i=1, lag_j=4),
         partial(jarch.pairwise_autocorr, lag_i=1, lag_j=4), series),
        (partial(tmg1.quantiles, q=q), partial(jmg1.quantiles, q=q),
         _arrays(3, (64, 50), "positive")),
        (tmg1.log_identity, jmg1.log_identity,
         _arrays(4, (64, 10), "positive")),
        (tsv.kurt, jsv.kurt, series), (tsv.skew, jsv.skew, series),
        (tlorenz.mean, jlorenz.mean, traj), (tlorenz.var, jlorenz.var, traj),
        (tlorenz.cov, jlorenz.cov, traj),
        (tlorenz.autocov, jlorenz.autocov, traj),
        (partial(tlorenz.xcov, prev=True), partial(jlorenz.xcov, prev=True),
         traj),
        (partial(tlorenz.xcov, prev=False),
         partial(jlorenz.xcov, prev=False), traj),
        (tlv.stock_crosscorr, jlv.stock_crosscorr, stock)]
    for species in (0, 1):
        cases += [
            (partial(tlv.stock_mean, species=species),
             partial(jlv.stock_mean, species=species), stock),
            (partial(tlv.stock_log_variance, species=species),
             partial(jlv.stock_log_variance, species=species), stock),
            (partial(tlv.stock_autocorr, species=species, lag=2),
             partial(jlv.stock_autocorr, species=species, lag=2), stock)]
    return cases


def test_scan_model_summaries_equal_jax():
    import jax.numpy as jnp
    for tfn, jfn, x in _summary_cases():
        want = np.asarray(jfn(jnp.asarray(x)))
        got = tfn(_t(x)).numpy()
        assert got.shape == want.shape, (tfn, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5,
                                   err_msg=str(tfn))


@pytest.mark.parametrize("lag", [1, 2, 4, 8])
def test_toad_summaries_equal_jax(lag):
    import jax.numpy as jnp
    from elfi_tpu.models import toad as jtoad
    rng = np.random.default_rng(lag)
    X = np.cumsum(rng.standard_cauchy((6, 30, 12)) * 8, axis=1).astype(
        np.float32)
    X[0] = 0.0                # every displacement returns: NaN quantiles
    X[1, :, :] = X[1, :1, :]  # likewise
    want = np.asarray(jtoad.compute_summaries(jnp.asarray(X), lag))
    got = ttoad.compute_summaries(_t(X), lag).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(ttoad.obs_mat_to_deltax(_t(X), lag).numpy(),
                                  np.asarray(jtoad.obs_mat_to_deltax(
                                      jnp.asarray(X), lag)))


def test_daycare_summaries_and_distance_equal_jax():
    import jax.numpy as jnp
    from elfi_tpu.models import daycare as jdc
    rng = np.random.default_rng(7)
    data = (rng.uniform(size=(10, 5, 9, 7)) < 0.15).astype(np.float32)
    data[0] = 0.0
    obs = (rng.uniform(size=(1, 5, 9, 7)) < 0.15).astype(np.float32)
    fns = ("ss_shannon", "ss_strains", "ss_prevalence",
           "ss_prevalence_multi")
    sims, obss = [], []
    for name in fns:
        want = np.asarray(getattr(jdc, name)(jnp.asarray(data)))
        got = getattr(tdaycare, name)(_t(data)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6,
                                   err_msg=name)
        sims.append((got, want))
        obss.append((getattr(tdaycare, name)(_t(obs)).numpy(),
                     np.asarray(getattr(jdc, name)(jnp.asarray(obs)))))
    want = np.asarray(jdc.distance(*[w for _, w in sims],
                                   observed=[w for _, w in obss]))
    got = tdaycare.distance(*[_t(g) for g, _ in sims],
                            observed=[_t(g) for g, _ in obss]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_scratch_assay_summaries_equal_jax():
    from elfi_tpu.models import scratch_assay as jscratch
    x = (np.random.default_rng(8).uniform(size=(3, 6, 7, 5)) < 0.4) * 1.0
    np.testing.assert_array_equal(tscratch.cell_summaries(x),
                                  jscratch.cell_summaries(x))


def test_cell_sim_is_bit_equal_for_the_same_random_state():
    from elfi_tpu.models import scratch_assay as jscratch
    kw = dict(init_params=[8, 8, 10, 3], obs_period=2, obs_interval=1,
              tau=1 / 2)
    for seed in (0, 3):
        want = jscratch.cell_sim(0.4, 0.1, random_state=np.random.RandomState(
            seed), **kw)
        got = tscratch.cell_sim(0.4, 0.1, random_state=np.random.RandomState(
            seed), **kw)
        np.testing.assert_array_equal(got, want)
    m = tscratch.get_model(seed_obs=3, **kw)
    jm = jscratch.get_model(seed_obs=3, **kw)
    np.testing.assert_array_equal(m.observed["sim"], jm.observed["sim"])


_OBSERVED = [
    ("ar1", dict(seed_obs=3), "AR1"), ("ar1", dict(), "AR1"),
    ("arch", dict(seed_obs=3), "Y"), ("mg1", dict(seed_obs=3), "MG1"),
    ("stochastic_volatility", dict(), "a_svm"),
    ("lorenz", dict(seed_obs=3, n_timestep=40), "Lorenz"),
    ("toad", dict(seed_obs=3, n_toads=10, n_days=20), "toad"),
    ("lotka_volterra", dict(n_obs=8, seed_obs=3, time_end=5.), "LV"),
    ("daycare", dict(seed_obs=3, **SMALL_DAYCARE), "DCC"),
    ("daycare", dict(), "DCC")]


#: the settings that key each model's committed arrays
_DEFAULTS = {
    "ar1": dict(n_obs=200, true_params=[.9]),
    "arch": dict(n_obs=100, true_params=[0.3, 0.7]),
    "mg1": dict(n_obs=50, true_params=[1., 5., 0.2]),
    "stochastic_volatility": dict(n_obs=50, true_params=[1.2, .5]),
    "lorenz": dict(true_params=[2.0, 0.1], n_obs=40, f=10., phi=0.984,
                   total_duration=4.0, n_timestep=160),
    "toad": dict(true_params=[1.7, 35.0, 0.6], n_toads=66, n_days=63),
    "lotka_volterra": dict(n_obs=50, time_end=30.,
                           true_params=[1.0, 0.005, 0.6, 50, 100, 0.]),
    "daycare": dict(true_params=[3.6, 0.6, 0.1], n_dcc=29, n_ind=53,
                    n_strains=33, n_obs=36, time_end=10.)}


#: how close the port's generated data come to the JAX package's
#: (test_torch_zoo_observed.py): 0 is equality, a float an rtol of the
#: array's largest magnitude, ("atol", x) an absolute tolerance
_GENERATED_TOL = {"ar1": 1e-6, "arch": 1e-5, "mg1": 1e-5,
                  "stochastic_volatility": 1e-5, "toad": 1e-5,
                  "lorenz": ("atol", 1e-2), "lotka_volterra": 0,
                  "daycare": 0}


@pytest.mark.parametrize("name,kw,node", _OBSERVED)
def test_committed_observed_data_equal_the_jax_draws(name, kw, node):
    """The committed arrays are the JAX package's draws, exactly, and the
    port's ``get_model`` generates them: equal for the integer states
    (daycare, Lotka-Volterra), within the stated tolerance for the rest."""
    import importlib
    from elfi_tpu_torch.models._observed import load_observed_setting
    jm = importlib.import_module(f"elfi_tpu.models.{name}").get_model(**kw)
    tmod = importlib.import_module(f"elfi_tpu_torch.models.{name}")
    setting = {**_DEFAULTS[name], **kw}
    setting["seed_obs"] = setting.get("seed_obs")
    for k in ("time_end", "f", "phi", "total_duration"):
        if k in setting:
            setting[k] = float(setting[k])
    want = np.asarray(jm.observed[node])
    np.testing.assert_array_equal(load_observed_setting(tmod._DATA,
                                                        **setting), want)
    got = tmod.get_model(**kw).observed[node]
    tol = _GENERATED_TOL[name]
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    elif isinstance(tol, tuple):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol[1])
    else:
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_unstored_observed_setting_raises():
    """Settings no file holds, once refused, give the JAX package's data:
    AR(1) at another length (rtol 1e-6 of the series' scale), daycare at
    29 x 53 x 33 under another seed (the states equal)."""
    from elfi_tpu.models import ar1 as jar1
    from elfi_tpu.models import daycare as jdaycare
    want = jar1.get_model(n_obs=150).observed["AR1"]
    got = tar1.get_model(n_obs=150).observed["AR1"]
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(
        tdaycare.get_model(seed_obs=7).observed["DCC"],
        jdaycare.get_model(seed_obs=7).observed["DCC"])


def test_bdm_clusters_equal_jax_for_the_same_seed(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    from elfi_tpu.models import bdm as jbdm
    from elfi_tpu_torch.models import bdm as tbdm
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        exe = tbdm.ensure_executable(str(tmp_path))
        if exe is None:
            pytest.skip("could not compile bdm")
        assert not os.path.exists(os.path.join(tbdm.get_sources_path(),
                                               "bdm"))
        meta = {"model_name": "t", "batch_index": 0, "submission_index": 0}
        args = (np.array([0.2, 0.9, 0.5]), 0, 0.198, 20)
        got = tbdm.BDM(*args, meta=dict(meta),
                       random_state=np.random.RandomState(5))
        want = jbdm.BDM(*args, meta=dict(meta),
                        random_state=np.random.RandomState(5))
        assert got.shape == (3, 20)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(tbdm.T1(got), jbdm.T1(want))
        np.testing.assert_allclose(tbdm.T2(got), jbdm.T2(want))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = tbdm.get_model(seed_obs=2)
            jm = jbdm.get_model(seed_obs=2)
        np.testing.assert_array_equal(m.observed["BDM"], jm.observed["BDM"])
    finally:
        os.chdir(cwd)


def test_zoo_and_host_modules_import_no_jax():
    import subprocess
    import sys
    mods = ["elfi_tpu_torch.model.tools"] + [
        f"elfi_tpu_torch.models.{n}" for n in (
            "ar1", "arch", "mg1", "stochastic_volatility", "lorenz", "toad",
            "lotka_volterra", "daycare", "scratch_assay", "bdm")]
    code = ("import sys; import " + ", ".join(mods) + "; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'elfi_tpu.', 'jaxlib')) or "
            "m == 'elfi_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__)))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
