"""The g-and-k models of the PyTorch port (``models/gnk.py``,
``models/bignk.py``, ``models/gnk_kernel.py``) against the JAX package's,
on the same inputs: the quantile function on the JAX draw, the four
summaries, the distance, the plain version of the g-and-k kernel, and the
committed observed data."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elfi_tpu.models import bignk as jax_bignk
from elfi_tpu.models import gnk as jax_gnk
from elfi_tpu.models import gnk_pallas as jax_gnk_pallas
import elfi_tpu_torch as et
from elfi_tpu_torch.models import bignk, gnk, gnk_kernel
from elfi_tpu_torch.models._observed import load_observed
from elfi_tpu_torch.ops.kernels.gnk import gnk_distance_reference

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


B = 1024


def _params(b, seed=0):
    """(A, B, g, k) drawn from the g-and-k priors, uniform(0, 10)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 10, b).astype(np.float32) for _ in range(4)]


def _graph(m):
    dag = m.dag
    return {"nodes": list(dag.nodes), "order": dag.topological_order(),
            "parents": {n: dag.parents(n) for n in dag.nodes},
            "kinds": {n: dag.get_state(n)["kind"] for n in dag.nodes},
            "parameters": m.parameter_names,
            "observed": m.observed_node_names}


def _jax_draw_and_gnk(A, B_, g, k, key, n_obs, batch_size):
    """The normals GNK draws (elfi_tpu/models/gnk.py:26) and its output."""
    return (jax.random.normal(key, (batch_size, n_obs)),
            jax_gnk.GNK(A, B_, g, k, n_obs=n_obs, batch_size=batch_size,
                        key=key))


def test_gnk_on_the_jax_draw_equals_jax():
    n_obs = 50
    P = _params(B)
    # one compiled program for the draw and GNK, as the JAX package runs
    # GNK inside its per-batch program, rather than some twenty programs of
    # one op each compiled right after the per-module jax.clear_caches()
    z, y_jax = jax.jit(_jax_draw_and_gnk, static_argnums=(5, 6))(
        *map(jnp.asarray, P), jax.random.key(5), n_obs, B)
    z, y_jax = np.asarray(z), np.asarray(y_jax)[..., 0]
    y = gnk.gnk_quantile(torch.tensor(z), *map(torch.tensor, P)).numpy()
    # exp and pow differ by ulps between XLA and PyTorch; where A cancels
    # B(...)z the error is relative to |y - A|, not to |y|
    A = P[0][:, None]
    scale = np.maximum(np.abs(y_jax), np.abs(y_jax - A))
    ratio = np.abs(y - y_jax) / (1e-5 * scale)
    i, j = np.unravel_index(np.argmax(ratio), ratio.shape)
    # the formula in float64, to tell which side is off
    A64, B64, g64, k64 = (float(p[i]) for p in P)
    z64 = float(z[i, j])
    e64 = np.exp(-g64 * z64)
    y64 = A64 + B64 * (1 + 0.8 * (1 - e64) / (1 + e64)) \
        * (1 + z64 ** 2) ** k64 * z64
    assert ratio.max() <= 1, (
        f"worst element {(i, j)}: z={z64!r}, (A, B, g, k)="
        f"{(A64, B64, g64, k64)}, torch={float(y[i, j])!r}, "
        f"jax={float(y_jax[i, j])!r}, float64={y64!r}, "
        f"|diff|/tolerance={float(ratio.max())!r}, "
        f"{int((ratio > 1).sum())} elements over; "
        f"z dtype {z.dtype}, y_jax dtype {y_jax.dtype}, "
        f"torch threads {torch.get_num_threads()}, "
        f"x64 {jax.config.jax_enable_x64}, "
        f"prng {jax.config.jax_default_prng_impl}")


@pytest.mark.parametrize("n_obs", [50, 150])
@pytest.mark.parametrize("summary", ["ss_order", "ss_robust", "ss_octile",
                                     "ss_octile_sq"])
def test_summaries_equal_jax(summary, n_obs):
    rng = np.random.default_rng(n_obs)
    y = rng.normal(size=(64, n_obs, 2)).astype(np.float32)
    y[:, ::7] = y[:, 3:4]          # ties
    y[0] = 1.5                      # a constant row: every percentile ties
    want = np.asarray(getattr(jax_gnk, summary)(jnp.asarray(y)))
    got = getattr(gnk, summary)(torch.tensor(y)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if summary == "ss_order":
        np.testing.assert_array_equal(got, want)
    else:
        # XLA folds q / 100 * (n - 1) into q * (0.01 * (n - 1)) and fuses
        # the interpolation into an FMA: the weights and the sum round
        # differently, by a few float32 ulps of the summary's magnitude
        # (measured: at most 4.2e-7 of the largest |value|)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_percentiles_propagate_nan_as_jax():
    y = np.random.default_rng(0).normal(size=(4, 50, 1)).astype(np.float32)
    y[1, 7] = np.nan
    want = np.asarray(jax_gnk.ss_octile(jnp.asarray(y)))
    got = gnk.ss_octile(torch.tensor(y)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and not np.isnan(got[0]).any()


def test_euclidean_multiss_equals_jax():
    rng = np.random.default_rng(1)
    s1 = rng.normal(size=(B, 7, 2)).astype(np.float32)
    s2 = rng.normal(size=(B, 4)).astype(np.float32)
    o1, o2 = s1[:1] + 0.1, s2[:1] - 0.2
    want = np.asarray(jax_gnk.euclidean_multiss(
        jnp.asarray(s1), jnp.asarray(s2),
        observed=[jnp.asarray(o1), jnp.asarray(o2)]))
    got = gnk.euclidean_multiss(torch.tensor(s1), torch.tensor(s2),
                                observed=[torch.tensor(o1),
                                          torch.tensor(o2)]).numpy()
    # float32 sums over 16 terms taken in another order
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n_obs", [17, 50, 64])
def test_kernel_plain_version_on_the_jax_draw_equals_jax(n_obs):
    """K2's plain version (the kernel's tanh form, float64 sum) against the
    JAX package's XLA path ``euclidean_multiss(ss_order(GNK(...)))`` on the
    same normals."""
    P = _params(B, seed=n_obs)
    key = jax.random.key(n_obs)
    z = np.asarray(jax.random.normal(key, (B, n_obs)))
    y_obs = np.asarray(jax_gnk.GNK(*(jnp.asarray([v], jnp.float32)
                                     for v in (3, 1, 2, .5)), n_obs=n_obs,
                                   batch_size=1, key=jax.random.key(99)))[0]
    obs_sorted = np.sort(y_obs.ravel())
    x = jax_gnk.GNK(*map(jnp.asarray, P), n_obs=n_obs, batch_size=B, key=key)
    want = np.asarray(jax_gnk.euclidean_multiss(
        jax_gnk.ss_order(x), observed=[obs_sorted[None, :, None]]))
    got = gnk_distance_reference(*map(torch.tensor, P),
                                 torch.tensor(obs_sorted), n_obs,
                                 batch_size=B, z=torch.tensor(z)).numpy()
    # measured: the tanh form and the (1 - e)/(1 + e) form, exp(k log1p)
    # and pow, differ by up to ~1e-6 relative per value; the distances by
    # up to ~1e-6 relative (float32 sum in JAX, float64 here)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed_obs", [0, 1, 2, 3])
def test_committed_gnk_observed_data_is_the_jax_draw(seed_obs):
    m_t = gnk.get_model(seed_obs=seed_obs)
    m_j = jax_gnk.get_model(seed_obs=seed_obs)
    y = np.asarray(jax_gnk.GNK(*(jnp.asarray([v], jnp.float32)
                                 for v in (3, 1, 2, .5)), n_obs=50,
                               batch_size=1,
                               key=jax.random.key(seed_obs)))[0]
    np.testing.assert_array_equal(
        load_observed(gnk._DATA, 50, 50, None, gnk.TRUE_PARAMS, seed_obs), y)
    # the generated sample: see test_torch_zoo_observed.py for its tolerance
    np.testing.assert_allclose(m_t.observed["GNK"], m_j.observed["GNK"],
                               rtol=1e-6)
    assert m_t.observed["GNK"].dtype == m_j.observed["GNK"].dtype
    assert _graph(m_t) == _graph(m_j)
    k_t = gnk_kernel.get_model(seed_obs=seed_obs)
    k_j = jax_gnk_pallas.get_model(seed_obs=seed_obs)
    assert _graph(k_t) == _graph(k_j)
    np.testing.assert_allclose(k_t.dag.get_state("d")["op"].obs,
                               k_j.dag.get_state("d")["op"].obs, rtol=1e-6)


@pytest.mark.parametrize("seed_obs", [0, 3])
def test_committed_bignk_observed_data_is_the_jax_draw(seed_obs):
    m_t = bignk.get_model(seed_obs=seed_obs)
    m_j = jax_bignk.get_model(seed_obs=seed_obs)
    np.testing.assert_array_equal(
        load_observed(bignk._DATA, 150, 150, None, bignk.TRUE_PARAMS,
                      seed_obs), m_j.observed["BiGNK"])
    # the generated sample: see test_torch_zoo_observed.py for its tolerance
    np.testing.assert_allclose(m_t.observed["BiGNK"], m_j.observed["BiGNK"],
                               rtol=1e-6)
    assert m_t.observed["BiGNK"].shape == (150, 2)
    assert _graph(m_t) == _graph(m_j)


def test_seed_selects_the_observed_data_as_in_jax():
    np.testing.assert_array_equal(gnk.get_model(seed=2).observed["GNK"],
                                  jax_gnk.get_model(seed=2).observed["GNK"])


@pytest.mark.parametrize("call", [
    ("gnk", dict(seed_obs=4)),
    ("gnk", dict(n_obs=40)),
    ("gnk", dict(true_params=[3, 1, 2, .4])),
    ("gnk_kernel", dict(seed_obs=7)),
    ("bignk", dict(seed_obs=1)),
    ("bignk", dict(n_obs=100))])
def test_unstored_observed_data_raises(call):
    """The settings no file holds, once refused, give the JAX package's
    observed data (rtol 1e-6, as the other linear models)."""
    name, kw = call
    if name == "gnk_kernel":
        got = gnk_kernel.get_model(**kw).dag.get_state("d")["op"].obs
        want = jax_gnk_pallas.get_model(**kw).dag.get_state("d")["op"].obs
    else:
        node = {"gnk": "GNK", "bignk": "BiGNK"}[name]
        port, jax_mod = {"gnk": (gnk, jax_gnk),
                         "bignk": (bignk, jax_bignk)}[name]
        got = port.get_model(**kw).observed[node]
        want = jax_mod.get_model(**kw).observed[node]
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bignk_shapes_and_correlation():
    """BiGNK draws both normal columns from the node's generator: at rho
    = 0.9 and g = k = 0 the two columns are affine in correlated normals."""
    n = 1 << 12
    vals = dict(A1=1., A2=2., B1=1., B2=1., g1=0., g2=0., k1=0., k2=0.,
                rho=0.9)
    args = [torch.full((n,), v) for v in vals.values()]
    y = bignk.BiGNK(*args, n_obs=150, batch_size=n,
                    generator=torch.Generator().manual_seed(0))
    assert y.shape == (n, 150, 2) and y.dtype == torch.float32
    r = np.corrcoef(y[..., 0].reshape(-1), y[..., 1].reshape(-1))[0, 1]
    assert abs(r - 0.9) < 0.01
